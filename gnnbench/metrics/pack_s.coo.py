"""``pack_s.coo`` (host prep layer, s): the traced job's own packing and
upload time, in the cells that train on the COO edge list; moves
``train_epochs_per_s.coo``."""

from gnnbench.readers import pack_s as read  # noqa: F401
