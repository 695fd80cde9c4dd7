"""``pack_s.bcsr`` (host prep layer, s): the traced job's own packing and
upload time, in the cells that train on ``--bcsr`` (jobs that pack a
block-sparse adjacency); moves ``train_epochs_per_s.bcsr``."""

from gnnbench.readers import pack_s as read  # noqa: F401
