"""``optimizer_ms_per_epoch.coo`` (model step layer, ms): device ms an
epoch launched under train.optimizer: the clip, the decay and Adam, in
the cells that train on the COO edge list; moves
``train_epochs_per_s.coo``."""

from gnnbench.span_readers import optimizer_ms_per_epoch as read  # noqa: F401
