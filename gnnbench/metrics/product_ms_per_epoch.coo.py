"""``product_ms_per_epoch.coo`` (kernels layer, ms): device ms an epoch
launched under nn.aggregate and nn.aggregate.backward within
train_epoch, in the cells that train on the COO edge list; moves
``train_epochs_per_s.coo``."""

from gnnbench.span_readers import product_ms_per_epoch as read  # noqa: F401
