"""``product_ms_per_epoch.bcsr`` (kernels layer, ms): device ms an epoch
launched under nn.aggregate and nn.aggregate.backward within
train_epoch, in the cells that train on ``--bcsr`` (jobs that pack a
block-sparse adjacency); moves ``train_epochs_per_s.bcsr``."""

from gnnbench.span_readers import product_ms_per_epoch as read  # noqa: F401
