"""``aggregate_roofline.bcsr`` (kernels layer, %): the adjacency products'
least time over the device time of the kernels that ran them, in the
traced job of the cells that train on ``--bcsr`` (jobs that pack a
block-sparse adjacency); moves ``train_epochs_per_s.bcsr``."""

from gnnbench.readers import aggregate_roofline as read  # noqa: F401
