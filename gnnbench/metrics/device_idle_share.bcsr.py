"""``device_idle_share.bcsr`` (device layer, %): the share of the traced
job in which no operation ran on the device, in the cells that train on
``--bcsr`` (jobs that pack a block-sparse adjacency); moves
``train_epochs_per_s.bcsr``."""

from gnnbench.readers import idle_share as read  # noqa: F401
