"""``loop_idle_share.bcsr`` (device layer, %): 1 - busy / window over the
device window of the operations launched under train_epoch, first to
last, in the cells that train on ``--bcsr`` (jobs that pack a block-
sparse adjacency); moves ``train_epochs_per_s.bcsr``."""

from gnnbench.span_readers import loop_idle_share as read  # noqa: F401
