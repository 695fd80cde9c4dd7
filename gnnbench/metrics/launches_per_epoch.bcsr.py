"""``launches_per_epoch.bcsr`` (device layer, launches/epoch): device
operations launched under train_epoch and its children, an epoch, in the
cells that train on ``--bcsr`` (jobs that pack a block-sparse
adjacency); moves ``train_epochs_per_s.bcsr``."""

from gnnbench.span_readers import launches_per_epoch as read  # noqa: F401
