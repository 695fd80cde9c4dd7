"""``launches_per_epoch.coo`` (device layer, launches/epoch): device
operations launched under train_epoch and its children, an epoch, in the
cells that train on the COO edge list; moves ``train_epochs_per_s.coo``."""

from gnnbench.span_readers import launches_per_epoch as read  # noqa: F401
