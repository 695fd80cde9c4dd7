"""``loop_idle_share.coo`` (device layer, %): 1 - busy / window over the
device window of the operations launched under train_epoch, first to
last, in the cells that train on the COO edge list; moves
``train_epochs_per_s.coo``."""

from gnnbench.span_readers import loop_idle_share as read  # noqa: F401
