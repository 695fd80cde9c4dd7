"""``device_idle_share.coo`` (device layer, %): the share of the traced job
in which no operation ran on the device, in the cells that train on the
COO edge list; moves ``train_epochs_per_s.coo``."""

from gnnbench.readers import idle_share as read  # noqa: F401
