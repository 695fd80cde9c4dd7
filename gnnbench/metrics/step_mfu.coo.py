"""``step_mfu.coo`` (model step layer, %): the model operations of the
traced job over its wall time against the float32 peak, in the cells
that train on the COO edge list; moves ``train_epochs_per_s.coo``."""

from gnnbench.readers import step_mfu as read  # noqa: F401
