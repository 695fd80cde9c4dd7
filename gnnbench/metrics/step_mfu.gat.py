"""``step_mfu.gat`` (model step layer, %): the GAT model operations of the
traced job over its wall time against the float32 peak, in the GAT
training cells; moves ``train_epochs_per_s.coo``."""

from gnnbench.gat_readers import step_mfu as read  # noqa: F401
