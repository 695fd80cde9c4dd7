"""``step_mfu.deepergcn`` (model step layer, %): the DeeperGCN model
operations of the traced job over its wall time against the float32 peak,
in the DeeperGCN training cells; moves ``train_epochs_per_s.coo``."""

from gnnbench.deepergcn_readers import step_mfu as read  # noqa: F401
