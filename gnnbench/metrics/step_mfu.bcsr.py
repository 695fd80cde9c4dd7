"""``step_mfu.bcsr`` (model step layer, %): the model operations of the
traced job over its wall time against the float32 peak, in the cells
that train on ``--bcsr`` (jobs that pack a block-sparse adjacency);
moves ``train_epochs_per_s.bcsr``."""

from gnnbench.readers import step_mfu as read  # noqa: F401
