"""``dense_ms_per_epoch.bcsr`` (model step layer, ms): device ms an epoch
launched under train_epoch and under neither nn.aggregate* nor
train.optimizer: GEMMs, batch norm, normalisation, activations, loss,
metrics, in the cells that train on ``--bcsr`` (jobs that pack a block-
sparse adjacency); moves ``train_epochs_per_s.bcsr``."""

from gnnbench.span_readers import dense_ms_per_epoch as read  # noqa: F401
