"""``dense_ms_per_epoch.coo`` (model step layer, ms): device ms an epoch
launched under train_epoch and under neither nn.aggregate* nor
train.optimizer: GEMMs, batch norm, normalisation, activations, loss,
metrics, in the cells that train on the COO edge list; moves
``train_epochs_per_s.coo``."""

from gnnbench.span_readers import dense_ms_per_epoch as read  # noqa: F401
