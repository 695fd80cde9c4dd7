"""``dense_ms_per_epoch.gat`` (model step layer, ms): device ms an epoch
launched under train_epoch and under neither nn.attention* nor
train.optimizer: GEMMs, batch norm, activations, residual adds, loss and
metrics, in the GAT training cells; moves ``train_epochs_per_s.coo``."""

from gnnbench.gat_readers import dense_ms_per_epoch as read  # noqa: F401
