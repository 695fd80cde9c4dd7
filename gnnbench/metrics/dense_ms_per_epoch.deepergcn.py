"""``dense_ms_per_epoch.deepergcn`` (model step layer, ms): device ms an
epoch launched under train_epoch and under neither nn.softmax_aggr* nor
train.optimizer: the linears, batch norm, activations, residual adds, loss
and metrics, in the DeeperGCN training cells; moves
``train_epochs_per_s.coo``."""

from gnnbench.deepergcn_readers import dense_ms_per_epoch as read  # noqa: F401
