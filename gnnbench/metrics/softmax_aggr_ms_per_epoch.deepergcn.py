"""``softmax_aggr_ms_per_epoch.deepergcn`` (kernels layer, ms): device ms an
epoch launched under nn.softmax_aggr and nn.softmax_aggr.backward within
train_epoch, in the DeeperGCN training cells; moves
``train_epochs_per_s.coo``."""

from gnnbench.deepergcn_readers import softmax_aggr_ms_per_epoch as read  # noqa: F401
