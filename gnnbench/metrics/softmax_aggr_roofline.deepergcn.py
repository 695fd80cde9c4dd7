"""``softmax_aggr_roofline.deepergcn`` (kernels layer, %): the softmax
aggregation forwards' least time over the device time launched under
nn.softmax_aggr, in the DeeperGCN training cells; moves
``train_epochs_per_s.coo``."""

from gnnbench.deepergcn_readers import softmax_aggr_roofline as read  # noqa: F401
