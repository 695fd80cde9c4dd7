"""``attention_roofline.gat`` (kernels layer, %): the attention forwards'
least time over the device time launched under nn.attention, in the GAT
training cells; moves ``train_epochs_per_s.coo``."""

from gnnbench.gat_readers import attention_roofline as read  # noqa: F401
