"""``attention_backward_roofline.gat`` (kernels layer, %): the attention
backwards' least time over the device time launched under
nn.attention.backward, in the GAT training cells; moves
``train_epochs_per_s.coo``."""

from gnnbench.gat_readers import attention_backward_roofline as read  # noqa: F401
