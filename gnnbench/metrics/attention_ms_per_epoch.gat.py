"""``attention_ms_per_epoch.gat`` (kernels layer, ms): device ms an epoch
launched under nn.attention and nn.attention.backward within train_epoch,
in the GAT training cells; moves ``train_epochs_per_s.coo``."""

from gnnbench.gat_readers import attention_ms_per_epoch as read  # noqa: F401
