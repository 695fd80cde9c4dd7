"""Training loop, optimizer, metrics and checkpoints (port of
``tpugraph/train``)."""

from tpugraph_torch.train.checkpoint import (  # noqa: F401
    gen_prefix,
    load_checkpoint,
    save_checkpoint,
)
from tpugraph_torch.train.loop import (  # noqa: F401
    TrainConfig,
    split_nodes,
    train_node_classifier,
)
