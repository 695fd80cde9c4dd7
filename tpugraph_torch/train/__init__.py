"""Training loop, optimizer, metrics and checkpoints (port of
``tpugraph/train``)."""

from tpugraph_torch.train.checkpoint import (  # noqa: F401
    gen_explainer_prefix,
    gen_prefix,
    load_checkpoint,
    save_checkpoint,
)
from tpugraph_torch.train.loop import (  # noqa: F401
    TrainConfig,
    resolve_bcsr_format,
    split_nodes,
    train_graph_classifier,
    train_node_classifier,
)
