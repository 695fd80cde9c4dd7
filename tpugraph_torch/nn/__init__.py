"""Model layers, encoders and losses (port of ``tpugraph/nn``)."""

from tpugraph_torch.nn.encoders import (  # noqa: F401
    ConvStack,
    GcnEncoderNode,
    PredHead,
    params_from_jax,
)
from tpugraph_torch.nn.layers import BCSRAdj, GraphConv  # noqa: F401
from tpugraph_torch.nn.losses import node_cross_entropy, softmax_cross_entropy  # noqa: F401
