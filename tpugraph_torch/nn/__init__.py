"""Model layers, encoders and losses (port of ``tpugraph/nn``)."""

from tpugraph_torch.nn.encoders import (  # noqa: F401
    ConvStack,
    GcnEncoderGraph,
    GcnEncoderNode,
    PredHead,
    SoftPoolingGcnEncoder,
    params_from_jax,
)
from tpugraph_torch.nn.layers import (  # noqa: F401
    BCSRAdj,
    GraphConv,
    PacketAdj,
    SparseAdj,
    StackedAdj,
)
from tpugraph_torch.nn.losses import (  # noqa: F401
    link_prediction_loss,
    margin_loss,
    node_cross_entropy,
    softmax_cross_entropy,
)
