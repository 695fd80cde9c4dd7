"""Port of ``tpugraph/nn/layers.py``: ``GraphConv`` on the BCSR path.

``y = (A @ x) @ W + b``, then optional L2 normalization per node.  The
aggregation ``A @ x`` runs on the hand-written kernels of
:mod:`tpugraph_torch.ops.bcsr_kernels` through one of two ``BCSRAdj``
branches of ``tpugraph/nn/layers.py``:

* static weights, ``BCSRAdj(m, m_t)`` (``:380-384``) — training;
* differentiable weights with caller-supplied transposed tiles,
  ``BCSRAdj(m, m_t, tp)`` (``:372-376``) — the tile-space explainer.

``weight`` is ``[in, out]`` as in the JAX package.  Attention, dropout,
``add_self`` and the other adjacency types are not ported and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from tpugraph_torch.nn.initializers import xavier_relu_uniform
from tpugraph_torch.ops.bcsr import BCSR, BCSRTranspose
from tpugraph_torch.ops.bcsr_kernels import bcsr_matvec, bcsr_matvec_dw_pair


@dataclasses.dataclass
class BCSRAdj:
    """Block-sparse adjacency (``tpugraph/nn/layers.py:48``): ``m`` and the
    BCSR of its transpose ``m_t`` on the same device; ``tp`` (a transpose
    plan) marks the differentiable-weights path, where gradients flow
    into ``m.tiles``."""

    m: BCSR
    m_t: Optional[BCSR] = None
    tp: Optional[BCSRTranspose] = None


def normalize_embedding(y: torch.Tensor) -> torch.Tensor:
    """``y * rsqrt(sum(y^2) + 1e-24)`` per row: the reference's
    ``F.normalize`` with a gradient that stays finite on all-zero (padded)
    rows (``tpugraph/nn/layers.py:626-632``)."""
    return y * torch.rsqrt(torch.sum(y * y, dim=-1, keepdim=True) + 1e-24)


class GraphConv(nn.Module):
    """One graph convolution; ``forward`` returns ``(y, adj)`` like the
    reference layer."""

    def __init__(self, input_dim: int, output_dim: int,
                 add_self: bool = False, normalize_embedding: bool = False,
                 dropout: float = 0.0, use_bias: bool = True,
                 att: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if att:
            raise NotImplementedError("GAT attention is not ported yet")
        if add_self or dropout > 0.001:
            raise NotImplementedError("add_self and dropout are not ported yet")
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.normalize_embedding = normalize_embedding
        self.weight = nn.Parameter(
            xavier_relu_uniform((input_dim, output_dim), generator))
        self.bias = (nn.Parameter(torch.zeros(output_dim)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor, adj: BCSRAdj
                ) -> Tuple[torch.Tensor, BCSRAdj]:
        if not isinstance(adj, BCSRAdj):
            raise NotImplementedError(
                f"only BCSRAdj is ported, got {type(adj).__name__}")
        if adj.m_t is None:
            raise NotImplementedError(
                "BCSRAdj needs m_t (the transposed tiles); the per-layer "
                "transpose path (bcsr_matvec_dw) is not ported yet")
        if adj.tp is not None:
            y = bcsr_matvec_dw_pair(adj.m, adj.m_t, x)
        else:
            y = bcsr_matvec(adj.m, adj.m_t, x)
        y = torch.matmul(y, self.weight)
        if self.bias is not None:
            y = y + self.bias
        if self.normalize_embedding:
            y = normalize_embedding(y)
        return y, adj
