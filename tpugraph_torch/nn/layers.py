"""Port of ``tpugraph/nn/layers.py``: ``GraphConv`` on the block-sparse
and packet paths.

``y = (A @ x) @ W + b``, then optional L2 normalization per node.  The
aggregation ``A @ x`` runs on hand-written kernels through one of the
branches of ``tpugraph/nn/layers.py``:

* static weights, ``BCSRAdj(m, m_t, k_pack=k)`` (``:380-384``) — training
  on tiles, B1 (or B3 when ``k > 1``);
* differentiable weights with caller-supplied transposed tiles,
  ``BCSRAdj(m, m_t, tp)`` (``:372-376``) — the tile-space explainer;
* ``StackedAdj`` (``:401-417``) — training on column-stacked int8/bf16
  tiles, B4;
* ``PacketAdj`` (``:385-400``) — training on edge packets, B7.

The kernels take any feature width, so ``D`` is not padded to 128 lanes.
``weight`` is ``[in, out]`` as in the JAX package.  Attention, dropout,
``add_self`` and the COO/dense/halo adjacencies are not ported and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
from torch import nn

from tpugraph_torch.nn.initializers import xavier_relu_uniform
from tpugraph_torch.ops.bcsr import BCSR, BCSRTranspose
from tpugraph_torch.ops.bcsr_kernels import bcsr_matvec, bcsr_matvec_dw_pair
from tpugraph_torch.ops.packets import EdgePackets
from tpugraph_torch.ops.packets_kernels import packets_matvec
from tpugraph_torch.ops.resident_kernels import BCSRStacked, stacked_matvec


@dataclasses.dataclass
class BCSRAdj:
    """Block-sparse adjacency (``tpugraph/nn/layers.py:48``): ``m`` and the
    BCSR of its transpose ``m_t`` on the same device; ``tp`` (a transpose
    plan) marks the differentiable-weights path, where gradients flow
    into ``m.tiles``.  ``k_pack > 1`` routes the static-weight product
    through the packed kernel; ``m``/``m_t`` must be padded to it.
    ``spmm_dtype`` is the dtype the differentiable path's kernels read
    ``m.tiles`` at (the explainer's ``spmm_dtype``; ``tpugraph`` casts the
    tiles themselves, which would round their gradient here)."""

    m: BCSR
    m_t: Optional[BCSR] = None
    tp: Optional[BCSRTranspose] = None
    k_pack: int = 0
    spmm_dtype: Optional[torch.dtype] = None


@dataclasses.dataclass
class StackedAdj:
    """Column-stacked adjacency (``tpugraph/nn/layers.py:210``): the
    stacks of ``A`` and of ``A^T`` (backward ``dx``), on one device.
    Static weights only."""

    st: BCSRStacked
    st_t: BCSRStacked


@dataclasses.dataclass
class PacketAdj:
    """Edge-packet adjacency (``tpugraph/nn/layers.py:234``): packets of
    ``A`` and of ``A^T``, on one device.  ``compute_dtype`` is B7's
    (``None``: bf16 on a CUDA device, f32 on the CPU).  Static weights
    only."""

    p: EdgePackets
    p_t: EdgePackets
    compute_dtype: Optional[torch.dtype] = None


Adjacency = Union[BCSRAdj, StackedAdj, PacketAdj]


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

    def forward(self, x: torch.Tensor, adj: Adjacency
                ) -> Tuple[torch.Tensor, Adjacency]:
        if isinstance(adj, PacketAdj):
            ns, n = x.shape[0], adj.p.num_nodes
            x_p = x if ns == n else nn.functional.pad(x, (0, 0, 0, n - ns))
            y = packets_matvec(adj.p, adj.p_t, x_p, adj.compute_dtype)[:ns]
        elif isinstance(adj, StackedAdj):
            y = stacked_matvec(adj.st, adj.st_t, x)
        elif not isinstance(adj, BCSRAdj):
            raise NotImplementedError(
                f"{type(adj).__name__} is not ported yet")
        elif adj.m_t is None:
            raise NotImplementedError(
                "BCSRAdj needs m_t (the transposed tiles); the per-layer "
                "transpose path (bcsr_matvec_dw) is not ported yet")
        elif adj.tp is not None:
            y = bcsr_matvec_dw_pair(adj.m, adj.m_t, x, adj.spmm_dtype)
        else:
            y = bcsr_matvec(adj.m, adj.m_t, x, k_pack=adj.k_pack)
        y = torch.matmul(y, self.weight)
        if self.bias is not None:
            y = y + self.bias
        if self.normalize_embedding:
            y = normalize_embedding(y)
        return y, adj
