"""Port of ``tpugraph/nn/layers.py``: ``GraphConv`` on the COO,
block-sparse and packet paths, and ``fresh_batch_norm``.

``y = (A @ x) @ W [+ x @ W_self] + b``, then optional L2 normalization
per node; with ``att``, ``A`` is first scaled by GAT-style scores
``(x W_a)(x W_a)^T`` on its support, and with ``dropout`` the layer
drops entries of ``x`` while training.  The aggregation ``A @ x`` runs
through one of the branches of ``tpugraph/nn/layers.py``:

* ``SparseAdj`` (``:599-610``) — the padded COO edge list, a gather plus
  ``index_add_`` (:func:`tpugraph_torch.ops.message.spmm`); gradients
  flow into ``weight`` (training on COO, and the COO explainer);

and on hand-written kernels:

* static weights, ``BCSRAdj(m, m_t, k_pack=k)`` (``:380-384``) — training
  on tiles, B1 (or B3 when ``k > 1``);
* differentiable weights with caller-supplied transposed tiles,
  ``BCSRAdj(m, m_t, tp)`` (``:372-376``) — the tile-space explainer;
  without ``m_t`` the transposed tiles are rebuilt from ``tp`` in each
  layer's backward (``:377``);
* attention, ``BCSRAdj(m, None, tp)`` (``:353-371``) — scores by B2
  (``sddmm_dw``) and the aggregation over the score-scaled tiles by B1
  (``bcsr_matvec_dw``), forward and backward;
* ``StackedAdj`` (``:401-417``) — training on column-stacked int8/bf16
  tiles, B4;
* ``PacketAdj`` (``:385-400``) — training on edge packets, B7;

and a dense ``[..., N, N]`` tensor (the final branch, ``:609-619``), the
graph classifier's batched adjacency: ``torch.matmul``, as JAX computes
it with ``jnp.matmul`` outside any Pallas kernel, with the attention
scores ``(x W_a)(x W_a)^T`` multiplied in densely.

The kernels take any feature width, so ``D`` is not padded to 128 lanes.
``weight`` is ``[in, out]`` as in the JAX package.  Attention on
``StackedAdj`` or ``PacketAdj`` raises, as in JAX (their static weights
carry no score gradient); the halo adjacencies are not ported and
raise.  Dropout draws its mask from the ``torch.Generator`` passed to
``forward`` (flax's mask stream cannot be replayed).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from tpugraph_torch.nn.initializers import xavier_relu_uniform
from tpugraph_torch.ops.bcsr import BCSR, BCSRTranspose
from tpugraph_torch.ops.bcsr_kernels import (bcsr_matvec, bcsr_matvec_dw,
                                             bcsr_matvec_dw_pair, sddmm_dw)
from tpugraph_torch.ops.dense import dense_spmm
from tpugraph_torch.ops.message import sddmm, spmm
from tpugraph_torch.ops.packets import EdgePackets
from tpugraph_torch.ops.packets_kernels import packets_matvec
from tpugraph_torch.ops.resident_kernels import BCSRStacked, stacked_matvec


class SparseAdj(NamedTuple):
    """Padded COO adjacency of one graph (``tpugraph/nn/layers.py:35``):
    edge ``e`` carries ``weight[e]`` from ``senders[e]`` to
    ``receivers[e]``; ``weight`` is 0 on padding edges.  All three on the
    device of ``x``."""

    senders: torch.Tensor    # int32/int64[E_pad]
    receivers: torch.Tensor  # int32/int64[E_pad]
    weight: torch.Tensor     # float32[E_pad]


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


Adjacency = Union[SparseAdj, BCSRAdj, StackedAdj, PacketAdj, torch.Tensor]


def normalize_embedding(y: torch.Tensor) -> torch.Tensor:
    """``y * rsqrt(sum(y^2) + 1e-24)`` per row: the reference's
    ``F.normalize`` with a gradient that stays finite on all-zero (padded)
    rows (``tpugraph/nn/layers.py:626-632``)."""
    return y * torch.rsqrt(torch.sum(y * y, dim=-1, keepdim=True) + 1e-24)


def fresh_batch_norm(x: torch.Tensor, node_axis: int = -2,
                     eps: float = 1e-5) -> torch.Tensor:
    """Stateless batch norm per node position over every other axis (the
    features of ``x [N, F]``), with biased variance and no affine terms
    (``tpugraph/nn/layers.py:636``)."""
    dims = tuple(i for i in range(x.dim()) if i != node_axis % x.dim())
    mean = torch.mean(x, dim=dims, keepdim=True)
    var = torch.var(x, dim=dims, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


def apply_dropout(x: torch.Tensor, rate: float,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``Dropout``: keep each entry with probability ``1 - rate``
    and scale it by ``1 / (1 - rate)``, the mask drawn from ``generator``
    (on ``x``'s device; ``None``: torch's global generator)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class GraphConv(nn.Module):
    """One graph convolution; ``forward`` returns ``(y, adj_att)`` like the
    reference layer: ``adj_att`` is the adjacency with the attention
    scores applied when ``att``, else ``adj``.  Parameters are drawn in
    ``tpugraph``'s order: ``weight``, ``self_weight``, ``att_weight``
    (``[in, in]``), then the zero ``bias``."""

    def __init__(self, input_dim: int, output_dim: int,
                 add_self: bool = False, normalize_embedding: bool = False,
                 dropout: float = 0.0, use_bias: bool = True,
                 att: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.add_self = add_self
        self.normalize_embedding = normalize_embedding
        self.dropout = dropout
        self.att = att
        self.weight = nn.Parameter(
            xavier_relu_uniform((input_dim, output_dim), generator))
        self.self_weight = (nn.Parameter(xavier_relu_uniform(
            (input_dim, output_dim), generator)) if add_self else None)
        self.att_weight = (nn.Parameter(xavier_relu_uniform(
            (input_dim, input_dim), generator)) if att else None)
        self.bias = (nn.Parameter(torch.zeros(output_dim)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor, adj: Adjacency,
                dropout_gen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Adjacency]:
        if self.training and self.dropout > 0.001:
            x = apply_dropout(x, self.dropout, dropout_gen)
        adj_att = adj
        if isinstance(adj, torch.Tensor):
            if self.att:
                x_att = torch.matmul(x, self.att_weight)
                adj_att = adj * torch.matmul(x_att, x_att.transpose(-1, -2))
            y = dense_spmm(adj_att, x)
        elif isinstance(adj, SparseAdj):
            weight = adj.weight
            if self.att:
                x_att = torch.matmul(x, self.att_weight)
                weight = weight * sddmm(adj.senders, adj.receivers, x_att, x_att)
                adj_att = SparseAdj(adj.senders, adj.receivers, weight)
            y = spmm(adj.senders, adj.receivers, weight, x)
        elif isinstance(adj, (PacketAdj, StackedAdj)) and self.att:
            raise NotImplementedError(
                "GAT attention needs tile or edge score gradients: use "
                "SparseAdj or BCSRAdj with a transpose plan")
        elif isinstance(adj, PacketAdj):
            ns, n = x.shape[0], adj.p.num_nodes
            x_p = x if ns == n else nn.functional.pad(x, (0, 0, 0, n - ns))
            y = packets_matvec(adj.p, adj.p_t, x_p, adj.compute_dtype)[:ns]
        elif isinstance(adj, StackedAdj):
            y = stacked_matvec(adj.st, adj.st_t, x)
        elif not isinstance(adj, BCSRAdj):
            raise NotImplementedError(
                f"{type(adj).__name__} is not ported yet")
        elif self.att:
            y, adj_att = self._attend_bcsr(x, adj)
        elif adj.tp is not None and adj.m_t is not None:
            y = bcsr_matvec_dw_pair(adj.m, adj.m_t, x, adj.spmm_dtype)
        elif adj.tp is not None:
            y = bcsr_matvec_dw(self._run_tiles(adj), adj.tp, x)
        elif adj.m_t is None:
            raise ValueError("BCSRAdj needs m_t (static weights) or tp "
                             "(differentiable weights)")
        else:
            y = bcsr_matvec(adj.m, adj.m_t, x, k_pack=adj.k_pack)
        y = torch.matmul(y, self.weight)
        if self.add_self:
            y = y + torch.matmul(x, self.self_weight)
        if self.bias is not None:
            y = y + self.bias
        if self.normalize_embedding:
            y = normalize_embedding(y)
        return y, adj_att

    @staticmethod
    def _run_tiles(adj: BCSRAdj) -> BCSR:
        """``adj.m`` with its tiles at ``adj.spmm_dtype`` (the dtype the
        kernels read them at), differentiably."""
        if adj.spmm_dtype is None:
            return adj.m
        return dataclasses.replace(adj.m, tiles=adj.m.tiles.to(adj.spmm_dtype))

    def _attend_bcsr(self, x: torch.Tensor, adj: BCSRAdj
                     ) -> Tuple[torch.Tensor, BCSRAdj]:
        """GAT on tiles (``tpugraph/nn/layers.py:353-371``): scores by B2 on
        the tile support, the tiles scaled by them, and B1 over the scaled
        tiles.  The returned adjacency has no ``m_t``, so nothing can run
        the unscaled transposed tiles against it."""
        if adj.tp is None:
            raise NotImplementedError(
                "GAT attention on the BCSR path needs a transpose plan: "
                "BCSRAdj(m, tp=bcsr_transpose_plan(m))")
        m = self._run_tiles(adj)
        x_att = torch.matmul(x, self.att_weight)
        scores = sddmm_dw(m, adj.tp, x_att, x_att)
        eff = dataclasses.replace(m, tiles=m.tiles * scores)
        return (bcsr_matvec_dw(eff, adj.tp, x),
                BCSRAdj(eff, None, adj.tp))
