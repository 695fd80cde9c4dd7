"""Port of ``tpugraph/nn/layers.py``: ``GraphConv`` on the COO,
block-sparse and packet paths, and ``fresh_batch_norm``; and the port's
own :class:`GATConv`, multi-head graph attention (Velickovic et al.,
arXiv:1710.10903), and :class:`GENConv`, DeeperGCN's softmax-aggregation
convolution (Li et al., arXiv:2006.07739), on the COO edge list's CSR.

``y = (A @ x) @ W [+ x @ W_self] + b``, then optional L2 normalization
per node; with ``att``, ``A`` is first scaled by GAT-style scores
``(x W_a)(x W_a)^T`` on its support, and with ``dropout`` the layer
drops entries of ``x`` while training.  The aggregation ``A @ x`` runs
through one of the branches of ``tpugraph/nn/layers.py``:

* ``SparseAdj`` (``:599-610``) — the padded COO edge list, a gather plus
  ``index_add_`` (:func:`tpugraph_torch.ops.message.spmm`); gradients
  flow into ``weight`` (training on COO on the CPU, the COO explainer,
  attention);

and on hand-written kernels:

* ``SparseAdj`` with its ``csr`` set — training on COO on the card: the
  CSR kernel (:func:`tpugraph_torch.ops.coo_kernels.csr_matvec`), ``dx``
  by the same kernel on ``A^T``, ``dw`` by the gather path's ``sddmm``;
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

On a node-partitioned graph, each rank of a process group holds a shard
of the nodes, ``x [Ns, D]``, and the edges into them; the layer first
exchanges the boundary rows its peers need (:func:`halo_exchange`) and
then aggregates over ``[local | halo]`` rows
(``tpugraph/nn/layers.py:418-598``):

* ``HaloAdj`` — the shard's COO edges, gather plus ``index_add_``;
* ``HaloOverlapAdj`` — the same edges split into local-local and
  halo-dependent sets: the exchange is issued asynchronously, the local
  edges aggregate while it is in flight, and the halo term is added after
  it lands (same sums, same numbers);
* ``HaloBCSRAdj`` — the shard's rectangular BCSR over ``[local | halo]``
  columns (padded with dead tiles to the largest shard's count), B1
  forward and backward; attention by B2 over its transpose plan;
* ``HaloBCSROverlapAdj`` — the split as two BCSRs: the square local one
  runs B1 while the exchange is in flight, the halo one after.

``EdgeShardAdj`` is the edge-partitioned graph of
``tpugraph/parallel/spmd.py:1110``: every rank holds all nodes and a
slice of the edges, and the partial sums are added over the ranks.

The kernels take any feature width, so ``D`` is not padded to 128 lanes.
``weight`` is ``[in, out]`` as in the JAX package.  Attention on
``StackedAdj`` or ``PacketAdj`` raises, as in JAX (their static weights
carry no score gradient).  Dropout draws its mask from the
``torch.Generator`` passed to ``forward`` (flax's mask stream cannot be
replayed); under :func:`batch_shard` (data parallelism) it draws the
whole batch's mask and keeps this rank's rows, and
:func:`fresh_batch_norm` takes the whole batch's statistics.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Iterator, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from tpugraph_torch.nn.initializers import (torch_linear_bias, torch_linear_kernel,
                                            xavier_relu_normal, xavier_relu_uniform)
from tpugraph_torch.ops.bcsr import BCSR, BCSRTranspose
from tpugraph_torch.ops.bcsr_kernels import (bcsr_matvec, bcsr_matvec_dw,
                                             bcsr_matvec_dw_pair, sddmm_dw)
from tpugraph_torch.ops.coo_kernels import EdgeCSR, csr_matvec, gat_attention
from tpugraph_torch.ops.dense import dense_spmm
from tpugraph_torch.ops.gen_kernels import softmax_aggr
from tpugraph_torch.ops.message import sddmm, spmm
from tpugraph_torch.ops.packets import EdgePackets
from tpugraph_torch.ops.packets_kernels import packets_matvec
from tpugraph_torch.ops.resident_kernels import BCSRStacked, stacked_matvec
from tpugraph_torch.parallel.collectives import (all_to_all, copy_to_shards,
                                                 psum, reduce_from_shards,
                                                 start_all_to_all)
from tpugraph_torch.parallel.mesh import Mesh
from tpugraph_torch.utils.profiling import trace_annotation, trace_backward


class SparseAdj(NamedTuple):
    """Padded COO adjacency of one graph (``tpugraph/nn/layers.py:35``):
    edge ``e`` carries ``weight[e]`` from ``senders[e]`` to
    ``receivers[e]``; ``weight`` is 0 on padding edges.  All on the
    device of ``x``.  ``csr``, where set, is the edge list's CSR
    (:func:`~tpugraph_torch.ops.coo_kernels.edge_csr`), and the product
    runs the CSR kernel; without it, the gather and ``index_add_``."""

    senders: torch.Tensor    # int32/int64[E_pad]
    receivers: torch.Tensor  # int32/int64[E_pad]
    weight: torch.Tensor     # float32[E_pad]
    csr: Optional[EdgeCSR] = None


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


@dataclasses.dataclass
class HaloAdj:
    """This rank's node shard of a node-partitioned graph
    (``tpugraph/nn/layers.py:83``): ``send_idx [n_dev, H]`` its rows each
    peer needs, and its edges as ``sender_slot`` (a row of ``[local |
    halo]``), ``receivers_local`` and ``weight`` (0 on padding), on the
    rank's device; ``mesh`` the group the halo is exchanged over."""

    send_idx: torch.Tensor
    sender_slot: torch.Tensor
    receivers_local: torch.Tensor
    weight: torch.Tensor
    mesh: Mesh


@dataclasses.dataclass
class HaloBCSRAdj:
    """This rank's shard with its edges as a rectangular BCSR ``m`` over
    ``[local | halo]`` columns, ``m_t`` its transpose (backward ``dx``),
    and ``tp`` the transpose plan of ``m`` for attention
    (``tpugraph/nn/layers.py:112``)."""

    send_idx: torch.Tensor
    m: BCSR
    m_t: Optional[BCSR]
    tp: Optional[BCSRTranspose] = None
    mesh: Optional[Mesh] = None


@dataclasses.dataclass
class HaloOverlapAdj:
    """:class:`HaloAdj` with the edges split into the local-local set
    (``s_loc``, ``r_loc``, ``w_loc``) and the halo-dependent set
    (``h_slot`` a row of the received halo, ``r_halo``, ``w_halo``), so the
    local aggregation runs while the exchange is in flight
    (``tpugraph/nn/layers.py:147``)."""

    send_idx: torch.Tensor
    s_loc: torch.Tensor
    r_loc: torch.Tensor
    w_loc: torch.Tensor
    h_slot: torch.Tensor
    r_halo: torch.Tensor
    w_halo: torch.Tensor
    mesh: Mesh


@dataclasses.dataclass
class HaloBCSROverlapAdj:
    """The split as BCSRs: ``m_loc`` square over the shard's columns,
    ``m_halo`` rectangular over the received halo, their transposes and,
    for attention, their transpose plans
    (``tpugraph/nn/layers.py:181``)."""

    send_idx: torch.Tensor
    m_loc: BCSR
    m_loc_t: Optional[BCSR]
    m_halo: BCSR
    m_halo_t: Optional[BCSR]
    tp_loc: Optional[BCSRTranspose] = None
    tp_halo: Optional[BCSRTranspose] = None
    mesh: Optional[Mesh] = None


@dataclasses.dataclass
class EdgeShardAdj:
    """This rank's slice of an edge-partitioned COO graph: every rank holds
    all nodes and aggregates its edges, and the partial sums are added
    over the ranks, the sum's gradient kept whole on each rank
    (``tpugraph/parallel/spmd.py:62, 1110``)."""

    senders: torch.Tensor
    receivers: torch.Tensor
    weight: torch.Tensor
    mesh: Mesh


Adjacency = Union[SparseAdj, BCSRAdj, StackedAdj, PacketAdj, HaloAdj,
                  HaloBCSRAdj, HaloOverlapAdj, HaloBCSROverlapAdj,
                  EdgeShardAdj, torch.Tensor]


@dataclasses.dataclass
class BatchShard:
    """This rank's share of a data-parallel batch: rows ``rank * b`` to
    ``(rank + 1) * b`` of the whole batch, over ``world`` ranks of
    ``group``."""

    group: object
    rank: int
    world: int


_BATCH_SHARD: contextvars.ContextVar = contextvars.ContextVar(
    "tpugraph_torch_batch_shard", default=None)


@contextlib.contextmanager
def batch_shard(shard: BatchShard) -> Iterator[None]:
    """Within the block, :func:`fresh_batch_norm` and :func:`apply_dropout`
    act on the whole batch whose rows ``shard`` holds: the statistics are
    summed over the ranks, and each rank draws the whole batch's dropout
    mask and keeps its rows, so data parallelism computes what one device
    computes on the whole batch."""
    token = _BATCH_SHARD.set(shard)
    try:
        yield
    finally:
        _BATCH_SHARD.reset(token)


def halo_exchange(x: torch.Tensor, send_idx: torch.Tensor,
                  mesh: Mesh) -> torch.Tensor:
    """The boundary exchange of the halo paths
    (``tpugraph/nn/layers.py:258``): gather the rows each peer needs,
    ``x[send_idx]`` ``[n_dev, H, D]``, and exchange them; returns ``[n_dev,
    H, D]``, block ``q`` the rows received from rank ``q``.  On a 1-D mesh
    it is one ``all_to_all``; on a 2-D ``(outer, inner)`` mesh it is
    hierarchical: an exchange within the inner group routes every block to
    the rank of its destination's inner index, then one within the outer
    group delivers it, so each row crosses each network once and the
    result's layout is the flat exchange's.  Differentiable: the gradient
    is the reverse exchange."""
    return start_halo_exchange(x, send_idx, mesh, wait=True)


def start_halo_exchange(x: torch.Tensor, send_idx: torch.Tensor, mesh: Mesh,
                        wait: bool = False):
    """:func:`halo_exchange`, issued without waiting (``wait=False``): a
    :class:`~tpugraph_torch.parallel.collectives.PendingExchange` whose
    ``wait`` gives ``[n_dev, H, D]``.  On a
    2-D mesh the inner stage completes first and the outer one is in
    flight."""
    send = x[send_idx]  # [n_dev, H, D]
    if not mesh.hierarchical:
        if wait:
            return all_to_all(send, mesh.group)
        return start_all_to_all(send, mesh.group)
    no, ni = mesh.shape
    n_dev, h, d = send.shape
    sb = send.reshape(no, ni, h, d).transpose(0, 1)  # [ni, no, H, D]
    # stage 1 (inner): block c to the inner peer c; after it, [a, c] is
    # inner peer c's block for (outer a, my inner index)
    sb = all_to_all(sb, mesh.inner).transpose(0, 1)  # [no, ni, H, D]
    # stage 2 (outer): [e, c] becomes the block from flat rank e * ni + c
    finish = lambda t: t.reshape(n_dev, h, d)
    if wait:
        return finish(all_to_all(sb, mesh.outer))
    return start_all_to_all(sb, mesh.outer, finish)


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
    shard = _BATCH_SHARD.get()
    if shard is None or x.dim() < 3:
        mean = torch.mean(x, dim=dims, keepdim=True)
        var = torch.var(x, dim=dims, keepdim=True, correction=0)
        return (x - mean) * torch.rsqrt(var + eps)
    # the whole batch's statistics: sums over the ranks, two passes as
    # jnp.var takes them
    count = shard.world
    for i in dims:
        count *= x.shape[i]
    mean = psum(torch.sum(x, dim=dims, keepdim=True), shard.group) / count
    var = psum(torch.sum((x - mean) ** 2, dim=dims, keepdim=True),
               shard.group) / count
    return (x - mean) * torch.rsqrt(var + eps)


def apply_dropout(x: torch.Tensor, rate: float,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``Dropout``: keep each entry with probability ``1 - rate``
    and scale it by ``1 / (1 - rate)``, the mask drawn from ``generator``
    (on ``x``'s device; ``None``: torch's global generator).  Under
    :func:`batch_shard` the mask is drawn for the whole batch and this
    rank's rows of it are kept."""
    shard = _BATCH_SHARD.get()
    if shard is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    else:
        b = x.shape[0]
        whole = torch.rand((b * shard.world,) + tuple(x.shape[1:]),
                           generator=generator, device=x.device)
        keep = whole[shard.rank * b:(shard.rank + 1) * b] >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class GraphConv(nn.Module):
    """One graph convolution; ``forward`` returns ``(y, adj_att)`` like the
    reference layer: ``adj_att`` is the adjacency with the attention
    scores applied when ``att``, else ``adj``.  Parameters are drawn in
    ``tpugraph``'s order: ``weight``, ``self_weight``, ``att_weight``
    (``[in, in]``), then the zero ``bias``.  While a ``torch.profiler``
    records, the adjacency product ``A @ x`` is the trace region
    ``nn.aggregate`` and its backward ``nn.aggregate.backward``."""

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
        y, adj_att = self.transform(x, adj, dropout_gen)
        if self.bias is not None:
            y = y + self.bias
        if self.normalize_embedding:
            y = normalize_embedding(y)
        return y, adj_att

    def transform(self, x: torch.Tensor, adj: Adjacency,
                  dropout_gen: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, Adjacency]:
        """The layer before its bias: ``((A @ x) @ W [+ x @ W_self],
        adj_att)``, dropout applied to ``x`` first while training."""
        if self.training and self.dropout > 0.001:
            x = apply_dropout(x, self.dropout, dropout_gen)
        with trace_annotation("nn.aggregate"):
            y, adj_att = trace_backward("nn.aggregate.backward", x,
                                        lambda xs: self._aggregate(xs, adj))
        y = torch.matmul(y, self.weight)
        if self.add_self:
            y = y + torch.matmul(x, self.self_weight)
        return y, adj_att

    def _aggregate(self, x: torch.Tensor, adj: Adjacency
                   ) -> Tuple[torch.Tensor, Adjacency]:
        """The adjacency product ``y = A @ x`` of whichever type ``adj``
        is, and ``adj_att``: the adjacency with the attention scores
        applied when ``att``, else ``adj``."""
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
                adj_att = SparseAdj(adj.senders, adj.receivers, weight, adj.csr)
            if adj.csr is None:
                y = spmm(adj.senders, adj.receivers, weight, x)
            else:
                y = csr_matvec(adj.csr, adj.senders, adj.receivers, weight, x)
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
        elif isinstance(adj, HaloAdj):
            y, adj_att = self._halo_coo(x, adj)
        elif isinstance(adj, HaloOverlapAdj):
            y, adj_att = self._halo_coo_overlap(x, adj)
        elif isinstance(adj, HaloBCSRAdj):
            y, adj_att = self._halo_bcsr(x, adj)
        elif isinstance(adj, HaloBCSROverlapAdj):
            y, adj_att = self._halo_bcsr_overlap(x, adj)
        elif isinstance(adj, EdgeShardAdj):
            # x and x W_a are whole on every rank, the rank's edges a part
            # of the sum: their gradients are summed over the ranks on the
            # way back, the sum's passes through
            xs = copy_to_shards(x, adj.mesh.group)
            weight = adj.weight
            if self.att:
                x_att = copy_to_shards(torch.matmul(x, self.att_weight),
                                       adj.mesh.group)
                weight = weight * sddmm(adj.senders, adj.receivers, x_att, x_att)
                adj_att = dataclasses.replace(adj, weight=weight)
            y = reduce_from_shards(spmm(adj.senders, adj.receivers, weight, xs),
                                   adj.mesh.group)
        elif not isinstance(adj, BCSRAdj):
            raise TypeError(f"unknown adjacency {type(adj).__name__}")
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

    def _halo_coo(self, x: torch.Tensor, adj: HaloAdj):
        """``tpugraph/nn/layers.py:577-598``: the exchange, then the shard's
        edges over ``[local | halo]`` rows; attention scores from both ends'
        rows of ``xx W_a``."""
        ns, d = x.shape
        xx = torch.cat([x, halo_exchange(x, adj.send_idx, adj.mesh).reshape(-1, d)])
        weight, adj_att = adj.weight, adj
        if self.att:
            xx_att = torch.matmul(xx, self.att_weight)
            weight = weight * sddmm(adj.sender_slot, adj.receivers_local,
                                    xx_att, xx_att)
            adj_att = dataclasses.replace(adj, weight=weight)
        return spmm(adj.sender_slot, adj.receivers_local, weight, xx, ns), adj_att

    def _halo_coo_overlap(self, x: torch.Tensor, adj: HaloOverlapAdj):
        """``tpugraph/nn/layers.py:545-576``: the exchange in flight while the
        local edges aggregate, then the halo edges."""
        ns, d = x.shape
        pending = start_halo_exchange(x, adj.send_idx, adj.mesh)
        w_loc, adj_att = adj.w_loc, adj
        if self.att:
            x_att = torch.matmul(x, self.att_weight)
            w_loc = w_loc * sddmm(adj.s_loc, adj.r_loc, x_att, x_att)
        y = spmm(adj.s_loc, adj.r_loc, w_loc, x)
        halo = pending.wait().reshape(-1, d)
        w_halo = adj.w_halo
        if self.att:
            h_att = torch.matmul(halo, self.att_weight)
            w_halo = w_halo * torch.sum(h_att[adj.h_slot] * x_att[adj.r_halo], -1)
            adj_att = dataclasses.replace(adj, w_loc=w_loc, w_halo=w_halo)
        return y + spmm(adj.h_slot, adj.r_halo, w_halo, halo, ns), adj_att

    def _scaled(self, m: BCSR, tp: BCSRTranspose, rows: torch.Tensor,
                cols: torch.Tensor) -> BCSR:
        """``m`` with its tiles scaled by the attention scores of ``rows``
        against ``cols`` on the tile support (B2)."""
        return dataclasses.replace(m, tiles=m.tiles * sddmm_dw(m, tp, rows, cols))

    def _halo_bcsr(self, x: torch.Tensor, adj: HaloBCSRAdj):
        """``tpugraph/nn/layers.py:418-468``: the exchange, then B1 over the
        rectangular ``[local | halo]`` tiles (rows padded to the tiles'
        column count); with attention, B2 scores first and the returned
        adjacency has no ``m_t``, whose tiles are unscaled."""
        if self.att and adj.tp is None:
            raise NotImplementedError(
                "GAT on the BCSR-halo path needs a transpose plan: "
                "HaloBCSRAdj(..., tp=bcsr_transpose_plan(m)); see "
                "parallel.spmd.build_halo_bcsr(att=True)")
        ns, d = x.shape
        xx = torch.cat([x, halo_exchange(x, adj.send_idx, adj.mesh).reshape(-1, d)])
        xx = _pad_rows(xx, adj.m.num_nodes)
        if not self.att:
            return bcsr_matvec(adj.m, adj.m_t, xx)[:ns], adj
        xx_att = torch.matmul(xx, self.att_weight)
        eff = self._scaled(adj.m, adj.tp, _pad_rows(xx_att[:ns], adj.m.num_row_nodes),
                           xx_att)
        return (bcsr_matvec_dw(eff, adj.tp, xx)[:ns],
                dataclasses.replace(adj, m=eff, m_t=None))

    def _halo_bcsr_overlap(self, x: torch.Tensor, adj: HaloBCSROverlapAdj):
        """``tpugraph/nn/layers.py:469-544``: B1 (and with attention B2) on
        the square local tiles while the exchange is in flight, then on the
        halo tiles."""
        if self.att and adj.tp_loc is None:
            raise NotImplementedError(
                "GAT on the overlapped BCSR-halo path needs transpose plans: "
                "build_halo_bcsr_overlap(att=True)")
        ns, d = x.shape
        pending = start_halo_exchange(x, adj.send_idx, adj.mesh)
        x_p = _pad_rows(x, adj.m_loc.num_nodes)
        if self.att:
            x_att = _pad_rows(torch.matmul(x, self.att_weight), adj.m_loc.num_nodes)
            a_rows = _pad_rows(x_att[:ns], adj.m_loc.num_row_nodes)
            eff_loc = self._scaled(adj.m_loc, adj.tp_loc, a_rows, x_att)
            y_loc = bcsr_matvec_dw(eff_loc, adj.tp_loc, x_p)
        else:
            y_loc = bcsr_matvec(adj.m_loc, adj.m_loc_t, x_p)
        halo = pending.wait().reshape(-1, d)
        h_p = _pad_rows(halo, adj.m_halo.num_nodes)
        if not self.att:
            return y_loc[:ns] + bcsr_matvec(adj.m_halo, adj.m_halo_t, h_p)[:ns], adj
        h_att = _pad_rows(torch.matmul(halo, self.att_weight), adj.m_halo.num_nodes)
        eff_halo = self._scaled(adj.m_halo, adj.tp_halo, a_rows, h_att)
        y_halo = bcsr_matvec_dw(eff_halo, adj.tp_halo, h_p)
        return (y_loc[:ns] + y_halo[:ns],
                dataclasses.replace(adj, m_loc=eff_loc, m_halo=eff_halo,
                                    m_loc_t=None, m_halo_t=None))


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with zero rows appended up to ``n`` rows."""
    return x if x.shape[0] == n else nn.functional.pad(x, (0, 0, 0, n - x.shape[0]))


class GATConv(nn.Module):
    """Multi-head graph attention (arXiv:1710.10903) with a linear
    residual, as DGL's ogbn-arxiv example builds it: for head ``h`` and
    receiver ``i`` over its in-edges ``j`` (the adjacency carries a
    self-loop on every node), ``z = x W``, ``e_ij = LeakyReLU(a_l^h .
    z_j^h + a_r^h . z_i^h)``, ``alpha_ij = softmax_j e_ij`` and ``y_i^h =
    sum_j alpha_ij z_j^h + (x_i W_res)^h``; returns ``[N, H F]``, the heads
    side by side.  No bias (DGL's has none; the encoder adds its own).

    ``adj`` is a :class:`SparseAdj` with its ``csr``
    (:func:`tpugraph_torch.train.loop.build_adjacency` gives a GAT model
    one on every device); the attention runs
    :func:`tpugraph_torch.ops.coo_kernels.gat_attention` (the kernels on
    the card, their plain versions on the CPU).  ``weight`` and
    ``res_weight`` are ``[in, H F]``, ``attn_l``/``attn_r`` ``[H, F]``,
    drawn from ``generator`` with DGL's Xavier-normal ReLU gain.  While a
    ``torch.profiler`` records, the attention (its scores, softmax and
    aggregation) is the trace region ``nn.attention`` and its backward
    ``nn.attention.backward``; the two GEMMs lie outside."""

    def __init__(self, input_dim: int, head_dim: int, num_heads: int,
                 negative_slope: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_dim = input_dim
        self.head_dim = head_dim
        self.num_heads = num_heads
        self.negative_slope = negative_slope
        out = head_dim * num_heads
        self.weight = nn.Parameter(xavier_relu_normal((input_dim, out), input_dim,
                                                      out, generator))
        self.attn_l = nn.Parameter(xavier_relu_normal((num_heads, head_dim), out,
                                                      head_dim, generator))
        self.attn_r = nn.Parameter(xavier_relu_normal((num_heads, head_dim), out,
                                                      head_dim, generator))
        self.res_weight = nn.Parameter(xavier_relu_normal((input_dim, out), input_dim,
                                                          out, generator))

    def forward(self, x: torch.Tensor, adj: SparseAdj) -> torch.Tensor:
        if not isinstance(adj, SparseAdj) or adj.csr is None:
            raise ValueError("GATConv attends over a SparseAdj with its EdgeCSR "
                             "(train.loop.build_adjacency(..., self_loops=True))")
        z = torch.matmul(x, self.weight)
        with trace_annotation("nn.attention"):
            y = trace_backward("nn.attention.backward", z,
                               lambda zs: self._attend(zs, adj.csr))
        return y + torch.matmul(x, self.res_weight)

    def _attend(self, z: torch.Tensor, csr: EdgeCSR) -> torch.Tensor:
        """The scores of each node as sender (``el``) and receiver (``er``),
        then the edge softmax and the weighted sum."""
        zh = z.view(z.shape[0], self.num_heads, self.head_dim)
        el = torch.sum(zh * self.attn_l, dim=-1)
        er = torch.sum(zh * self.attn_r, dim=-1)
        return gat_attention(csr, z, el, er, self.num_heads, self.negative_slope)


class GENConv(nn.Module):
    """DeeperGCN's generalized convolution with ``softmax_sg`` aggregation
    (arXiv:2006.07739; the authors' ``GENConv`` in ``deep_gcns_torch``,
    one MLP layer, no message norm): for receiver ``v`` over its in-edges
    ``u`` (the adjacency carries a self-loop on every node), ``mu_u =
    ReLU(x_u) + eps``, ``m_v = sum_u softmax_u(t mu_u) mu_u`` per channel
    with the softmax weights under no gradient, and ``y_v = (x_v + m_v) W +
    b``.  ``weight`` is ``[in, out]``; ``weight`` and ``bias`` are drawn
    from ``generator`` as ``nn.Linear`` draws them.

    ``adj`` is a :class:`SparseAdj` with its ``csr``
    (:func:`tpugraph_torch.train.loop.build_adjacency` gives a model with
    ``self_loops`` one on every device); the aggregation runs
    :func:`tpugraph_torch.ops.gen_kernels.softmax_aggr` (the kernels on the
    card, their plain versions on the CPU).  While a ``torch.profiler``
    records, the aggregation is the trace region ``nn.softmax_aggr`` and
    its backward ``nn.softmax_aggr.backward``; the GEMM lies outside."""

    def __init__(self, input_dim: int, output_dim: int, t: float = 0.1,
                 eps: float = 1e-7, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.t = t
        self.eps = eps
        self.weight = nn.Parameter(
            torch_linear_kernel((output_dim, input_dim), generator).t().contiguous())
        self.bias = nn.Parameter(torch_linear_bias(input_dim, (output_dim,), generator))

    def forward(self, x: torch.Tensor, adj: SparseAdj) -> torch.Tensor:
        if not isinstance(adj, SparseAdj) or adj.csr is None:
            raise ValueError("GENConv aggregates over a SparseAdj with its EdgeCSR "
                             "(train.loop.build_adjacency(..., self_loops=True))")
        with trace_annotation("nn.softmax_aggr"):
            m = trace_backward("nn.softmax_aggr.backward", x,
                               lambda xs: softmax_aggr(adj.csr, xs, self.t, self.eps))
        return torch.addmm(self.bias, x + m, self.weight)
