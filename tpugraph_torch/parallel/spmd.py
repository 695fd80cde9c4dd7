"""Port of ``tpugraph/parallel/spmd.py``: edge-partitioned and
node-partitioned (halo) message passing and their training steps, and the
data-parallel graph-classification step, on ``torch.distributed``.

JAX runs one program over a device mesh (``shard_map``, sharded ``jit``);
here every rank of a process group runs its own copy (see
:mod:`tpugraph_torch.parallel.launch`) and the collectives of
:mod:`tpugraph_torch.parallel.collectives` join them.  The plans are built
on the host, the same on every rank, as numpy arrays byte-identical to
``tpugraph``'s; a rank moves only its own slice to its device
(:func:`halo_adjacency`).  ``tpugraph`` stacks the per-device BCSRs of a
plan on a leading axis; the port keeps them as one list entry per rank,
padded to the largest shard's tile count all the same (the card's kernels
run that layout, dead tiles included).

* Edge partitioning (``:39-165``): :func:`shard_graph_edges` gives a rank
  its contiguous slice of the padded edge list, :func:`sharded_spmm` adds
  the ranks' partial sums; :func:`partition_edges_by_receiver` and
  :func:`sharded_spmm_node_partitioned` shard nodes and gather every
  rank's rows.
* Halo plans (``:168-658``): :func:`build_halo_plan` (the native engine,
  or numpy), the degree-snake :func:`balance_partition` and the
  label-propagation :func:`locality_partition`, the split
  :func:`split_halo_plan`, and their BCSR forms :func:`build_halo_bcsr`
  and :func:`build_halo_bcsr_overlap`; :func:`build_halo` picks one by
  the overlap policy.
* Steps (``:659-1207``): :func:`make_halo_train_step` /
  :func:`make_halo_forward` dispatch on the plan's type, as in
  ``tpugraph``; :func:`make_sharded_node_train_step` (edge shards);
  :func:`make_dp_graph_train_step` (a contiguous slice of the batch a
  rank, the whole batch's loss, statistics and dropout mask).
* Whole-group runs (global arrays in, rank 0's global result out, for
  :func:`~tpugraph_torch.parallel.launch.run_ranks`):
  :func:`apply_sharded_spmm`, :func:`apply_node_partitioned_spmm`,
  :func:`apply_halo_spmm`, :func:`halo_apply`, :func:`halo_fit`,
  :func:`sharded_node_fit`.

**The halo gradient is ``n_dev`` times the single-device one**, as in
``tpugraph`` (see :func:`_make_halo_step_generic`); the edge-sharded and
data-parallel steps give the single-device gradient, as ``tpugraph``'s
sharded ``jit`` does.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from tpugraph_torch import native
from tpugraph_torch.core.graph import Graph, pad_graph
from tpugraph_torch.nn.layers import (BatchShard, EdgeShardAdj, HaloAdj,
                                      HaloBCSRAdj, HaloBCSROverlapAdj,
                                      HaloOverlapAdj, batch_shard,
                                      halo_exchange)
from tpugraph_torch.nn.losses import link_prediction_terms
from tpugraph_torch.ops.bcsr import (BCSR, BCSRTranspose, _longest,
                                     bcsr_from_coo, bcsr_pad_tiles,
                                     bcsr_transpose_plan, entry_order)
from tpugraph_torch.ops.message import spmm
from tpugraph_torch.parallel.collectives import (all_gather_rows, all_reduce_,
                                                 psum, reduce_from_shards)
from tpugraph_torch.parallel.mesh import Mesh, group_mesh


def _round8(v: int) -> int:
    return max(((v + 7) // 8) * 8, 8)


# ---------------------------------------------------------------- edge shards

def shard_graph_edges(g: Graph, mesh: Mesh) -> Graph:
    """This rank's contiguous slice of ``g``'s edge list, padded first to a
    multiple of the mesh size (``tpugraph/parallel/spmd.py:39``); node
    arrays whole.  ``num_edges_padded`` of the slice times the mesh size
    is the padded total."""
    n_dev = mesh.size
    e_pad = g.num_edges_padded
    e_new = ((e_pad + n_dev - 1) // n_dev) * n_dev
    if e_new != e_pad:
        g = pad_graph(g, g.num_nodes_padded, e_new)
    per = e_new // n_dev
    sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
    return g._replace(senders=g.senders[sl], receivers=g.receivers[sl],
                      edge_weight=g.edge_weight[sl], edge_pair=g.edge_pair[sl])


def sharded_spmm(mesh: Mesh) -> Callable:
    """``f(senders, receivers, weights, x) -> y``: the rank's edge slice
    aggregated from the whole ``x``, the partial sums added over the ranks
    (``tpugraph/parallel/spmd.py:62``); ``y`` is whole on every rank and
    its gradient stays whole (:class:`~tpugraph_torch.nn.layers.EdgeShardAdj`
    is the same in a layer)."""

    def f(s, r, w, x):
        return reduce_from_shards(spmm(s.long(), r.long(), w, x), mesh.group)

    return f


def partition_edges_by_receiver(g: Graph, n_dev: int) -> Tuple[Graph, int]:
    """Host-side: nodes in ``n_dev`` contiguous shards of ``ns``, and each
    shard's live edges (those into its nodes, receivers made local),
    padded to the largest shard's count, flattened to one edge list
    (``tpugraph/parallel/spmd.py:89``).  Returns ``(graph, ns)``."""
    n_pad = ((g.num_nodes_padded + n_dev - 1) // n_dev) * n_dev
    ns = n_pad // n_dev
    s, r = g.senders.numpy(), g.receivers.numpy()
    w, p = g.edge_weight.numpy(), g.edge_pair.numpy()
    live = w != 0
    shard_of = r // ns
    per_shard = [np.nonzero(live & (shard_of == d))[0] for d in range(n_dev)]
    e_max = _round8(max(len(ix) for ix in per_shard))
    S = np.zeros((n_dev, e_max), np.int32)
    R = np.zeros((n_dev, e_max), np.int32)
    W = np.zeros((n_dev, e_max), np.float32)
    Pr = np.full((n_dev, e_max), n_dev * e_max, np.int32)
    for d, idx in enumerate(per_shard):
        k = len(idx)
        S[d, :k] = s[idx]
        R[d, :k] = r[idx] - d * ns
        W[d, :k] = w[idx]
        Pr[d, :k] = p[idx]
    node_mask = np.zeros((n_pad,), np.float32)
    node_mask[: int(g.n_node)] = 1.0
    out = Graph(senders=torch.from_numpy(S.reshape(-1)),
                receivers=torch.from_numpy(R.reshape(-1)),
                edge_weight=torch.from_numpy(W.reshape(-1)),
                node_mask=torch.from_numpy(node_mask), n_node=g.n_node,
                n_edge=g.n_edge, edge_pair=torch.from_numpy(Pr.reshape(-1)))
    return out, ns


def sharded_spmm_node_partitioned(mesh: Mesh) -> Callable:
    """``f(senders, receivers_local, weights, x_local) -> y_local``: the
    rank's edges of :func:`partition_edges_by_receiver` aggregated from
    every rank's rows, gathered (``tpugraph/parallel/spmd.py:141``)."""

    def f(s, r_loc, w, x_local):
        xg = all_gather_rows(x_local, mesh.group)
        return spmm(s.long(), r_loc.long(), w, xg, x_local.shape[0])

    return f


# ----------------------------------------------------------------- halo plans

class HaloPlan(NamedTuple):
    """The boundary exchange of a node-partitioned graph
    (``tpugraph/parallel/spmd.py:168``), host numpy: ``send_idx[d, e]`` the
    local rows device ``d`` sends peer ``e`` (padded with 0);
    ``sender_slot[d]`` each of ``d``'s edges' row of ``[local (Ns) | halo
    (n_dev * H)]``; ``receivers_local[d]`` and ``weights[d]`` (0 on
    padding)."""

    send_idx: np.ndarray         # int32[n_dev, n_dev, H]
    sender_slot: np.ndarray      # int32[n_dev, E_max]
    receivers_local: np.ndarray  # int32[n_dev, E_max]
    weights: np.ndarray          # float32[n_dev, E_max]
    shard_size: int              # Ns
    halo_size: int               # H


def balance_partition(receivers: np.ndarray, num_nodes: int, n_dev: int,
                      weights: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Degree-balancing relabelling: nodes dealt to shards in a
    descending-degree snake (``tpugraph/parallel/spmd.py:187``).  Returns
    ``(perm, inv)``, ``perm[new_id] = old_id``."""
    r = np.asarray(receivers)
    if weights is not None:
        r = r[np.asarray(weights) != 0]
    deg = np.bincount(r, minlength=num_nodes)
    n_pad = ((num_nodes + n_dev - 1) // n_dev) * n_dev
    if n_pad > num_nodes:
        deg = np.pad(deg, (0, n_pad - num_nodes))
    order = np.argsort(-deg, kind="stable")
    ns = n_pad // n_dev
    shard_seq = np.tile(
        np.concatenate([np.arange(n_dev), np.arange(n_dev)[::-1]]),
        (ns + 1) // 2 + 1)[:n_pad]
    slot_seq = np.repeat(np.arange((n_pad + 2 * n_dev - 1) // (2 * n_dev) * 2),
                         n_dev)[:n_pad]
    perm = np.empty(n_pad, dtype=np.int64)
    perm[shard_seq * ns + slot_seq] = order
    inv = np.empty(n_pad, dtype=np.int64)
    inv[perm] = np.arange(n_pad)
    return perm, inv


def locality_partition(senders: np.ndarray, receivers: np.ndarray,
                       num_nodes: int, n_dev: int,
                       weights: Optional[np.ndarray] = None, iters: int = 20,
                       slack: float = 1.02) -> Tuple[np.ndarray, np.ndarray]:
    """The degree-snake seed refined by balanced label propagation
    (``native.label_prop_partition``), each partition then a contiguous
    shard of ``ns`` (the largest partition, 8-aligned) with edge-free pad
    ids at its tail (``tpugraph/parallel/spmd.py:230``).  Returns
    ``(perm, inv)`` of length ``ns * n_dev``.  The engine and its numpy
    fallback partition differently (see :mod:`tpugraph_torch.native`)."""
    s = np.asarray(senders)
    r = np.asarray(receivers)
    w = (np.asarray(weights, np.float32) if weights is not None
         else np.ones(len(s), np.float32))
    perm0, inv0 = balance_partition(r, num_nodes, n_dev, weights=w)
    ns0 = len(perm0) // n_dev
    seed_assign = (inv0[:num_nodes] // ns0).astype(np.int32)
    assign, _ = native.label_prop_partition(s, r, w, num_nodes, n_dev,
                                            seed_assign, iters=iters, slack=slack)
    sizes = np.bincount(assign, minlength=n_dev)
    ns = max(int(sizes.max()), (num_nodes + n_dev - 1) // n_dev)
    ns = ((ns + 7) // 8) * 8
    perm = np.empty(ns * n_dev, np.int64)
    next_pad = num_nodes
    for d in range(n_dev):
        ids = np.flatnonzero(assign == d)
        perm[d * ns: d * ns + len(ids)] = ids
        n_fill = ns - len(ids)
        perm[d * ns + len(ids):(d + 1) * ns] = np.arange(next_pad, next_pad + n_fill)
        next_pad += n_fill
    inv = np.empty(ns * n_dev, np.int64)
    inv[perm] = np.arange(ns * n_dev)
    return perm, inv


def build_halo_plan(g: Graph, n_dev: int) -> HaloPlan:
    """The :class:`HaloPlan` of ``g`` over ``n_dev`` contiguous shards
    (``tpugraph/parallel/spmd.py:293``): the native engine's two passes, or
    where it cannot be built (:func:`tpugraph_torch.native.native_available`)
    the numpy builder, which gives the same arrays."""
    n_pad = ((g.num_nodes_padded + n_dev - 1) // n_dev) * n_dev
    ns = n_pad // n_dev
    s, r, w = g.senders.numpy(), g.receivers.numpy(), g.edge_weight.numpy()
    out = native.halo_plan(s, r, w, ns, n_dev)
    if out is not None:
        send_idx, sender_slot, receivers_local, weights, _, h = out
        return HaloPlan(send_idx, sender_slot, receivers_local, weights, ns, h)

    live = w != 0
    shard_edges = [np.nonzero(live & (r // ns == d))[0] for d in range(n_dev)]
    e_max = _round8(max((len(ix) for ix in shard_edges), default=1))
    # needed[d][e]: the sorted nodes of e that d's edges read
    needed = [[[] for _ in range(n_dev)] for _ in range(n_dev)]
    for d in range(n_dev):
        senders_d = s[shard_edges[d]]
        for node in np.unique(senders_d[senders_d // ns != d]):
            needed[d][int(node // ns)].append(int(node))
    h = _round8(max((len(lst) for row in needed for lst in row), default=1))
    send_idx = np.zeros((n_dev, n_dev, h), np.int32)
    recv_slot = [dict() for _ in range(n_dev)]
    for d in range(n_dev):
        for e in range(n_dev):
            for j, node in enumerate(needed[d][e]):
                send_idx[e, d, j] = node - e * ns
                recv_slot[d][node] = e * h + j
    sender_slot = np.zeros((n_dev, e_max), np.int32)
    receivers_local = np.zeros((n_dev, e_max), np.int32)
    weights = np.zeros((n_dev, e_max), np.float32)
    for d in range(n_dev):
        for k, e_id in enumerate(shard_edges[d]):
            snd = int(s[e_id])
            sender_slot[d, k] = (snd - d * ns if snd // ns == d
                                 else ns + recv_slot[d][snd])
            receivers_local[d, k] = r[e_id] - d * ns
            weights[d, k] = w[e_id]
    return HaloPlan(send_idx, sender_slot, receivers_local, weights, ns, h)


class HaloBCSRPlan(NamedTuple):
    """A :class:`HaloPlan` whose shards' edges are rectangular BCSRs over
    ``[local | halo]`` columns (``tpugraph/parallel/spmd.py:373``): ``m[d]``
    and its transpose ``m_t[d]`` for each shard, every list padded to its
    largest tile count; ``tp[d]`` the transpose plans for attention."""

    send_idx: np.ndarray
    m: List[BCSR]
    m_t: List[BCSR]
    shard_size: int
    halo_size: int
    tp: Optional[List[BCSRTranspose]] = None


def _pad_tp(tp: BCSRTranspose, t_pad: int) -> BCSRTranspose:
    """``tp`` with dead entries (perm 0, keep 0, the last row block) up to
    ``t_pad`` tiles (``tpugraph/parallel/spmd.py:388``)."""
    t = tp.num_tiles
    if t_pad < t:
        raise ValueError(f"tile budget too small: {t} > {t_pad}")
    if t_pad == t:
        return tp
    extra = t_pad - t
    row_ptr = np.asarray(tp.row_ptr).copy()
    n_rb = row_ptr.shape[0] - 1
    row_ptr[n_rb] += extra
    padded = dataclasses.replace(
        tp,
        col_blk=np.concatenate([np.asarray(tp.col_blk), np.zeros(extra, np.int32)]),
        row_ptr=row_ptr,
        row_of=np.concatenate([np.asarray(tp.row_of),
                               np.full(extra, n_rb - 1, np.int32)]),
        perm=np.concatenate([np.asarray(tp.perm), np.zeros(extra, np.int32)]),
        keep=np.concatenate([np.asarray(tp.keep), np.zeros(extra, np.float32)]),
        longest_list=_longest(row_ptr))
    return dataclasses.replace(padded, order=entry_order(padded.row_of))


def _stack_bcsrs(lst: List[BCSR]) -> List[BCSR]:
    """Every BCSR of ``lst`` padded with dead tiles to the largest tile
    count (``tpugraph/parallel/spmd.py:545``, which then stacks them)."""
    t_max = max(m.num_tiles for m in lst)
    return [bcsr_pad_tiles(m, t_max) for m in lst]


def _stack_tps(ms: List[BCSR]) -> List[BCSRTranspose]:
    """The transpose plan of each BCSR, padded to the largest entry count
    (``tpugraph/parallel/spmd.py:561``)."""
    tps = [bcsr_transpose_plan(m) for m in ms]
    tp_max = max(t.num_tiles for t in tps)
    return [_pad_tp(t, tp_max) for t in tps]


def build_halo_bcsr(plan: HaloPlan, n_dev: int, block: int = 128,
                    tile_dtype=None, att: bool = False) -> HaloBCSRPlan:
    """Each shard's edges as a rectangular BCSR ``[Ns, Ns + n_dev * H]`` and
    its transpose, every shard padded to the largest tile count, and with
    ``att`` the transpose plans (``tpugraph/parallel/spmd.py:417``)."""
    ns, h = plan.shard_size, plan.halo_size
    n_col = ns + n_dev * h
    ss, rr, ww = plan.sender_slot, plan.receivers_local, plan.weights
    ms = [bcsr_from_coo(ss[d], rr[d], ww[d], ns, block=block,
                        num_col_nodes=n_col, tile_dtype=tile_dtype)
          for d in range(n_dev)]
    mts = [bcsr_from_coo(rr[d], ss[d], ww[d], n_col, block=block,
                         num_col_nodes=ns, tile_dtype=tile_dtype)
           for d in range(n_dev)]
    ms, mts = _stack_bcsrs(ms), _stack_bcsrs(mts)
    return HaloBCSRPlan(plan.send_idx, ms, mts, ns, h,
                        _stack_tps(ms) if att else None)


class HaloOverlapPlan(NamedTuple):
    """A :class:`HaloPlan` with each shard's live edges split into the
    local-local set and the halo-dependent one, each padded to its largest
    count (``tpugraph/parallel/spmd.py:464``); ``h_slot`` a row of the
    received halo."""

    send_idx: np.ndarray  # int32[n_dev, n_dev, H]
    s_loc: np.ndarray     # int32[n_dev, EL]
    r_loc: np.ndarray
    w_loc: np.ndarray     # float32[n_dev, EL] (0 on padding)
    h_slot: np.ndarray    # int32[n_dev, EH]
    r_halo: np.ndarray
    w_halo: np.ndarray
    shard_size: int
    halo_size: int


def split_halo_plan(plan: HaloPlan, n_dev: int) -> HaloOverlapPlan:
    """The split of ``plan`` (``tpugraph/parallel/spmd.py:482``)."""
    ns = plan.shard_size
    ss, rr, ww = plan.sender_slot, plan.receivers_local, plan.weights
    assert ss.shape[0] == n_dev, (ss.shape[0], n_dev)
    live = ww != 0
    loc = live & (ss < ns)
    rem = live & (ss >= ns)
    el = _round8(max(int(loc.sum(axis=1).max(initial=0)), 1))
    eh = _round8(max(int(rem.sum(axis=1).max(initial=0)), 1))
    S_loc = np.zeros((n_dev, el), np.int32)
    R_loc = np.zeros((n_dev, el), np.int32)
    W_loc = np.zeros((n_dev, el), np.float32)
    H_slot = np.zeros((n_dev, eh), np.int32)
    R_halo = np.zeros((n_dev, eh), np.int32)
    W_halo = np.zeros((n_dev, eh), np.float32)
    for d in range(n_dev):
        li = np.flatnonzero(loc[d])
        S_loc[d, :len(li)] = ss[d, li]
        R_loc[d, :len(li)] = rr[d, li]
        W_loc[d, :len(li)] = ww[d, li]
        ri = np.flatnonzero(rem[d])
        H_slot[d, :len(ri)] = ss[d, ri] - ns
        R_halo[d, :len(ri)] = rr[d, ri]
        W_halo[d, :len(ri)] = ww[d, ri]
    return HaloOverlapPlan(plan.send_idx, S_loc, R_loc, W_loc, H_slot, R_halo,
                           W_halo, ns, plan.halo_size)


class HaloBCSROverlapPlan(NamedTuple):
    """The split as BCSRs (``tpugraph/parallel/spmd.py:528``): ``m_loc[d]``
    square over the shard's columns, ``m_halo[d]`` rectangular over the
    halo, their transposes, and with attention their transpose plans;
    each list padded to its largest tile count."""

    send_idx: np.ndarray
    m_loc: List[BCSR]
    m_loc_t: List[BCSR]
    m_halo: List[BCSR]
    m_halo_t: List[BCSR]
    shard_size: int
    halo_size: int
    tp_loc: Optional[List[BCSRTranspose]] = None
    tp_halo: Optional[List[BCSRTranspose]] = None


def build_halo_bcsr_overlap(plan: HaloPlan, n_dev: int, block: int = 128,
                            tile_dtype=None, att: bool = False
                            ) -> HaloBCSROverlapPlan:
    """:func:`split_halo_plan` packed as BCSRs
    (``tpugraph/parallel/spmd.py:582``)."""
    sp = split_halo_plan(plan, n_dev)
    ns, h = plan.shard_size, plan.halo_size
    n_halo_col = n_dev * h
    ml, mlt, mh, mht = [], [], [], []
    for d in range(n_dev):
        ml.append(bcsr_from_coo(sp.s_loc[d], sp.r_loc[d], sp.w_loc[d], ns,
                                block=block, tile_dtype=tile_dtype))
        mlt.append(bcsr_from_coo(sp.r_loc[d], sp.s_loc[d], sp.w_loc[d], ns,
                                 block=block, tile_dtype=tile_dtype))
        mh.append(bcsr_from_coo(sp.h_slot[d], sp.r_halo[d], sp.w_halo[d], ns,
                                block=block, num_col_nodes=n_halo_col,
                                tile_dtype=tile_dtype))
        mht.append(bcsr_from_coo(sp.r_halo[d], sp.h_slot[d], sp.w_halo[d],
                                 n_halo_col, block=block, num_col_nodes=ns,
                                 tile_dtype=tile_dtype))
    ml, mlt, mh, mht = (_stack_bcsrs(x) for x in (ml, mlt, mh, mht))
    return HaloBCSROverlapPlan(plan.send_idx, ml, mlt, mh, mht, ns, h,
                               _stack_tps(ml) if att else None,
                               _stack_tps(mh) if att else None)


def _dev(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def halo_adjacency(plan, mesh: Mesh, device=None):
    """This rank's slice of a halo plan, on ``device`` (``mesh.device`` by
    default), as the layer's adjacency: :class:`HaloPlan` ->
    ``HaloAdj``, :class:`HaloOverlapPlan` -> ``HaloOverlapAdj``,
    :class:`HaloBCSRPlan` -> ``HaloBCSRAdj``, :class:`HaloBCSROverlapPlan`
    -> ``HaloBCSROverlapAdj`` (``tpugraph``'s ``_slice0`` helpers)."""
    d = mesh.rank
    dev = torch.device(device) if device is not None else mesh.device
    i64 = torch.int64
    send = _dev(plan.send_idx[d], dev, i64)
    tp_of = lambda tps: None if tps is None else tps[d].to(dev)
    if isinstance(plan, HaloBCSROverlapPlan):
        return HaloBCSROverlapAdj(send, plan.m_loc[d].to(dev),
                                  plan.m_loc_t[d].to(dev),
                                  plan.m_halo[d].to(dev),
                                  plan.m_halo_t[d].to(dev),
                                  tp_of(plan.tp_loc), tp_of(plan.tp_halo), mesh)
    if isinstance(plan, HaloBCSRPlan):
        return HaloBCSRAdj(send, plan.m[d].to(dev), plan.m_t[d].to(dev),
                           tp_of(plan.tp), mesh)
    if isinstance(plan, HaloOverlapPlan):
        return HaloOverlapAdj(send, *(_dev(a[d], dev, i64) for a in
                                      (plan.s_loc, plan.r_loc)),
                              _dev(plan.w_loc[d], dev),
                              *(_dev(a[d], dev, i64) for a in
                                (plan.h_slot, plan.r_halo)),
                              _dev(plan.w_halo[d], dev), mesh)
    if isinstance(plan, HaloPlan):
        return HaloAdj(send, _dev(plan.sender_slot[d], dev, i64),
                       _dev(plan.receivers_local[d], dev, i64),
                       _dev(plan.weights[d], dev), mesh)
    raise TypeError(f"not a halo plan: {type(plan).__name__}")


# ---------------------------------------------------------------------- steps

def _all_reduce_grads(params: List[torch.nn.Parameter], mesh: Mesh) -> None:
    """Sum every parameter's gradient over the ranks, in one flat buffer."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = all_reduce_(_flatten_dense_tensors(grads), mesh.group)
    for p, g in zip(params, _unflatten_dense_tensors(flat, grads)):
        p.grad = g


def _make_halo_step_generic(model: torch.nn.Module, opt, mesh: Mesh,
                            class_weight: Optional[torch.Tensor], adj):
    """``step(x, y, train_mask) -> loss`` on this rank's shard ``x [Ns,
    D]`` (``tpugraph/parallel/spmd.py:659``): the class-weighted
    cross-entropy normalized over the whole graph, then one update.

    The gradient is ``n_dev`` times the single-device gradient, as in
    ``tpugraph``: there the loss's numerator and denominator are ``psum``-ed
    inside ``value_and_grad`` under ``shard_map(check_vma=False)``, whose
    transpose of ``psum`` is again ``psum`` (each rank's numerator gets
    ``n_dev / den``), and the gradients are ``psum``-ed once more
    (``:665-683``).  :func:`~tpugraph_torch.parallel.collectives.psum` and
    the gradient all-reduce below do the same.  Adam does not see the
    factor (up to its eps); SGD and the global-norm clip do."""
    params = list(model.parameters())

    def step(x, y, train_mask):
        logits, _ = model(x, adj)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, y.long()[..., None])[..., 0]
        wts = (class_weight[y.long()] if class_weight is not None
               else torch.ones_like(nll)) * train_mask
        num = psum(torch.sum(nll * wts), mesh.group)
        den = psum(torch.sum(wts), mesh.group)
        loss = num / torch.clamp(den, min=1e-12)
        opt.zero_grad()
        loss.backward()
        _all_reduce_grads(params, mesh)
        opt.step()
        return loss.detach()

    return step


def _make_halo_fwd_generic(model: torch.nn.Module, adj):
    @torch.no_grad()
    def fwd(x):
        return model(x, adj)[0]

    return fwd


def _checked(plan, kind, want):
    if not isinstance(plan, want):
        raise TypeError(f"{kind} takes a {want.__name__}, got {type(plan).__name__}")
    return plan


def make_halo_node_train_step(model, opt, mesh: Mesh, plan: HaloPlan,
                              class_weight=None, device=None):
    """COO halo training (``tpugraph/parallel/spmd.py:930``); the plan is
    given here (its slice moves to the device once), ``step(x, y, mask)``
    takes this rank's shard."""
    adj = halo_adjacency(_checked(plan, "make_halo_node_train_step", HaloPlan),
                         mesh, device)
    return _make_halo_step_generic(model, opt, mesh, class_weight, adj)


def make_halo_node_forward(model, mesh: Mesh, plan: HaloPlan, device=None):
    """``fwd(x_local) -> logits_local`` (``tpugraph/parallel/spmd.py:990``)."""
    return _make_halo_fwd_generic(model, halo_adjacency(
        _checked(plan, "make_halo_node_forward", HaloPlan), mesh, device))


def make_halo_overlap_train_step(model, opt, mesh: Mesh, plan: HaloOverlapPlan,
                                 class_weight=None, device=None):
    """The split COO step: local aggregation while the exchange is in
    flight (``tpugraph/parallel/spmd.py:709``)."""
    adj = halo_adjacency(_checked(plan, "make_halo_overlap_train_step",
                                  HaloOverlapPlan), mesh, device)
    return _make_halo_step_generic(model, opt, mesh, class_weight, adj)


def make_halo_overlap_forward(model, mesh: Mesh, plan: HaloOverlapPlan,
                              device=None):
    """(``tpugraph/parallel/spmd.py:742``)."""
    return _make_halo_fwd_generic(model, halo_adjacency(
        _checked(plan, "make_halo_overlap_forward", HaloOverlapPlan), mesh, device))


def make_halo_bcsr_train_step(model, opt, mesh: Mesh, plan: HaloBCSRPlan,
                              class_weight=None, device=None):
    """Halo training on the shard's rectangular tiles, B1 (and B2 with
    attention) (``tpugraph/parallel/spmd.py:821``)."""
    adj = halo_adjacency(_checked(plan, "make_halo_bcsr_train_step",
                                  HaloBCSRPlan), mesh, device)
    return _make_halo_step_generic(model, opt, mesh, class_weight, adj)


def make_halo_bcsr_forward(model, mesh: Mesh, plan: HaloBCSRPlan, device=None):
    """(``tpugraph/parallel/spmd.py:857``)."""
    return _make_halo_fwd_generic(model, halo_adjacency(
        _checked(plan, "make_halo_bcsr_forward", HaloBCSRPlan), mesh, device))


def make_halo_bcsr_overlap_train_step(model, opt, mesh: Mesh,
                                      plan: HaloBCSROverlapPlan,
                                      class_weight=None, device=None):
    """The split on tiles: B1 on the local tiles while the exchange is in
    flight, then on the halo tiles (``tpugraph/parallel/spmd.py:762``)."""
    adj = halo_adjacency(_checked(plan, "make_halo_bcsr_overlap_train_step",
                                  HaloBCSROverlapPlan), mesh, device)
    return _make_halo_step_generic(model, opt, mesh, class_weight, adj)


def make_halo_bcsr_overlap_forward(model, mesh: Mesh, plan: HaloBCSROverlapPlan,
                                   device=None):
    """(``tpugraph/parallel/spmd.py:808``)."""
    return _make_halo_fwd_generic(model, halo_adjacency(
        _checked(plan, "make_halo_bcsr_overlap_forward", HaloBCSROverlapPlan),
        mesh, device))


def sharded_spmm_halo(mesh: Mesh) -> Callable:
    """``f(send_idx, sender_slot, receivers_local, weights, x_local) ->
    y_local`` on this rank's plan rows: the exchange, then the shard's
    edges over ``[local | halo]`` (``tpugraph/parallel/spmd.py:880``)."""

    def f(send_idx, sender_slot, r_loc, w, x_local):
        ns, d = x_local.shape
        halo = halo_exchange(x_local, send_idx.long(), mesh).reshape(-1, d)
        return spmm(sender_slot.long(), r_loc.long(), w,
                    torch.cat([x_local, halo]), ns)

    return f


def resolve_halo_overlap(overlap: str, mesh: Mesh) -> bool:
    """``"on"``/``"off"`` force; ``"auto"`` overlaps only where there is
    an exchange to hide behind the local work: a group of more than one
    rank on NCCL (``tpugraph/parallel/spmd.py:1015``: only on real
    multi-device hardware; the CPU ranks of gloo share one host)."""
    if overlap == "on":
        return True
    if overlap == "off":
        return False
    if overlap != "auto":
        raise ValueError(f"overlap must be 'auto'/'on'/'off', got {overlap!r}")
    return mesh.size > 1 and mesh.backend == "nccl"


def build_halo(g: Graph, mesh: Mesh, *, bcsr: bool = True, block: int = 128,
               overlap: str = "auto", att: bool = False, tile_dtype=None):
    """:func:`build_halo_plan` over the mesh's ranks and the form the
    overlap policy picks — plain or split, COO or tiles
    (``tpugraph/parallel/spmd.py:1038``); the type of the result routes
    :func:`make_halo_train_step` / :func:`make_halo_forward`."""
    n_dev = mesh.size
    plan = build_halo_plan(g, n_dev)
    ov = resolve_halo_overlap(overlap, mesh)
    if bcsr:
        build = build_halo_bcsr_overlap if ov else build_halo_bcsr
        return build(plan, n_dev, block=block, tile_dtype=tile_dtype, att=att)
    return split_halo_plan(plan, n_dev) if ov else plan


_STEPS = ((HaloBCSROverlapPlan, make_halo_bcsr_overlap_train_step,
           make_halo_bcsr_overlap_forward),
          (HaloBCSRPlan, make_halo_bcsr_train_step, make_halo_bcsr_forward),
          (HaloOverlapPlan, make_halo_overlap_train_step, make_halo_overlap_forward),
          (HaloPlan, make_halo_node_train_step, make_halo_node_forward))


def make_halo_train_step(model, opt, mesh: Mesh, plan, class_weight=None,
                         device=None):
    """The train step for ``plan``'s type (``tpugraph/parallel/spmd.py:1069``):
    ``step(x_local, y_local, mask_local) -> loss``."""
    for kind, make_step, _ in _STEPS:
        if isinstance(plan, kind):
            return make_step(model, opt, mesh, plan, class_weight, device)
    raise TypeError(f"not a halo plan: {type(plan).__name__}")


def make_halo_forward(model, mesh: Mesh, plan, device=None):
    """The forward for ``plan``'s type (``tpugraph/parallel/spmd.py:1096``):
    ``fwd(x_local) -> logits_local``."""
    for kind, _, make_fwd in _STEPS:
        if isinstance(plan, kind):
            return make_fwd(model, mesh, plan, device)
    raise TypeError(f"not a halo plan: {type(plan).__name__}")


def make_sharded_node_train_step(model, opt, mesh: Mesh, class_weight=None):
    """``step(g_shard, x, y, train_mask) -> loss``: full-batch training
    with every layer's aggregation over this rank's edge slice (from
    :func:`shard_graph_edges`) and the partial sums added over the ranks
    (``tpugraph/parallel/spmd.py:1110``).  ``x``, ``y`` and the mask are
    whole on every rank; the loss and the gradient are the single-device
    ones, so no gradient is summed."""

    def step(g_shard: Graph, x, y, train_mask):
        dev = x.device
        adj = EdgeShardAdj(g_shard.senders.to(dev, torch.int64),
                           g_shard.receivers.to(dev, torch.int64),
                           g_shard.edge_weight.to(dev), mesh)
        logits, _ = model(x, adj)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, y.long()[..., None])[..., 0]
        wts = (class_weight[y.long()] if class_weight is not None
               else torch.ones_like(nll)) * train_mask
        loss = torch.sum(nll * wts) / torch.clamp(torch.sum(wts), min=1e-12)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def make_dp_graph_train_step(model, opt, mesh: Mesh, linkpred: bool = False,
                             uses_assign: bool = False, has_dropout: bool = False):
    """``step(dropout_gen, adj, x, node_mask, assign, label) -> (loss,
    logits)`` on the whole batch (the same on every rank): rank ``r`` runs
    rows ``r * b`` to ``(r + 1) * b`` (``b`` = batch / ranks), its share of
    the whole batch's mean loss (and of the link-prediction loss's sum over
    the whole batch's node pairs), and the gradients are summed over the
    ranks, so the update is the single-device one
    (``tpugraph/parallel/spmd.py:1157``).  Batch norm takes the whole
    batch's statistics and dropout the whole batch's mask
    (:func:`~tpugraph_torch.nn.layers.batch_shard`).  The batch size must
    divide by the mesh size.  Returns the whole batch's summed loss and
    logits."""
    params = list(model.parameters())
    n, rank = mesh.size, mesh.rank
    shard = BatchShard(mesh.group, rank, n)

    def step(gen, adj, x, node_mask, assign, label):
        big_b = adj.shape[0]
        if big_b % n:
            raise ValueError(f"batch of {big_b} does not divide by the "
                             f"{n}-device mesh")
        b = big_b // n
        sl = slice(rank * b, (rank + 1) * b)
        kwargs = {"node_mask": node_mask[sl],
                  "dropout_gen": gen if has_dropout else None}
        if uses_assign:
            kwargs["assign_x"] = assign[sl]
        with batch_shard(shard):
            logits, aux = model(x[sl], adj[sl], **kwargs)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, label[sl].long()[..., None])[..., 0]
        loss = torch.sum(nll) / big_b
        if linkpred and isinstance(aux, (list, tuple)) and len(aux) > 0:
            bce, pairs = link_prediction_terms(aux[0], adj[sl], node_mask[sl])
            pairs = all_reduce_(pairs.detach().clone(), mesh.group)
            loss = loss + bce / torch.clamp(pairs, min=1.0)
        opt.zero_grad()
        loss.backward()
        _all_reduce_grads(params, mesh)
        opt.step()
        total = all_reduce_(loss.detach().clone(), mesh.group)
        return total, all_gather_rows(logits.detach(), mesh.group)

    return step


# ------------------------------------------------------- whole-group runs

def _rows(a: np.ndarray, mesh: Mesh, device) -> torch.Tensor:
    """This rank's contiguous block of the first axis of a global array."""
    per = a.shape[0] // mesh.size
    return torch.from_numpy(np.ascontiguousarray(
        a[mesh.rank * per:(mesh.rank + 1) * per])).to(device)


def apply_sharded_spmm(mesh: Optional[Mesh], g: Graph, x: np.ndarray) -> np.ndarray:
    """``A @ x`` through :func:`shard_graph_edges` and :func:`sharded_spmm`
    on each rank (``mesh`` ``None``: every rank of the group, 1-D);
    returns the whole result."""
    mesh = mesh or group_mesh()
    gs = shard_graph_edges(g, mesh)
    dev = mesh.device
    y = sharded_spmm(mesh)(gs.senders.to(dev), gs.receivers.to(dev),
                           gs.edge_weight.to(dev), torch.from_numpy(x).to(dev))
    return y.cpu().numpy()


def apply_node_partitioned_spmm(mesh: Optional[Mesh], gp: Graph,
                                x: np.ndarray) -> np.ndarray:
    """``A @ x`` through :func:`sharded_spmm_node_partitioned` on the
    flat edges of :func:`partition_edges_by_receiver` and the node-sharded
    ``x``; returns every rank's rows."""
    mesh = mesh or group_mesh()
    dev = mesh.device
    edges = [_rows(a.numpy(), mesh, dev) for a in
             (gp.senders, gp.receivers, gp.edge_weight)]
    y = sharded_spmm_node_partitioned(mesh)(*edges, _rows(x, mesh, dev))
    return all_gather_rows(y, mesh.group).cpu().numpy()


def apply_halo_spmm(mesh: Optional[Mesh], plan: HaloPlan, x: np.ndarray,
                    axis="data") -> np.ndarray:
    """``A @ x`` on the node-sharded ``x [n_dev * Ns, D]`` through
    :func:`sharded_spmm_halo` (``tpugraph/parallel/spmd.py:913``); ``mesh``
    ``None``: the group's mesh on ``axis`` (a pair: the 2-D mesh and the
    hierarchical exchange).  Returns every rank's rows."""
    mesh = mesh or group_mesh(axis)
    dev, d = mesh.device, mesh.rank
    arrs = [torch.from_numpy(a[d]).to(dev) for a in
            (plan.send_idx, plan.sender_slot, plan.receivers_local, plan.weights)]
    y = sharded_spmm_halo(mesh)(*arrs, _rows(x, mesh, dev))
    return all_gather_rows(y, mesh.group).cpu().numpy()


def halo_apply(mesh: Optional[Mesh], module: torch.nn.Module, plan,
               x: np.ndarray, grad: bool = False, axis="data") -> Dict[str, Any]:
    """``module(x_local, halo_adjacency(plan))`` on each rank (a copy of
    ``module``): ``{"y":
    every rank's rows of the first output}``, and with ``grad`` the
    gradient of ``sum(y ** 2)`` for each parameter, summed over the ranks
    (``"grads"``, by name)."""
    mesh = mesh or group_mesh(axis)
    dev = mesh.device
    module = copy.deepcopy(module).to(dev)
    adj = halo_adjacency(plan, mesh, dev)
    with torch.set_grad_enabled(grad):
        y = module(_rows(x, mesh, dev), adj)[0]
    out = {"y": all_gather_rows(y.detach(), mesh.group).cpu().numpy()}
    if grad:
        params = list(module.parameters())
        module.zero_grad()
        torch.sum(y * y).backward()
        _all_reduce_grads(params, mesh)
        out["grads"] = {k: p.grad.cpu().numpy()
                        for k, p in module.named_parameters()}
    return out


def halo_fit(mesh: Optional[Mesh], model: torch.nn.Module, plan, x: np.ndarray,
             y: np.ndarray, mask: np.ndarray, steps: int, opt_cfg,
             class_weight: Optional[np.ndarray] = None,
             axis="data") -> Dict[str, Any]:
    """``steps`` updates of :func:`make_halo_train_step` of a copy of
    ``model`` on the node-sharded global arrays (``opt_cfg`` an
    :class:`~tpugraph_torch.train.optim.OptimizerConfig`): ``{"losses",
    "logits"`` (every rank's rows of :func:`make_halo_forward` after the
    last step)``, "params"}``."""
    from tpugraph_torch.train.optim import build_optimizer

    mesh = mesh or group_mesh(axis)
    dev = mesh.device
    model = copy.deepcopy(model).to(dev)
    opt = build_optimizer(model.parameters(), opt_cfg)
    cw = (None if class_weight is None
          else torch.as_tensor(class_weight, dtype=torch.float32, device=dev))
    step = make_halo_train_step(model, opt, mesh, plan, cw, dev)
    xl, yl, ml = (_rows(a, mesh, dev) for a in (x, y, mask))
    losses = [float(step(xl, yl, ml)) for _ in range(steps)]
    logits = make_halo_forward(model, mesh, plan, dev)(xl)
    return {"losses": losses,
            "logits": all_gather_rows(logits, mesh.group).cpu().numpy(),
            "params": {k: v.detach().cpu() for k, v in model.state_dict().items()}}


def sharded_node_fit(mesh: Optional[Mesh], model: torch.nn.Module, g: Graph,
                     x: np.ndarray, y: np.ndarray, mask: np.ndarray, steps: int,
                     opt_cfg) -> List[float]:
    """``steps`` updates of :func:`make_sharded_node_train_step` of a copy
    of ``model`` on :func:`shard_graph_edges`'s slice; returns the
    losses."""
    from tpugraph_torch.train.optim import build_optimizer

    mesh = mesh or group_mesh()
    dev = mesh.device
    model = copy.deepcopy(model).to(dev)
    opt = build_optimizer(model.parameters(), opt_cfg)
    step = make_sharded_node_train_step(model, opt, mesh)
    gs = shard_graph_edges(g, mesh)
    xt, yt, mt = (torch.from_numpy(a).to(dev) for a in (x, y, mask))
    return [float(step(gs, xt, yt, mt)) for _ in range(steps)]
