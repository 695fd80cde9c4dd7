"""Port of ``tpugraph/native/__init__.py``: the host-side graph engine.

The port's own copy of ``graph_engine.cpp`` (beside this file) is built
with ``tpugraph``'s g++ flags into ``build/tpugraph_torch/`` at first use
(the library's name carries a hash of the source, the flags and the host,
as ``-march=native`` makes it host-specific) and bound with ``ctypes``:

* :func:`coo_to_csr` — CSR structure and the edge permutation;
* :func:`bcsr_pack`, :func:`bcsr_pack_fused` — COO -> BCSR tiles;
* :func:`khop_bfs`, :func:`khop_bfs_batch` — k-hop neighbourhoods;
* :func:`rcm_order` — reverse Cuthill-McKee ordering;
* :func:`halo_plan` — the node-partitioned halo-exchange plan;
* :func:`label_prop_partition`, :func:`partition_cut_stats` — balanced
  label propagation and its cut;
* :func:`sym_normalize` — ``w / sqrt(deg_r * deg_c)``.

Each has ``tpugraph``'s numpy fallback, used when the library cannot be
built; the build failure is reported once as a ``RuntimeWarning`` and
:func:`native_available` tells callers which path runs.  The fallbacks
give the same arrays as the library, except :func:`label_prop_partition`,
whose numpy sweep is another algorithm (pass-synchronous, greedy by
gain), as in ``tpugraph``; and :func:`bcsr_pack` raises and
:func:`bcsr_pack_fused` / :func:`halo_plan` return ``None`` without the
library, leaving the fallback to their callers, as in ``tpugraph``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

_SRC = Path(__file__).resolve().with_name("graph_engine.cpp")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpugraph_torch"
_FLAGS = ["-O3", "-march=native", "-fopenmp", "-fno-strict-aliasing",
          "-shared", "-fPIC", "-std=c++17"]

_lib = None  # None: not tried yet; False: the build failed

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _build() -> Optional[ctypes.CDLL]:
    """Compile (where needed) and load the engine; ``None`` and one
    warning when that fails."""
    # -march=native ties the library to the host that built it
    host = f"{platform.node()} {platform.machine()}"
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()
                            + host.encode()).hexdigest()[:12]
    so = _BUILD_DIR / f"libgraph_engine_{digest}.so"
    try:
        if not so.is_file():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
    except Exception as e:  # no compiler, or the build failed
        warnings.warn(f"tpugraph_torch.native: the C++ graph engine is "
                      f"unavailable ({type(e).__name__}: {e}); using the numpy "
                      "fallback", RuntimeWarning, stacklevel=3)
        return None
    vp = ctypes.c_void_p
    i32, i64, f32 = ctypes.c_int32, ctypes.c_int64, ctypes.c_float
    lib.coo_to_csr.argtypes = [_I32P, _I32P, i64, i32, _I32P, _I32P, _I32P]
    lib.bcsr_count_tiles.restype = i64
    lib.bcsr_count_tiles.argtypes = [_I32P, _I32P, _F32P, i64, i32, i32]
    lib.bcsr_pack.restype = i64
    lib.bcsr_pack.argtypes = [_I32P, _I32P, _F32P, i64, i32, i32, _F32P,
                              _I32P, _I32P, _I32P, i64]
    lib.bcsr_count_tiles_v2.restype = i64
    lib.bcsr_count_tiles_v2.argtypes = [_I32P, _I32P, _F32P, i64, i32, i32, i32]
    lib.bcsr_pack_v2.restype = i64
    lib.bcsr_pack_v2.argtypes = [_I32P, _I32P, _F32P, i64, i32, i32, i32, i32,
                                 vp, _I32P, _I32P, _I32P, i64]
    lib.khop_bfs.argtypes = [_I32P, _I32P, i32, i32, i32, _U8P]
    lib.khop_bfs_batch.argtypes = [_I32P, _I32P, i32, _I32P, i32, i32, _U8P]
    lib.sym_normalize.argtypes = [_I32P, _I32P, _F32P, i64, i32]
    lib.rcm_order.argtypes = [_I32P, _I32P, i32, _I32P]
    lib.halo_plan_sizes.argtypes = [_I32P, _I32P, _F32P, i64, i32, i32,
                                    _I64P, _I64P]
    lib.halo_plan_fill.argtypes = [_I32P, _I32P, _F32P, i64, i32, i32, i64,
                                   i64, _I32P, _I32P, _I32P, _F32P]
    lib.label_prop_partition.restype = i64
    lib.label_prop_partition.argtypes = [_I32P, _I32P, _F32P, i64, i32, i32,
                                         i32, f32, _I32P]
    lib.partition_cut_stats.argtypes = [_I32P, _I32P, _F32P, i64, i32, i32,
                                        _I32P, _I64P, _I64P]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    """The loaded engine, or ``None`` where it cannot be built (tried
    once a process)."""
    global _lib
    if _lib is None:
        _lib = _build() or False
    return _lib or None


def native_available() -> bool:
    """Whether the C++ engine runs (``False``: the numpy fallbacks)."""
    return _get_lib() is not None


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(t)


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def coo_to_csr(rows: np.ndarray, cols: np.ndarray,
               num_nodes: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(indptr, indices, perm)`` of the rows -> cols structure, edges in
    input order within a row (``tpugraph/native/__init__.py:119``)."""
    rows, cols = _i32(rows), _i32(cols)
    e = rows.shape[0]
    lib = _get_lib()
    if lib is not None:
        indptr = np.zeros(num_nodes + 1, dtype=np.int32)
        indices = np.zeros(e, dtype=np.int32)
        perm = np.zeros(e, dtype=np.int32)
        lib.coo_to_csr(_ptr(rows, _I32P), _ptr(cols, _I32P), e, num_nodes,
                       _ptr(indptr, _I32P), _ptr(indices, _I32P),
                       _ptr(perm, _I32P))
        return indptr, indices, perm
    perm = np.argsort(rows, kind="stable").astype(np.int32)
    indptr = np.zeros(num_nodes + 1, dtype=np.int32)
    indptr[1:] = np.cumsum(np.bincount(rows, minlength=num_nodes))
    return indptr, cols[perm], perm


def bcsr_pack(rows: np.ndarray, cols: np.ndarray, weights: np.ndarray,
              num_nodes_padded: int, block: int,
              pad_tiles_to: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Square COO -> BCSR ``(tiles, col_blk, row_of, row_ptr, t)``, dead
    tiles up to ``pad_tiles_to`` (``tpugraph/native/__init__.py:144``).
    Raises ``RuntimeError`` without the engine (callers pack in numpy:
    :func:`tpugraph_torch.ops.bcsr.bcsr_from_coo`)."""
    rows, cols = _i32(rows), _i32(cols)
    weights = np.ascontiguousarray(weights, dtype=np.float32)
    e = rows.shape[0]
    n_blocks = num_nodes_padded // block
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native bcsr_pack unavailable")
    t = int(lib.bcsr_count_tiles(_ptr(rows, _I32P), _ptr(cols, _I32P),
                                 _ptr(weights, _F32P), e, n_blocks, block))
    t_pad = pad_tiles_to or max(t, 1)
    if t_pad < t:
        raise ValueError(f"tile budget too small: {t} > {t_pad}")
    tiles = np.zeros((t_pad, block, block), dtype=np.float32)
    col_blk = np.zeros(t_pad, dtype=np.int32)
    row_of = np.zeros(t_pad, dtype=np.int32)
    row_ptr = np.zeros(n_blocks + 1, dtype=np.int32)
    got = int(lib.bcsr_pack(_ptr(rows, _I32P), _ptr(cols, _I32P),
                            _ptr(weights, _F32P), e, n_blocks, block,
                            _ptr(tiles, _F32P), _ptr(col_blk, _I32P),
                            _ptr(row_of, _I32P), _ptr(row_ptr, _I32P), t_pad))
    assert got == t, (got, t)
    return tiles, col_blk, row_of, row_ptr, t


def bcsr_pack_fused(rows: np.ndarray, cols: np.ndarray, weights: np.ndarray,
                    num_nodes_padded: int, block: int, k_pack: int = 1,
                    tile_dtype: Optional[torch.dtype] = None):
    """Square COO -> BCSR in one pass at the ``k_pack``-padded row layout
    and at ``tile_dtype`` (float32, bfloat16 or int8;
    ``tpugraph/native/__init__.py:179``): ``(tiles, col_blk, row_of,
    row_ptr, t_real)``, bfloat16 tiles as a torch tensor, or ``None``
    without the engine."""
    lib = _get_lib()
    if lib is None:
        return None
    rows, cols = _i32(rows), _i32(cols)
    weights = np.ascontiguousarray(weights, dtype=np.float32)
    e = rows.shape[0]
    n_blocks = num_nodes_padded // block
    k_pack = max(int(k_pack), 1)
    t_total = int(lib.bcsr_count_tiles_v2(
        _ptr(rows, _I32P), _ptr(cols, _I32P), _ptr(weights, _F32P), e,
        n_blocks, block, k_pack))
    mode = {None: 0, torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[tile_dtype]
    np_dt = (np.float32, np.uint16, np.int8)[mode]
    tiles = np.empty((t_total, block, block), dtype=np_dt)
    col_blk = np.zeros(t_total, dtype=np.int32)
    row_of = np.zeros(t_total, dtype=np.int32)
    row_ptr = np.zeros(n_blocks + 1, dtype=np.int32)
    got = int(lib.bcsr_pack_v2(
        _ptr(rows, _I32P), _ptr(cols, _I32P), _ptr(weights, _F32P), e,
        n_blocks, block, k_pack, mode, tiles.ctypes.data_as(ctypes.c_void_p),
        _ptr(col_blk, _I32P), _ptr(row_of, _I32P), _ptr(row_ptr, _I32P),
        t_total))
    if got < 0:
        return None
    out = torch.from_numpy(tiles).view(torch.bfloat16) if mode == 1 else tiles
    return out, col_blk, row_of, row_ptr, got


def khop_bfs(indptr: np.ndarray, indices: np.ndarray, src: int,
             k: int) -> np.ndarray:
    """``bool[n]``: the nodes within ``k`` hops of ``src``, itself
    included (``tpugraph/native/__init__.py:228``)."""
    n = indptr.shape[0] - 1
    indptr, indices = _i32(indptr), _i32(indices)
    lib = _get_lib()
    if lib is not None:
        out = np.zeros(n, dtype=np.uint8)
        lib.khop_bfs(_ptr(indptr, _I32P), _ptr(indices, _I32P), n, src, k,
                     _ptr(out, _U8P))
        return out.astype(bool)
    mask = np.zeros(n, dtype=bool)
    mask[src] = True
    frontier = [src]
    for _ in range(k):
        nxt = []
        for u in frontier:
            for v in indices[indptr[u]:indptr[u + 1]]:
                if not mask[v]:
                    mask[v] = True
                    nxt.append(int(v))
        frontier = nxt
    return mask


def khop_bfs_batch(indptr: np.ndarray, indices: np.ndarray, srcs: np.ndarray,
                   k: int) -> np.ndarray:
    """``bool[q, n]``: :func:`khop_bfs` of each of ``q`` sources
    (``tpugraph/native/__init__.py:255``)."""
    n = indptr.shape[0] - 1
    srcs = _i32(srcs)
    lib = _get_lib()
    if lib is not None:
        indptr, indices = _i32(indptr), _i32(indices)
        out = np.zeros((srcs.shape[0], n), dtype=np.uint8)
        lib.khop_bfs_batch(_ptr(indptr, _I32P), _ptr(indices, _I32P), n,
                           _ptr(srcs, _I32P), srcs.shape[0], k, _ptr(out, _U8P))
        return out.astype(bool)
    return np.stack([khop_bfs(indptr, indices, int(s), k) for s in srcs])


def rcm_order(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee order, ``perm[new_id] = old_id``: each
    component from its lowest-degree node, neighbours by ascending degree
    (``tpugraph/native/__init__.py:273``)."""
    n = indptr.shape[0] - 1
    indptr, indices = _i32(indptr), _i32(indices)
    lib = _get_lib()
    if lib is not None:
        perm = np.zeros(n, dtype=np.int32)
        lib.rcm_order(_ptr(indptr, _I32P), _ptr(indices, _I32P), n,
                      _ptr(perm, _I32P))
        return perm
    deg = np.diff(indptr)
    visited = np.zeros(n, dtype=bool)
    order = []
    for s in sorted(range(n), key=lambda i: (deg[i], i)):
        if visited[s]:
            continue
        visited[s] = True
        head = len(order)
        order.append(s)
        while head < len(order):
            u = order[head]
            head += 1
            nbr = [int(v) for v in indices[indptr[u]:indptr[u + 1]]
                   if not visited[v]]
            for v in nbr:
                visited[v] = True
            order.extend(sorted(nbr, key=lambda i: (deg[i], i)))
    return np.asarray(order[::-1], dtype=np.int32)


def halo_plan(senders: np.ndarray, receivers: np.ndarray, weights: np.ndarray,
              shard_size: int, n_dev: int, pad_multiple: int = 8):
    """The halo-exchange plan in two native passes
    (``tpugraph/native/__init__.py:309``): ``(send_idx [n_dev, n_dev, H],
    sender_slot, receivers_local, weights [n_dev, E_max], E_max, H)``, or
    ``None`` without the engine (the caller,
    :func:`tpugraph_torch.parallel.spmd.build_halo_plan`, then builds it
    in numpy)."""
    lib = _get_lib()
    if lib is None:
        return None
    s, r = _i32(senders), _i32(receivers)
    w = np.ascontiguousarray(weights, dtype=np.float32)
    e = s.shape[0]
    e_max, h = ctypes.c_int64(0), ctypes.c_int64(0)
    lib.halo_plan_sizes(_ptr(s, _I32P), _ptr(r, _I32P), _ptr(w, _F32P), e,
                        shard_size, n_dev, ctypes.byref(e_max), ctypes.byref(h))
    rnd = lambda v: max(((v + pad_multiple - 1) // pad_multiple) * pad_multiple,
                        pad_multiple)
    e_pad, h_pad = rnd(e_max.value), rnd(h.value)
    send_idx = np.zeros((n_dev, n_dev, h_pad), np.int32)
    sender_slot = np.zeros((n_dev, e_pad), np.int32)
    receivers_local = np.zeros((n_dev, e_pad), np.int32)
    edge_w = np.zeros((n_dev, e_pad), np.float32)
    lib.halo_plan_fill(_ptr(s, _I32P), _ptr(r, _I32P), _ptr(w, _F32P), e,
                       shard_size, n_dev, e_pad, h_pad, _ptr(send_idx, _I32P),
                       _ptr(sender_slot, _I32P), _ptr(receivers_local, _I32P),
                       _ptr(edge_w, _F32P))
    return send_idx, sender_slot, receivers_local, edge_w, e_pad, h_pad


def sym_normalize(rows: np.ndarray, cols: np.ndarray, weights: np.ndarray,
                  num_nodes: int) -> np.ndarray:
    """``w * inv[rows] * inv[cols]`` with ``inv = 1 / sqrt(deg)`` (0 where
    ``deg`` is 0) and ``deg`` the row sums of ``w``, in a fresh float32
    array (``tpugraph/native/__init__.py:349``, ``graph_engine.cpp:545``).
    The numpy path sums degrees and products in float64 in edge order with
    one cast to float32, so both paths give the same bytes."""
    rows, cols = _i32(rows), _i32(cols)
    w = np.array(weights, dtype=np.float32, copy=True)
    lib = _get_lib()
    if lib is not None:
        lib.sym_normalize(_ptr(rows, _I32P), _ptr(cols, _I32P), _ptr(w, _F32P),
                          rows.shape[0], num_nodes)
        return w
    deg = np.zeros(num_nodes)
    np.add.at(deg, rows, w)
    inv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-300)), 0.0)
    return (w * inv[rows] * inv[cols]).astype(np.float32)


def label_prop_partition(senders: np.ndarray, receivers: np.ndarray,
                         weights: np.ndarray, num_nodes: int, n_dev: int,
                         seed_assign: np.ndarray, iters: int = 20,
                         slack: float = 1.02) -> Tuple[np.ndarray, int]:
    """Balanced label propagation from ``seed_assign``: nodes move to
    their neighbours' majority partition under caps on node count and
    in-edge mass (``slack`` times the mean); returns ``(assign, moves)``
    (``tpugraph/native/__init__.py:367``).  The engine sweeps nodes
    asynchronously in an LCG order; the numpy fallback applies each pass's
    moves greedily by gain — another algorithm, so the two give other
    partitions of one graph, as in ``tpugraph``."""
    s, r = _i32(senders), _i32(receivers)
    w = np.ascontiguousarray(weights, dtype=np.float32)
    assign = np.array(seed_assign, dtype=np.int32, copy=True)
    assert assign.shape[0] == num_nodes, (assign.shape, num_nodes)
    lib = _get_lib()
    if lib is not None:
        moves = lib.label_prop_partition(
            _ptr(s, _I32P), _ptr(r, _I32P), _ptr(w, _F32P), s.shape[0],
            num_nodes, n_dev, iters, ctypes.c_float(slack), _ptr(assign, _I32P))
        return assign, int(moves)
    live = w != 0
    su, ru = s[live], r[live]
    inmass = np.bincount(ru, minlength=num_nodes).astype(np.float64)
    und_s = np.concatenate([su, ru])
    und_r = np.concatenate([ru, su])
    cap_nodes = int(num_nodes / n_dev * slack) + 1
    cap_mass = float(live.sum()) / n_dev * slack + 1.0
    total_moves = 0
    for _ in range(iters):
        hist = np.zeros((num_nodes, n_dev), np.int64)
        np.add.at(hist, (und_r, assign[und_s]), 1)
        best = np.argmax(hist, axis=1).astype(np.int32)
        gain = (hist[np.arange(num_nodes), best]
                - hist[np.arange(num_nodes), assign])
        cand = np.flatnonzero((best != assign) & (gain > 0))
        if cand.size == 0:
            break
        cand = cand[np.argsort(-gain[cand], kind="stable")]
        part_nodes = np.bincount(assign, minlength=n_dev).astype(np.int64)
        part_mass = np.zeros(n_dev)
        np.add.at(part_mass, assign, inmass)
        moves = 0
        for u in cand:
            b = best[u]
            if part_nodes[b] + 1 > cap_nodes or part_mass[b] + inmass[u] > cap_mass:
                continue
            part_nodes[assign[u]] -= 1
            part_mass[assign[u]] -= inmass[u]
            part_nodes[b] += 1
            part_mass[b] += inmass[u]
            assign[u] = b
            moves += 1
        total_moves += moves
        if moves == 0:
            break
    return assign, total_moves


def partition_cut_stats(senders: np.ndarray, receivers: np.ndarray,
                        weights: np.ndarray, num_nodes: int, n_dev: int,
                        assign: np.ndarray) -> Tuple[int, np.ndarray]:
    """``(cut_edges, recv_rows [n_dev])`` of a partition: the live edges
    whose ends lie on two shards, and for each shard the distinct remote
    senders its edges read, the halo rows it receives
    (``tpugraph/native/__init__.py:444``)."""
    s, r, a = _i32(senders), _i32(receivers), _i32(assign)
    w = np.ascontiguousarray(weights, dtype=np.float32)
    lib = _get_lib()
    if lib is not None:
        cut = ctypes.c_int64(0)
        recv = np.zeros(n_dev, np.int64)
        lib.partition_cut_stats(_ptr(s, _I32P), _ptr(r, _I32P), _ptr(w, _F32P),
                                s.shape[0], num_nodes, n_dev, _ptr(a, _I32P),
                                ctypes.byref(cut), _ptr(recv, _I64P))
        return int(cut.value), recv
    live = w != 0
    su, ru = s[live], r[live]
    ds, dr = a[su], a[ru]
    cut_mask = ds != dr
    recv = np.zeros(n_dev, np.int64)
    for d in range(n_dev):
        recv[d] = np.unique(su[cut_mask & (dr == d)]).size
    return int(cut_mask.sum()), recv
