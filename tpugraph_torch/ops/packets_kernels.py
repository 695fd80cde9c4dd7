"""Port of ``tpugraph/ops/pallas_packets.py``: SpMM over edge packets (B7)
and its autograd wrapper.

* :func:`spmm_packets` — ``y = A @ x`` with A as :class:`EdgePackets`;
  replaces the Pallas kernel ``spmm_packets``
  (``tpugraph/ops/pallas_packets.py:146``).  On a CUDA tensor it
  launches the hand-written kernel of
  ``tpugraph_torch/csrc/packets_kernels.cu`` or raises; on a CPU tensor
  it runs :func:`spmm_packets_plain`.
* :class:`PacketsMatvec` — ``A @ x`` with ``dx = A^T g`` through the same
  kernel on the transposed packets (``:221-272``).

The compute dtype follows the TPU kernel (``:113-133``): with bfloat16,
``w`` and ``x`` are rounded to bf16, their product is exact in f32 and
is rounded to bf16 again before the f32 scatter-sum.  ``None`` means
bfloat16 on a CUDA tensor and float32 on the CPU, as the JAX package
picks bf16 on its accelerator and f32 in interpret mode.

The kernel walks receiver rows, not packets: :func:`packet_schedule`
lists every live slot in order of (global receiver row, packet, slot),
built once per :class:`EdgePackets` on the packets' device and kept on
the object (:func:`schedule`).  Each row is cut into chunks of at most
``CHUNK_EDGES`` live edges; a row that is one chunk is written directly,
and the chunks of a split row write f32 partial rows, which a second
pass (``spmm_packets_reduce``) adds in chunk order and rounds once.  Each
row sums in schedule order in registers, with no atomics, so every
launch gives the same bits.  :func:`spmm_packets_schedule_plain` repeats
that schedule in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional

import torch

from tpugraph_torch.ops._build import check_tensor, library, raise_on, stream
from tpugraph_torch.ops.packets import EdgePackets

# Live edges a chunk of the schedule holds at most.  On the ogbn-arxiv
# stand-in (169,343 nodes, 2.33M edges, Chung-Lu at gamma 2.5) the hub
# rows have a few thousand edges; chunks of 256 split a few hundred rows,
# whose f32 partial rows (a few MB at D = 256) are under 1% of the
# gather's E x D x 4 bytes.
CHUNK_EDGES = 256
ABLATIONS = ("full", "slots_only", "no_gather", "gather_only")

LAUNCHES: Dict[str, int] = {"spmm_packets": 0, "spmm_packets_reduce": 0}
_bound = False


@dataclasses.dataclass
class PacketSchedule:
    """B7's row schedule over one :class:`EdgePackets`: its live slots
    (``w != 0``) in order of (global receiver row, packet, slot).

    rowptr int32[N + 1]   — row ``i``'s edges are ``rowptr[i]..rowptr[i+1]``
    src    int32[E]       — ``col_blk * block_c + cols``, the x row each
                             edge gathers
    slot   int32[E]       — ``packet * K + k``, the slot whose weight
                             ``w[slot]`` it reads
    items  int32[n, 4]    — (row, first edge, end edge, partial slot or -1
                             for a row that is one chunk), longest first;
                             every row has at least one
    splits int32[s, 4]    — (row, first partial slot, chunks, 0) of each
                             split row
    """

    rowptr: torch.Tensor
    src: torch.Tensor
    slot: torch.Tensor
    items: torch.Tensor
    splits: torch.Tensor
    num_parts: int  # f32 partial rows a call writes (chunks of split rows)


def _work_list(rowptr: torch.Tensor, n_chunks: torch.Tensor, total: int,
               num_split: int, chunk: int):
    """(items, splits) of :class:`PacketSchedule` on ``rowptr``'s device:
    every row's edges cut into chunks of ``chunk`` in order, the longest
    chunks first (a stable sort), and a split row's chunks given
    consecutive partial slots.  Scans, sorts and 1-D gathers, no host
    sync."""
    dev = rowptr.device
    row = torch.repeat_interleave(n_chunks, output_size=total)
    first_chunk = torch.cumsum(n_chunks, 0) - n_chunks
    k = torch.arange(total, device=dev) - torch.gather(first_chunk, 0, row)
    lo = torch.gather(rowptr[:-1], 0, row) + k * chunk
    hi = torch.minimum(lo + chunk, torch.gather(rowptr[1:], 0, row))
    split = n_chunks > 1
    parts = torch.where(split, n_chunks, 0)
    first_part = torch.cumsum(parts, 0) - parts
    part = torch.where(torch.gather(split, 0, row),
                       torch.gather(first_part, 0, row) + k, -1)
    order = torch.sort(lo - hi, stable=True).indices
    items = torch.stack([torch.gather(v, 0, order) for v in (row, lo, hi, part)], 1)
    # the split rows in order: the head of a stable sort that puts them
    # first (nonzero would wait for the device)
    sb = torch.sort((~split).to(torch.int32), stable=True).indices[:num_split]
    splits = torch.stack([sb, torch.gather(first_part, 0, sb),
                          torch.gather(n_chunks, 0, sb), torch.zeros_like(sb)], 1)
    return items.int(), splits.int()


def packet_schedule(p: EdgePackets, chunk_edges: int = CHUNK_EDGES
                    ) -> PacketSchedule:
    """The :class:`PacketSchedule` of ``p`` with torch on ``p``'s device
    (numpy arrays on the CPU): one stable sort of every slot by its global
    receiver row (dead slots last), scans and 1-D gathers, and one host
    sync for the sizes."""
    rows, cols, w, row_of, col_blk = (torch.as_tensor(getattr(p, f)) for f in
                                      ("rows", "cols", "w", "row_of", "col_blk"))
    n, k = p.num_nodes, p.k
    if p.num_edge_slots >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError("the schedule holds int32 indices")
    dev = rows.device
    row = (row_of[:, None] * p.block_r + rows).reshape(-1)
    key = torch.where(w.reshape(-1) != 0, row, n)
    sorted_key, order = torch.sort(key, stable=True)
    rowptr = torch.searchsorted(
        sorted_key, torch.arange(n + 1, device=dev, dtype=key.dtype))
    n_chunks = torch.clamp((rowptr[1:] - rowptr[:-1] + chunk_edges - 1)
                           // chunk_edges, min=1)
    total, num_split, num_parts, e = torch.stack([
        n_chunks.sum(), (n_chunks > 1).sum(),
        torch.where(n_chunks > 1, n_chunks, 0).sum(), rowptr[-1]]).tolist()
    slot = order[:e]
    src = (torch.gather(col_blk.long(), 0, slot // k) * p.block_c
           + torch.gather(cols.reshape(-1).long(), 0, slot))
    items, splits = _work_list(rowptr, n_chunks, total, num_split, chunk_edges)
    return PacketSchedule(rowptr.int(), src.int(), slot.int(), items, splits,
                          num_parts)


def schedule(p: EdgePackets) -> PacketSchedule:
    """:func:`packet_schedule` of ``p``, built once and kept on the
    object."""
    cached = vars(p).get("_schedule")
    if cached is None:
        cached = vars(p)["_schedule"] = packet_schedule(p)
    return cached


def _compute_dtype(compute_dtype: Optional[torch.dtype], device) -> torch.dtype:
    if compute_dtype is None:
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype}")
    return compute_dtype


def _terms(w: torch.Tensor, xg: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Each edge's term ``g = w x`` from its weights ``w [...]`` and
    gathered x rows ``xg [..., D]``, with the compute dtype's roundings."""
    if compute_dtype == torch.bfloat16:
        w = w.to(torch.bfloat16).float()
        xg = xg.to(torch.bfloat16).float()
        return (w[..., None] * xg).to(torch.bfloat16).float()
    return w[..., None] * xg


def spmm_packets_plain(p: EdgePackets, x: torch.Tensor,
                       out_dtype: Optional[torch.dtype] = None,
                       compute_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """Plain PyTorch ``A @ x``: gather the x row of every slot, scale by
    its weight (with the compute dtype's roundings) and ``index_add_``
    into the slot's output row."""
    src = p.col_blk.long()[:, None] * p.block_c + p.cols.long()
    dst = p.row_of.long()[:, None] * p.block_r + p.rows.long()
    g = _terms(p.w, x[src], compute_dtype)  # [P, K, D]
    y = torch.zeros((p.num_nodes, x.shape[1]), dtype=torch.float32,
                    device=x.device)
    y.index_add_(0, dst.reshape(-1), g.reshape(-1, x.shape[1]))
    return y.to(out_dtype or torch.float32)


def spmm_packets_schedule_plain(p: EdgePackets, x: torch.Tensor,
                                out_dtype: Optional[torch.dtype] = None,
                                compute_dtype: torch.dtype = torch.float32,
                                chunk_edges: Optional[int] = None
                                ) -> torch.Tensor:
    """Plain PyTorch ``A @ x`` that walks the kernel's schedule (the one
    kept on ``p``, or one in chunks of ``chunk_edges``): each chunk's f32
    sum over its edges in schedule order, written directly for a row that
    is one chunk and as a partial row otherwise; each split row's partials
    summed in chunk order; one rounding to ``out_dtype`` at the end."""
    sc = schedule(p) if chunk_edges is None else packet_schedule(p, chunk_edges)
    d = x.shape[1]
    g = _terms(p.w.reshape(-1)[sc.slot.long()], x[sc.src.long()], compute_dtype)
    items = sc.items.long()
    items = items[torch.argsort(items[:, 1], stable=True)]  # in edge order
    chunk_of = torch.repeat_interleave(
        torch.arange(items.shape[0], device=x.device), items[:, 2] - items[:, 1],
        output_size=g.shape[0])
    acc = torch.zeros((items.shape[0], d), dtype=torch.float32, device=x.device)
    acc.index_add_(0, chunk_of, g)
    y = torch.zeros((p.num_nodes, d), dtype=torch.float32, device=x.device)
    direct = items[:, 3] < 0
    y[items[direct, 0]] = acc[direct]
    parts = torch.empty((sc.num_parts, d), dtype=torch.float32, device=x.device)
    parts[items[~direct, 3]] = acc[~direct]
    row, first, n = sc.splits.long()[:, :3].unbind(1)
    out = parts[first]
    for j in range(1, int(n.max()) if n.numel() else 0):
        more = n > j
        out[more] += parts[first[more] + j]
    y[row] = out
    return y.to(out_dtype or torch.float32)


def _lib():
    global _bound
    lib = library("packets_kernels")
    if not _bound:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.spmm_packets.argtypes = [vp] * 4 + [ci] + [vp] * 3 + [ci] * 4 + [vp]
        lib.spmm_packets.restype = ci
        lib.spmm_packets_reduce.argtypes = [vp, ci, vp, vp, ci, ci, ci, vp]
        lib.spmm_packets_reduce.restype = ci
        lib.spmm_packets_ablation.argtypes = [vp] * 4 + [ci] + [vp] * 3 + [ci] * 2 + [vp]
        lib.spmm_packets_ablation.restype = ci
        _bound = True
    return lib


def _check_layout(p: EdgePackets, device) -> None:
    for name in ("rows", "cols"):
        check_tensor(name, getattr(p, name), torch.int32, 2, device)
    check_tensor("w", p.w, torch.float32, 2, device)
    for name in ("row_of", "col_blk", "row_ptr"):
        check_tensor(name, getattr(p, name), torch.int32, 1, device)
    n_p, k = p.rows.shape
    if (tuple(p.cols.shape) != (n_p, k) or tuple(p.w.shape) != (n_p, k)
            or p.row_of.shape[0] != n_p or p.col_blk.shape[0] != n_p
            or p.row_ptr.shape[0] != p.num_row_blocks + 1 or k == 0):
        raise ValueError("rows / cols / w / row_of / col_blk / row_ptr do not "
                         "match")
    if p.num_nodes % p.block_r or p.num_nodes % p.block_c:
        raise ValueError("num_nodes must be a multiple of block_r and block_c")


def _check_args(p: EdgePackets, x: torch.Tensor, out_dtype) -> torch.dtype:
    _check_layout(p, x.device)
    check_tensor("x", x, torch.float32, 2, x.device)
    n, d = x.shape
    if n != p.num_nodes or d == 0:
        raise ValueError(f"x must be [{p.num_nodes}, D>0], got {tuple(x.shape)}")
    out_dtype = out_dtype or torch.float32
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    return out_dtype


def _launch(p: EdgePackets, x: torch.Tensor, out_dtype: torch.dtype,
            bf16: bool, mode: Optional[int] = None) -> torch.Tensor:
    """Run B7's main pass (or its ablation ``mode``) and, where rows are
    split, the reduce pass (not for ``gather_only``, which writes no
    partials); counts launches only for ``mode=None``."""
    lib = _lib()
    sc = schedule(p)
    dev = x.device
    for name in ("src", "slot"):
        check_tensor(name, getattr(sc, name), torch.int32, 1, dev)
    check_tensor("items", sc.items, torch.int32, 2, dev)
    check_tensor("splits", sc.splits, torch.int32, 2, dev)
    n, d = x.shape
    xk = x.to(torch.bfloat16) if bf16 else x  # rounded once, not per edge
    vec = d % 4 == 0 and xk.data_ptr() % 16 == 0
    if mode is not None and not (bf16 and vec and out_dtype == torch.float32):
        raise ValueError("the ablations take bf16 compute, an f32 output and "
                         "D % 4 == 0")
    gather_only = mode == ABLATIONS.index("gather_only")
    y = (torch.zeros if gather_only else torch.empty)(
        (n, d), dtype=out_dtype, device=dev)
    partial = torch.empty((sc.num_parts, d), dtype=torch.float32, device=dev)
    args = (sc.src.data_ptr(), sc.slot.data_ptr(), p.w.data_ptr(),
            sc.items.data_ptr(), sc.items.shape[0], xk.data_ptr(), y.data_ptr(),
            partial.data_ptr())
    out_bf16 = int(out_dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        if mode is None:
            err = lib.spmm_packets(*args, int(bf16), out_bf16, int(vec), d,
                                   stream(dev))
        else:
            err = lib.spmm_packets_ablation(*args, mode, d, stream(dev))
        raise_on(err, "spmm_packets")
        if mode is None:
            LAUNCHES["spmm_packets"] += 1
        if sc.splits.shape[0] and not gather_only:
            err = lib.spmm_packets_reduce(
                sc.splits.data_ptr(), sc.splits.shape[0], partial.data_ptr(),
                y.data_ptr(), out_bf16, int(vec), d, stream(dev))
            raise_on(err, "spmm_packets_reduce")
            if mode is None:
                LAUNCHES["spmm_packets_reduce"] += 1
    return y


def spmm_packets(p: EdgePackets, x: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None,
                 compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``y[num_nodes, D] = A @ x`` with ``x [num_nodes, D]`` float32, ``y``
    at ``out_dtype`` (float32 or bfloat16;
    ``tpugraph/ops/pallas_packets.py:146``)."""
    out_dtype = _check_args(p, x, out_dtype)
    cd = _compute_dtype(compute_dtype, x.device)
    if x.device.type == "cpu":
        return spmm_packets_plain(p, x, out_dtype, cd)
    if x.device.type != "cuda":
        raise ValueError(f"no spmm_packets kernel for device {x.device}")
    return _launch(p, x, out_dtype, cd == torch.bfloat16)


def _spmm_packets_ablation(p: EdgePackets, x: torch.Tensor,
                           mode: str) -> torch.Tensor:
    """B7 (bf16 compute, f32 output) in one of its diagnostic modes, the
    counterpart of ``bench_packets_diag.py:112 run_variant``: ``full``;
    ``slots_only`` (the schedule and weights read, nothing gathered);
    ``no_gather`` (every x read goes to row 0); ``gather_only`` (no
    per-row store: one register sum a lane, written once a warp).  Only ``full``
    gives ``A @ x``; the others keep its shape.  Card only; no launch is
    counted."""
    if mode not in ABLATIONS:
        raise ValueError(f"mode must be one of {ABLATIONS}, got {mode!r}")
    _check_args(p, x, None)
    if x.device.type != "cuda":
        raise ValueError("the B7 ablations run on a CUDA device only")
    return _launch(p, x, torch.float32, True, ABLATIONS.index(mode))


class PacketsMatvec(torch.autograd.Function):
    """Static-weight ``A @ x`` on packets: forward B7 on ``p``, backward
    ``dx = B7(p_t, g)`` at the same compute dtype
    (``tpugraph/ops/pallas_packets.py:243-268``)."""

    @staticmethod
    def forward(ctx, x, p, p_t, compute_dtype):
        ctx.p_t, ctx.compute_dtype = p_t, compute_dtype
        return spmm_packets(p, x, compute_dtype=compute_dtype)

    @staticmethod
    def backward(ctx, g):
        dx = spmm_packets(ctx.p_t, g.contiguous(),
                          compute_dtype=ctx.compute_dtype)
        return dx, None, None, None


def packets_matvec(p: EdgePackets, p_t: EdgePackets, x: torch.Tensor,
                   compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Differentiable ``A @ x`` (gradient to ``x``); ``p_t`` holds the
    packets of ``A^T``."""
    return PacketsMatvec.apply(x, p, p_t, compute_dtype)
