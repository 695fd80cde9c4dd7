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

The kernel walks a work list (:func:`packet_work_list`): each receiver
block's packet range cut into chunks of at most ``CHUNK_SLOTS`` slots.
A block that is one chunk is written directly; the chunks of a split
block write f32 partials, which a second pass (``spmm_packets_reduce``)
sums in chunk order and rounds once.  :func:`spmm_packets_schedule_plain`
repeats that schedule in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from tpugraph_torch.ops._build import check_tensor, library, raise_on, stream
from tpugraph_torch.ops.bcsr import _host
from tpugraph_torch.ops.packets import Array, EdgePackets

_COLS = 64                    # columns of D per CTA (csrc COLS)
_SMEM_LIMIT = 232_448         # bytes of shared memory a block may use (H100)
# Slots a chunk of the work list holds at most: 128 packets of 128.  On the
# 65,536-node power-law graph (block_r 512) it cuts the hub receiver block
# into 26 chunks, and the split blocks' f32 partials (126 chunks x 512 x
# D x 4 bytes, 33 MB at D = 128) stay near 3% of the gather's E x D x 4.
CHUNK_SLOTS = 16_384
ABLATIONS = ("full", "slots_only", "no_gather", "gather_only")

LAUNCHES: Dict[str, int] = {"spmm_packets": 0, "spmm_packets_reduce": 0}
_bound = False


@dataclasses.dataclass
class PacketWork:
    """B7's schedule over one :class:`EdgePackets`.

    items  int32[n_items, 4] — (receiver block, first packet, end packet,
                                partial slot or -1 for an unsplit block),
                                largest chunk first
    splits int32[n_split, 4] — (receiver block, first partial slot,
                                chunks, 0) of every split block
    """

    items: Array    # numpy on the host, a tensor on the packets' device
    splits: Array
    num_parts: int  # f32 partials a call writes (chunks of split blocks)


def packet_work_list(row_ptr, k: int, chunk_slots: int = CHUNK_SLOTS
                     ) -> PacketWork:
    """Cut each receiver block's packets ``row_ptr[r]..row_ptr[r+1]`` into
    chunks of at most ``chunk_slots // k`` packets (numpy, on the host).
    A block with no packets is one empty chunk, so its rows are written
    as zeros."""
    row_ptr = _host(row_ptr).astype(np.int64)
    chunk = max(1, chunk_slots // k)
    counts = np.diff(row_ptr)
    n_chunks = np.maximum(1, -(-counts // chunk))
    rb = np.repeat(np.arange(len(counts)), n_chunks)
    first = np.cumsum(n_chunks) - n_chunks
    lo = row_ptr[rb] + (np.arange(len(rb)) - first[rb]) * chunk
    hi = np.minimum(lo + chunk, row_ptr[rb + 1])
    split = n_chunks[rb] > 1
    part = np.full(len(rb), -1, np.int64)
    part[split] = np.arange(int(split.sum()))
    items = np.stack([rb, lo, hi, part], 1)
    items = items[np.argsort(-(hi - lo), kind="stable")]
    sb = np.flatnonzero(n_chunks > 1)
    first_part = np.cumsum(n_chunks[sb]) - n_chunks[sb]
    splits = np.stack([sb, first_part, n_chunks[sb], np.zeros_like(sb)], 1)
    return PacketWork(items.astype(np.int32), splits.astype(np.int32),
                      int(split.sum()))


def work_list(p: EdgePackets) -> PacketWork:
    """:func:`packet_work_list` of ``p`` on ``p``'s device, built once and
    kept on the object (one host read of ``row_ptr`` the first time)."""
    cached = vars(p).get("_work")
    if cached is None:
        wl = packet_work_list(p.row_ptr, p.k)
        dev = p.row_ptr.device if isinstance(p.row_ptr, torch.Tensor) else "cpu"
        cached = PacketWork(torch.from_numpy(wl.items).to(dev),
                            torch.from_numpy(wl.splits).to(dev), wl.num_parts)
        vars(p)["_work"] = cached
    return cached


def _compute_dtype(compute_dtype: Optional[torch.dtype], device) -> torch.dtype:
    if compute_dtype is None:
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype}")
    return compute_dtype


def _packet_terms(p: EdgePackets, x: torch.Tensor, compute_dtype,
                  lo: int = 0, hi: Optional[int] = None):
    """(output row of every slot, its term ``g``) of packets ``lo..hi``,
    with the compute dtype's roundings."""
    sl = slice(lo, hi)
    w = p.w[sl]
    if compute_dtype == torch.bfloat16:
        x = x.to(torch.bfloat16).float()
        w = w.to(torch.bfloat16).float()
    src = p.col_blk[sl].long()[:, None] * p.block_c + p.cols[sl].long()
    dst = p.row_of[sl].long()[:, None] * p.block_r + p.rows[sl].long()
    g = w[:, :, None] * x[src]  # [P, K, D]
    if compute_dtype == torch.bfloat16:
        g = g.to(torch.bfloat16).float()
    return dst.reshape(-1), g.reshape(-1, x.shape[1])


def spmm_packets_plain(p: EdgePackets, x: torch.Tensor,
                       out_dtype: Optional[torch.dtype] = None,
                       compute_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """Plain PyTorch ``A @ x``: gather the x row of every slot, scale by
    its weight (with the compute dtype's roundings) and ``index_add_``
    into the slot's output row."""
    dst, g = _packet_terms(p, x, compute_dtype)
    y = torch.zeros((p.num_nodes, x.shape[1]), dtype=torch.float32,
                    device=x.device)
    y.index_add_(0, dst, g)
    return y.to(out_dtype or torch.float32)


def spmm_packets_schedule_plain(p: EdgePackets, x: torch.Tensor,
                                out_dtype: Optional[torch.dtype] = None,
                                compute_dtype: torch.dtype = torch.float32,
                                chunk_slots: int = CHUNK_SLOTS
                                ) -> torch.Tensor:
    """Plain PyTorch ``A @ x`` that walks the kernel's work list: an f32
    sum per chunk, written directly for an unsplit block and as a partial
    otherwise; each split block's partials summed in chunk order; one
    rounding to ``out_dtype`` at the end."""
    wl = packet_work_list(p.row_ptr, p.k, chunk_slots)
    br, d = p.block_r, x.shape[1]
    y = torch.zeros((p.num_nodes, d), dtype=torch.float32, device=x.device)
    parts = torch.zeros((wl.num_parts, br, d), dtype=torch.float32,
                        device=x.device)
    for rb, lo, hi, part in wl.items.tolist():
        acc = torch.zeros((br, d), dtype=torch.float32, device=x.device)
        dst, g = _packet_terms(p, x, compute_dtype, lo, hi)
        acc.index_add_(0, dst - rb * br, g)
        (y[rb * br:(rb + 1) * br] if part < 0 else parts[part]).copy_(acc)
    for rb, first, n, _ in wl.splits.tolist():
        acc = parts[first].clone()
        for i in range(first + 1, first + n):
            acc += parts[i]
        y[rb * br:(rb + 1) * br] = acc
    return y.to(out_dtype or torch.float32)


def _lib():
    global _bound
    lib = library("packets_kernels")
    if not _bound:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.spmm_packets.argtypes = [vp] * 5 + [ci] + [vp] * 3 + [ci] * 7 + [vp]
        lib.spmm_packets.restype = ci
        lib.spmm_packets_reduce.argtypes = [vp, ci, vp, vp, ci, ci, ci, ci, vp]
        lib.spmm_packets_reduce.restype = ci
        lib.spmm_packets_ablation.argtypes = [vp] * 5 + [ci] + [vp] * 3 + [ci] * 5 + [vp]
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
    """Run B7's main pass (or its ablation ``mode``) and, where blocks are
    split, the reduce pass; counts launches only for ``mode=None``."""
    if p.block_r * _COLS * 4 > _SMEM_LIMIT:
        raise ValueError(f"block_r {p.block_r} too large: the kernel keeps "
                         f"block_r x {_COLS} float32 in shared memory")
    lib = _lib()
    wl = work_list(p)
    n, d = x.shape
    xk = x.to(torch.bfloat16) if bf16 else x  # rounded once, not per edge
    vec = d % 4 == 0 and xk.data_ptr() % 16 == 0
    if mode is not None and not (bf16 and vec and out_dtype == torch.float32):
        raise ValueError("the ablations take bf16 compute, an f32 output and "
                         "D % 4 == 0")
    y = torch.empty((n, d), dtype=out_dtype, device=x.device)
    partial = torch.empty((wl.num_parts, p.block_r, d), dtype=torch.float32,
                          device=x.device)
    args = (p.rows.data_ptr(), p.cols.data_ptr(), p.w.data_ptr(),
            p.col_blk.data_ptr(), wl.items.data_ptr(), wl.items.shape[0],
            xk.data_ptr(), y.data_ptr(), partial.data_ptr())
    geom = (p.k, p.block_r, p.block_c, d, stream(x.device))
    with torch.cuda.device(x.device):
        if mode is None:
            err = lib.spmm_packets(*args, int(bf16),
                                   int(out_dtype == torch.bfloat16), int(vec), *geom)
        else:
            err = lib.spmm_packets_ablation(*args, mode, *geom)
        raise_on(err, "spmm_packets")
        if mode is None:
            LAUNCHES["spmm_packets"] += 1
        if wl.splits.shape[0]:
            err = lib.spmm_packets_reduce(
                wl.splits.data_ptr(), wl.splits.shape[0], partial.data_ptr(),
                y.data_ptr(), int(out_dtype == torch.bfloat16), int(vec),
                p.block_r, d, stream(x.device))
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
    ``slots_only`` (slot data read and accumulated, no gather);
    ``no_gather`` (every x read goes to row 0); ``gather_only`` (no
    shared-memory accumulation, one register sum a lane).  Only ``full``
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
