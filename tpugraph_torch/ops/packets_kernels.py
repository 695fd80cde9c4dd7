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
lists every live slot in order of (global receiver row, packet, slot) as a
:class:`~tpugraph_torch.ops.csr.CSR` (``col`` the x row it gathers, ``eid``
the slot whose weight it reads), built once per :class:`EdgePackets` on the
packets' device and kept on the object (:func:`schedule`).  The kernel is
the COO product's row walk (``ops/csr.py``, ``csrc/row_spmm.cuh``) with
B7's compute and output dtypes: each row sums in schedule order in
registers, with no atomics, so every launch gives the same bits;
:func:`~tpugraph_torch.ops.csr.spmm_csr_plain` repeats that walk in plain
PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from tpugraph_torch.ops._build import check_tensor, library
from tpugraph_torch.ops.csr import CSR, edge_terms, launch, row_csrs
from tpugraph_torch.ops.packets import EdgePackets

ABLATIONS = ("full", "slots_only", "no_gather", "gather_only")

LAUNCHES: Dict[str, int] = {"spmm_packets": 0, "spmm_packets_reduce": 0}
_bound = False


def packet_schedule(p: EdgePackets) -> CSR:
    """B7's row schedule over ``p``: its live slots (``w != 0``) in order of
    (global receiver row, packet, slot) as a :class:`CSR` (``col =
    col_blk * block_c + cols``, computed for the live slots only; ``eid``
    the slot ``packet * K + k``), by :func:`~tpugraph_torch.ops.csr.row_csrs`
    with the dead slots keyed past the last row, with torch on ``p``'s
    device (numpy arrays on the CPU) and one host sync."""
    rows, cols, w, row_of, col_blk = (torch.as_tensor(getattr(p, f)) for f in
                                      ("rows", "cols", "w", "row_of", "col_blk"))
    k = p.k
    row = (row_of[:, None] * p.block_r + rows).reshape(-1)
    key = torch.where(w.reshape(-1) != 0, row, p.num_nodes)

    def col_of(slot):
        return (torch.gather(col_blk.long(), 0, slot // k) * p.block_c
                + torch.gather(cols.reshape(-1).long(), 0, slot))

    (sc,) = row_csrs([(key, col_of)], p.num_nodes)
    return sc


def schedule(p: EdgePackets) -> CSR:
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


def spmm_packets_plain(p: EdgePackets, x: torch.Tensor,
                       out_dtype: Optional[torch.dtype] = None,
                       compute_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """Plain PyTorch ``A @ x``: gather the x row of every slot, scale by
    its weight (with the compute dtype's roundings) and ``index_add_``
    into the slot's output row."""
    src = p.col_blk.long()[:, None] * p.block_c + p.cols.long()
    dst = p.row_of.long()[:, None] * p.block_r + p.rows.long()
    g = edge_terms(p.w, x[src], compute_dtype)  # [P, K, D]
    y = torch.zeros((p.num_nodes, x.shape[1]), dtype=torch.float32,
                    device=x.device)
    y.index_add_(0, dst.reshape(-1), g.reshape(-1, x.shape[1]))
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
        lib.spmm_packets_ablation.argtypes = [vp] * 4 + [ci] + [vp] * 3 + [ci] * 3 + [vp]
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
    xk = x.to(torch.bfloat16) if bf16 else x  # rounded once, not per edge
    gather_only = mode == ABLATIONS.index("gather_only")
    y = (torch.zeros if gather_only else torch.empty)(
        x.shape, dtype=out_dtype, device=x.device)
    out_bf16 = int(out_dtype == torch.bfloat16)
    if mode is None:
        return launch(_lib(), ("spmm_packets", "spmm_packets_reduce"), schedule(p),
                      p.w, xk, y, (int(bf16), out_bf16), (out_bf16,), LAUNCHES)
    return launch(_lib(), ("spmm_packets_ablation",
                           None if gather_only else "spmm_packets_reduce"),
                  schedule(p), p.w, xk, y, (mode,), (out_bf16,))


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
    if x.shape[1] % 4:
        raise ValueError("the ablations take bf16 compute, an f32 output and "
                         "D % 4 == 0")
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
