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
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from tpugraph_torch.ops._build import check_tensor, library, raise_on, stream
from tpugraph_torch.ops.packets import EdgePackets

_SLICE = 32                   # columns of D per CTA (csrc DS)
_SMEM_LIMIT = 232_448         # bytes of shared memory a block may use (H100)

LAUNCHES: Dict[str, int] = {"spmm_packets": 0}
_bound = False


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
    d = x.shape[1]
    w = p.w
    if compute_dtype == torch.bfloat16:
        x = x.to(torch.bfloat16).float()
        w = w.to(torch.bfloat16).float()
    src = p.col_blk.long()[:, None] * p.block_c + p.cols.long()
    dst = p.row_of.long()[:, None] * p.block_r + p.rows.long()
    g = w[:, :, None] * x[src]  # [P, K, D]
    if compute_dtype == torch.bfloat16:
        g = g.to(torch.bfloat16).float()
    y = torch.zeros((p.num_nodes, d), dtype=torch.float32, device=x.device)
    y.index_add_(0, dst.reshape(-1), g.reshape(-1, d))
    return y.to(out_dtype or torch.float32)


def _lib():
    global _bound
    lib = library("packets_kernels")
    if not _bound:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.spmm_packets.argtypes = [vp] * 7 + [ci] * 7 + [vp]
        lib.spmm_packets.restype = ci
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


def spmm_packets(p: EdgePackets, x: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None,
                 compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``y[num_nodes, D] = A @ x`` with ``x [num_nodes, D]`` float32, ``y``
    at ``out_dtype`` (float32 or bfloat16;
    ``tpugraph/ops/pallas_packets.py:146``)."""
    _check_layout(p, x.device)
    check_tensor("x", x, torch.float32, 2, x.device)
    n, d = x.shape
    if n != p.num_nodes or d == 0:
        raise ValueError(f"x must be [{p.num_nodes}, D>0], got {tuple(x.shape)}")
    out_dtype = out_dtype or torch.float32
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    cd = _compute_dtype(compute_dtype, x.device)
    if x.device.type == "cpu":
        return spmm_packets_plain(p, x, out_dtype, cd)
    if x.device.type != "cuda":
        raise ValueError(f"no spmm_packets kernel for device {x.device}")
    if p.block_r * _SLICE * 4 > _SMEM_LIMIT:
        raise ValueError(f"block_r {p.block_r} too large: the kernel keeps "
                         f"block_r x {_SLICE} float32 in shared memory")
    lib = _lib()
    y = torch.empty((n, d), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.spmm_packets(
            p.rows.data_ptr(), p.cols.data_ptr(), p.w.data_ptr(),
            p.col_blk.data_ptr(), p.row_ptr.data_ptr(), x.data_ptr(),
            y.data_ptr(), int(cd == torch.bfloat16),
            int(out_dtype == torch.bfloat16), p.num_row_blocks, p.k,
            p.block_r, p.block_c, d, stream(x.device))
    raise_on(err, "spmm_packets")
    LAUNCHES["spmm_packets"] += 1
    return y


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
