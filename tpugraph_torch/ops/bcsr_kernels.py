"""Port of ``tpugraph/ops/pallas_spmm.py``: block-sparse SpMM (B1) and
SDDMM (B2) and their autograd wrappers.

* :func:`spmm_bcsr` — ``y = A @ x`` over BCSR tiles; replaces the Pallas
  kernel ``spmm_bcsr`` (``tpugraph/ops/pallas_spmm.py:98``).
* :func:`sddmm_bcsr` — ``out[t] = (dy_row @ x_col^T) * (tiles[t] != 0)``;
  replaces ``sddmm_bcsr`` (``tpugraph/ops/pallas_spmm.py:175``).

On a CUDA tensor each wrapper launches its hand-written kernel from
``tpugraph_torch/csrc/bcsr_kernels.cu`` (IEEE float32 FMA, no TF32) or
raises; the kernels are built with ``nvcc`` for ``sm_90a`` into
``build/tpugraph_torch/`` at first use and loaded with ``ctypes``.  On a
CPU tensor the wrapper runs the plain PyTorch version beside it, which
walks the same ``row_ptr``/``col_blk``/``row_of`` structure with
``torch.bmm`` over tiles and ``index_add_`` over row blocks.  ``LAUNCHES``
counts kernel launches (never plain-version calls).

Only float32 tiles, x and output are ported; the bf16/int8 tile and
``out_dtype`` variants of B1 are not.  ``D`` may be any width: the
TPU's lane padding of D to 128 is not needed here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from tpugraph_torch.ops.bcsr import BCSR

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "bcsr_kernels.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpugraph_torch"
_TILE_MULTIPLE = 64  # the kernels' CTA slice of a tile (BM = BN = 64)

LAUNCHES: Dict[str, int] = {"spmm_bcsr": 0, "sddmm_bcsr": 0}
_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_kernels() -> float:
    """Build (if needed) and load the kernel library; returns the seconds
    spent.  The library name carries a hash of the source, so an edited
    source is rebuilt."""
    global _lib
    if _lib is not None:
        return 0.0
    t0 = time.perf_counter()
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    so = _BUILD_DIR / f"libbcsr_kernels_{digest}.so"
    if not so.is_file():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", str(tmp), str(_SRC)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.spmm_bcsr_f32.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.spmm_bcsr_f32.restype = ci
    lib.sddmm_bcsr_f32.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.sddmm_bcsr_f32.restype = ci
    _lib = lib
    return time.perf_counter() - t0


def _check(name: str, t: torch.Tensor, dtype, ndim: int, device) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {dtype} with {ndim} dims, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _check_layout(m: BCSR, device) -> None:
    _check("tiles", m.tiles, torch.float32, 3, device)
    _check("col_blk", m.col_blk, torch.int32, 1, device)
    _check("row_ptr", m.row_ptr, torch.int32, 1, device)
    _check("row_of", m.row_of, torch.int32, 1, device)
    b = m.block
    if tuple(m.tiles.shape[1:]) != (b, b) or b % _TILE_MULTIPLE:
        raise ValueError(f"tiles must be [T, B, B] with B % {_TILE_MULTIPLE} "
                         f"== 0, got {tuple(m.tiles.shape)}")
    if m.col_blk.shape[0] != m.num_tiles or m.row_of.shape[0] != m.num_tiles:
        raise ValueError("col_blk / row_of must have one entry per tile")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


# ---------------------------------------------------------------- B1 SpMM


def spmm_bcsr_plain(m: BCSR, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``A @ x``: per-tile ``bmm`` with the x block of
    ``col_blk[t]``, summed into row blocks taken from ``row_ptr``."""
    b, d = m.block, x.shape[1]
    n_rb = m.num_row_blocks
    counts = (m.row_ptr[1:] - m.row_ptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(n_rb, device=x.device), counts)
    xb = x.reshape(-1, b, d)[m.col_blk.long()]
    prod = torch.bmm(m.tiles, xb)[: rows.numel()]
    y = torch.zeros((n_rb, b, d), dtype=x.dtype, device=x.device)
    y.index_add_(0, rows, prod)
    return y.reshape(n_rb * b, d)


def spmm_bcsr(m: BCSR, x: torch.Tensor) -> torch.Tensor:
    """``y[num_row_nodes, D] = A @ x`` with ``x [num_nodes, D]`` float32
    (``tpugraph/ops/pallas_spmm.py:98``, float32 output)."""
    _check_layout(m, x.device)
    _check("x", x, torch.float32, 2, x.device)
    n, d = x.shape
    if n != m.num_nodes or d == 0:
        raise ValueError(f"x must be [{m.num_nodes}, D>0], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return spmm_bcsr_plain(m, x)
    if x.device.type != "cuda":
        raise ValueError(f"no spmm_bcsr kernel for device {x.device}")
    build_kernels()
    y = torch.empty((m.num_row_nodes, d), dtype=torch.float32, device=x.device)
    if m.num_row_blocks == 0:
        return y
    with torch.cuda.device(x.device):
        err = _lib.spmm_bcsr_f32(
            m.tiles.data_ptr(), m.col_blk.data_ptr(), m.row_ptr.data_ptr(),
            x.data_ptr(), y.data_ptr(), m.num_row_blocks, m.block, d,
            _stream(x.device))
    _raise_on(err, "spmm_bcsr")
    LAUNCHES["spmm_bcsr"] += 1
    return y


# --------------------------------------------------------------- B2 SDDMM


def sddmm_bcsr_plain(m: BCSR, dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch per-tile ``(dy_row @ x_col^T) * (tiles != 0)``."""
    b, d = m.block, x.shape[1]
    dyb = dy.reshape(-1, b, d)[m.row_of.long()]
    xb = x.reshape(-1, b, d)[m.col_blk.long()]
    return torch.bmm(dyb, xb.transpose(1, 2)) * (m.tiles != 0)


def sddmm_bcsr(m: BCSR, dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-tile gradient ``float32[T, B, B]``; ``dy`` spans the row nodes,
    ``x`` the column nodes (``tpugraph/ops/pallas_spmm.py:175``)."""
    _check_layout(m, x.device)
    _check("x", x, torch.float32, 2, x.device)
    _check("dy", dy, torch.float32, 2, x.device)
    n, d = x.shape
    if n != m.num_nodes or d == 0 or tuple(dy.shape) != (m.num_row_nodes, d):
        raise ValueError(
            f"need x [{m.num_nodes}, D>0] and dy [{m.num_row_nodes}, D], got "
            f"{tuple(x.shape)} and {tuple(dy.shape)}")
    if x.device.type == "cpu":
        return sddmm_bcsr_plain(m, dy, x)
    if x.device.type != "cuda":
        raise ValueError(f"no sddmm_bcsr kernel for device {x.device}")
    build_kernels()
    out = torch.empty_like(m.tiles)
    if m.num_tiles == 0:
        return out
    with torch.cuda.device(x.device):
        err = _lib.sddmm_bcsr_f32(
            m.tiles.data_ptr(), m.row_of.data_ptr(), m.col_blk.data_ptr(),
            dy.data_ptr(), x.data_ptr(), out.data_ptr(), m.num_tiles, m.block,
            d, _stream(x.device))
    _raise_on(err, "sddmm_bcsr")
    LAUNCHES["sddmm_bcsr"] += 1
    return out


# ------------------------------------------------------- autograd wrappers


class BCSRMatvec(torch.autograd.Function):
    """Static-weight ``A @ x``: forward B1 on ``m``, backward
    ``dx = B1(m_t, g)`` (``tpugraph/ops/pallas_spmm.py:387``)."""

    @staticmethod
    def forward(ctx, x, m, m_t):
        ctx.m_t = m_t
        return spmm_bcsr(m, x)

    @staticmethod
    def backward(ctx, g):
        return spmm_bcsr(ctx.m_t, g.contiguous()), None, None


class BCSRMatvecDWPair(torch.autograd.Function):
    """``A @ x`` differentiable in the tile values and ``x``, with the
    transposed tiles ``m_t`` supplied by the caller and treated as a
    constant: forward B1(``m``), backward ``dx = B1(m_t, g)`` and
    ``dtiles = B2(m, g, x)`` (``tpugraph/ops/pallas_spmm.py:511``)."""

    @staticmethod
    def forward(ctx, tiles, x, m, m_t):
        m = dataclasses.replace(m, tiles=tiles)
        ctx.save_for_backward(tiles, x)
        ctx.m, ctx.m_t = m, m_t
        return spmm_bcsr(m, x)

    @staticmethod
    def backward(ctx, g):
        tiles, x = ctx.saved_tensors
        g = g.contiguous()
        dtiles = dx = None
        if ctx.needs_input_grad[0]:
            dtiles = sddmm_bcsr(dataclasses.replace(ctx.m, tiles=tiles), g, x)
        if ctx.needs_input_grad[1]:
            dx = spmm_bcsr(ctx.m_t, g)
        return dtiles, dx, None, None


def bcsr_matvec(m: BCSR, m_t: BCSR, x: torch.Tensor) -> torch.Tensor:
    """Differentiable ``A @ x`` with static weights (gradient to ``x``)."""
    return BCSRMatvec.apply(x, m, m_t)


def bcsr_matvec_dw_pair(m: BCSR, m_t: BCSR, x: torch.Tensor) -> torch.Tensor:
    """Differentiable ``A @ x`` in both ``m.tiles`` and ``x``; ``m_t`` holds
    the tiles of A's transpose and gets no gradient."""
    return BCSRMatvecDWPair.apply(m.tiles, x, m, m_t)
