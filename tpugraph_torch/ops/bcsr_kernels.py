"""Port of ``tpugraph/ops/pallas_spmm.py``: block-sparse SpMM (B1, B3) and
SDDMM (B2) and their autograd wrappers.

* :func:`spmm_bcsr` — ``y = A @ x`` over BCSR tiles; replaces the Pallas
  kernel ``spmm_bcsr`` (``tpugraph/ops/pallas_spmm.py:98``).
* :func:`spmm_bcsr_packed` — the same product on a layout padded to
  ``k_pack`` tiles per row block; replaces ``spmm_bcsr_packed``
  (``tpugraph/ops/pallas_spmm.py:312``).
* :func:`sddmm_bcsr` — ``out[t] = (dy_row @ x_col^T) * (tiles[t] != 0)``;
  replaces ``sddmm_bcsr`` (``tpugraph/ops/pallas_spmm.py:175``).

On a CUDA tensor each wrapper launches its hand-written kernel from
``tpugraph_torch/csrc/bcsr_kernels.cu`` (IEEE float32 FMA, no TF32) or
raises; the kernels are built by :mod:`tpugraph_torch.ops._build`.  On a
CPU tensor the wrapper runs the plain PyTorch version beside it, which
walks the same ``row_ptr``/``col_blk``/``row_of`` structure with
``torch.bmm`` over tiles and ``index_add_`` over row blocks.  ``LAUNCHES``
counts kernel launches (never plain-version calls).

Only float32 tiles, x and output are ported; the bf16/int8 tile and
``out_dtype`` variants of B1 and B3 are not.  ``D`` may be any width: the
TPU's lane padding of D to 128 is not needed here.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional

import torch

from tpugraph_torch.ops._build import check_tensor, library, raise_on, stream
from tpugraph_torch.ops.bcsr import BCSR

_TILE_MULTIPLE = 64  # the kernels' CTA slice of a tile (BM = BN = 64)

LAUNCHES: Dict[str, int] = {"spmm_bcsr": 0, "sddmm_bcsr": 0,
                            "spmm_bcsr_packed": 0}
_bound = False


def _lib():
    global _bound
    lib = library("bcsr_kernels")
    if not _bound:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.spmm_bcsr_f32.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
        lib.spmm_bcsr_f32.restype = ci
        lib.sddmm_bcsr_f32.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
        lib.sddmm_bcsr_f32.restype = ci
        lib.spmm_bcsr_packed_f32.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci,
                                             ci, vp]
        lib.spmm_bcsr_packed_f32.restype = ci
        _bound = True
    return lib


def _check_layout(m: BCSR, device) -> None:
    check_tensor("tiles", m.tiles, torch.float32, 3, device)
    check_tensor("col_blk", m.col_blk, torch.int32, 1, device)
    check_tensor("row_ptr", m.row_ptr, torch.int32, 1, device)
    check_tensor("row_of", m.row_of, torch.int32, 1, device)
    b = m.block
    if tuple(m.tiles.shape[1:]) != (b, b) or b % _TILE_MULTIPLE:
        raise ValueError(f"tiles must be [T, B, B] with B % {_TILE_MULTIPLE} "
                         f"== 0, got {tuple(m.tiles.shape)}")
    if m.col_blk.shape[0] != m.num_tiles or m.row_of.shape[0] != m.num_tiles:
        raise ValueError("col_blk / row_of must have one entry per tile")


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
    check_tensor("x", x, torch.float32, 2, x.device)
    n, d = x.shape
    if n != m.num_nodes or d == 0:
        raise ValueError(f"x must be [{m.num_nodes}, D>0], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return spmm_bcsr_plain(m, x)
    if x.device.type != "cuda":
        raise ValueError(f"no spmm_bcsr kernel for device {x.device}")
    lib = _lib()
    y = torch.empty((m.num_row_nodes, d), dtype=torch.float32, device=x.device)
    if m.num_row_blocks == 0:
        return y
    with torch.cuda.device(x.device):
        err = lib.spmm_bcsr_f32(
            m.tiles.data_ptr(), m.col_blk.data_ptr(), m.row_ptr.data_ptr(),
            x.data_ptr(), y.data_ptr(), m.num_row_blocks, m.block, d,
            stream(x.device))
    raise_on(err, "spmm_bcsr")
    LAUNCHES["spmm_bcsr"] += 1
    return y


# ------------------------------------------------------------ B3 packed SpMM


def spmm_bcsr_packed_plain(m: BCSR, x: torch.Tensor, k_pack: int) -> torch.Tensor:
    """Plain PyTorch ``A @ x`` over the ``k_pack``-padded layout: each row
    block's tiles, ``k_pack`` at a time, ``bmm`` with their x blocks and
    summed into the row block; dead tiles add zeros."""
    b, d = m.block, x.shape[1]
    n_rb = m.num_row_blocks
    groups = m.tiles.reshape(-1, k_pack, b, b)
    xb = x.reshape(-1, b, d)[m.col_blk.long()].reshape(-1, k_pack, b, d)
    prod = torch.matmul(groups, xb).sum(dim=1)  # [T / k_pack, B, D]
    rows = m.row_of.long()[::k_pack]
    y = torch.zeros((n_rb, b, d), dtype=x.dtype, device=x.device)
    y.index_add_(0, rows, prod)
    return y.reshape(n_rb * b, d)


def spmm_bcsr_packed(m: BCSR, x: torch.Tensor, k_pack: int = 4) -> torch.Tensor:
    """``y[num_row_nodes, D] = A @ x`` with every row block of ``m`` holding
    a multiple of ``k_pack`` tiles (``bcsr_from_coo(pad_rows_to=k_pack)``;
    ``tpugraph/ops/pallas_spmm.py:312``, float32 output)."""
    _check_layout(m, x.device)
    check_tensor("x", x, torch.float32, 2, x.device)
    n, d = x.shape
    if n != m.num_nodes or d == 0:
        raise ValueError(f"x must be [{m.num_nodes}, D>0], got {tuple(x.shape)}")
    if k_pack < 1 or m.num_tiles % k_pack:
        raise ValueError(f"pad tiles per row to a multiple of k_pack={k_pack}")
    if x.device.type == "cpu":
        return spmm_bcsr_packed_plain(m, x, k_pack)
    if x.device.type != "cuda":
        raise ValueError(f"no spmm_bcsr_packed kernel for device {x.device}")
    lib = _lib()
    y = torch.empty((m.num_row_nodes, d), dtype=torch.float32, device=x.device)
    if m.num_row_blocks == 0:
        return y
    with torch.cuda.device(x.device):
        err = lib.spmm_bcsr_packed_f32(
            m.tiles.data_ptr(), m.col_blk.data_ptr(), m.row_ptr.data_ptr(),
            x.data_ptr(), y.data_ptr(), m.num_row_blocks, m.block, d, k_pack,
            stream(x.device))
    raise_on(err, "spmm_bcsr_packed")
    LAUNCHES["spmm_bcsr_packed"] += 1
    return y


def _spmm_any(m: BCSR, x: torch.Tensor, k_pack: int) -> torch.Tensor:
    if k_pack > 1:
        return spmm_bcsr_packed(m, x, k_pack)
    return spmm_bcsr(m, x)


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
    check_tensor("x", x, torch.float32, 2, x.device)
    check_tensor("dy", dy, torch.float32, 2, x.device)
    n, d = x.shape
    if n != m.num_nodes or d == 0 or tuple(dy.shape) != (m.num_row_nodes, d):
        raise ValueError(
            f"need x [{m.num_nodes}, D>0] and dy [{m.num_row_nodes}, D], got "
            f"{tuple(x.shape)} and {tuple(dy.shape)}")
    if x.device.type == "cpu":
        return sddmm_bcsr_plain(m, dy, x)
    if x.device.type != "cuda":
        raise ValueError(f"no sddmm_bcsr kernel for device {x.device}")
    lib = _lib()
    out = torch.empty_like(m.tiles)
    if m.num_tiles == 0:
        return out
    with torch.cuda.device(x.device):
        err = lib.sddmm_bcsr_f32(
            m.tiles.data_ptr(), m.row_of.data_ptr(), m.col_blk.data_ptr(),
            dy.data_ptr(), x.data_ptr(), out.data_ptr(), m.num_tiles, m.block,
            d, stream(x.device))
    raise_on(err, "sddmm_bcsr")
    LAUNCHES["sddmm_bcsr"] += 1
    return out


# ------------------------------------------------------- autograd wrappers


class BCSRMatvec(torch.autograd.Function):
    """Static-weight ``A @ x``: forward on ``m``, backward
    ``dx = A^T g`` on ``m_t``, both through B3 when ``k_pack > 1`` and B1
    otherwise (``tpugraph/ops/pallas_spmm.py:381-434``)."""

    @staticmethod
    def forward(ctx, x, m, m_t, k_pack):
        ctx.m_t, ctx.k_pack = m_t, k_pack
        return _spmm_any(m, x, k_pack)

    @staticmethod
    def backward(ctx, g):
        return _spmm_any(ctx.m_t, g.contiguous(), ctx.k_pack), None, None, None


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


def bcsr_matvec(m: BCSR, m_t: BCSR, x: torch.Tensor,
                k_pack: Optional[int] = None) -> torch.Tensor:
    """Differentiable ``A @ x`` with static weights (gradient to ``x``);
    ``k_pack > 1`` needs ``m`` and ``m_t`` padded to that multiple."""
    return BCSRMatvec.apply(x, m, m_t, k_pack or 0)


def bcsr_matvec_dw_pair(m: BCSR, m_t: BCSR, x: torch.Tensor) -> torch.Tensor:
    """Differentiable ``A @ x`` in both ``m.tiles`` and ``x``; ``m_t`` holds
    the tiles of A's transpose and gets no gradient."""
    return BCSRMatvecDWPair.apply(m.tiles, x, m, m_t)
