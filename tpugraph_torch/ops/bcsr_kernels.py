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
raises; the kernels are built by :mod:`tpugraph_torch.ops._build`.  B1
and B3 launch one support-driven kernel (B3 on its padded layout).  On a
CPU tensor the wrapper runs the plain PyTorch version beside it, which
walks the same ``row_ptr``/``col_blk``/``row_of`` structure with
``torch.bmm`` over tiles and ``index_add_`` over row blocks; any block
size runs there, while the kernels need ``B % 64 == 0``.  ``LAUNCHES``
counts kernel launches (never plain-version calls).

Tiles may be float32, bfloat16 or int8, ``x`` float32 or bfloat16 and
the output float32 or bfloat16 (``out_dtype``), with JAX's conversion
rule (``pallas_spmm.py:55-61``): int8 tiles widen exactly and compute as
bf16, ``x`` is cast to the tile compute type (rounded to bf16 for bf16 or
int8 tiles, widened for f32 tiles), sums are f32 and a bf16 output is
rounded once.  ``D`` may be any width: the TPU's lane padding of D to 128
is not needed here.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, Optional

import torch

from tpugraph_torch.ops._build import check_tensor, library, raise_on, stream
from tpugraph_torch.ops.bcsr import BCSR, BCSRTranspose, transposed_bcsr

_TILE_MULTIPLE = 64  # the kernels' CTA slice of a tile (64 tile rows)
_STRIP_ROWS = 8      # tile rows of a warp's strip in B1/B3
_STRIP_BYTES = 256   # bytes of a strip row (all of a tile row if shorter)
TILE_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_FLOATS = (torch.float32, torch.bfloat16)

LAUNCHES: Dict[str, int] = {"spmm_bcsr": 0, "sddmm_bcsr": 0,
                            "spmm_bcsr_packed": 0}
_bound = False


def sddmm_crossover(d: int) -> int:
    """Nonzeros of a 64x64 sub-tile up to which B2 takes its sparse branch
    (one dot product a nonzero) instead of the dense sub-tile product, at
    width ``d``: the line through the crossovers that ``chip_smoke.py``
    measured on an H100 (494 at D = 20, 882 at D = 128)."""
    return int(422 + 3.6 * d)


def strip_k(tile_dtype: torch.dtype, block: int) -> int:
    """Tile columns (k) of one B1/B3 strip: the largest of 256, 128 and 64
    bytes that divides a tile row (256 bytes are 64 f32, 128 bf16 or 256
    int8 entries), so a tile row of any card block (``B % 64 == 0``) is
    whole strips; the whole row where none divides it (CPU blocks)."""
    isz = torch.empty((), dtype=tile_dtype).element_size()
    for nbytes in (_STRIP_BYTES, _STRIP_BYTES // 2, _STRIP_BYTES // 4):
        if block * isz % nbytes == 0:
            return nbytes // isz
    return block


def spmm_crossover(d: int, tile_dtype: torch.dtype = torch.float32,
                   block: int = 256) -> int:
    """Nonzeros of a B1/B3 strip (8 tile rows x :func:`strip_k` columns)
    above which the kernel multiplies the strip as a dense block instead of
    walking its nonzeros, at width ``d`` (the columns of D a CTA owns, at
    most 128): the line through the crossovers ``chip_smoke.py`` measured
    on an H100, as a share of the strip's entries (49% at D = 20, 39% at
    D = 128 for f32 tiles, 37% for int8 tiles at D = 128)."""
    share = 0.51 - 0.001 * min(d, 128)
    return int(share * _STRIP_ROWS * strip_k(tile_dtype, block))


def strip_nnz(m: BCSR) -> torch.Tensor:
    """Nonzeros of every B1/B3 strip, ``[T, B / 8, B / strip_k]`` (tile,
    strip row, strip column), on ``m``'s device: the count each warp's
    branch test sees."""
    b, kw = m.block, strip_k(m.tiles.dtype, m.block)
    nz = (m.tiles != 0).reshape(m.num_tiles, b // _STRIP_ROWS, _STRIP_ROWS,
                                b // kw, kw)
    return nz.sum((2, 4), dtype=torch.int32)


def branch_shares(m: BCSR, d: int, crossover: Optional[int] = None) -> Dict[str, float]:
    """Share of B1/B3's strips that are empty, sparse and dense at width
    ``d`` (``crossover`` default :func:`spmm_crossover`)."""
    c = strip_nnz(m)
    if crossover is None:
        crossover = spmm_crossover(min(d, 128), m.tiles.dtype, m.block)
    n = max(c.numel(), 1)
    empty = int((c == 0).sum())
    dense = int(((c > crossover) & (c > 0)).sum())
    return {"empty": empty / n, "sparse": (c.numel() - empty - dense) / n,
            "dense": dense / n}


def cluster_size(longest: int, mean: float, slabs: int, sms: int) -> int:
    """CTAs of B1/B3 that share one slab's tile list (1 or 8).  Eight where
    a row block's list is over twice the mean (a hub, which one CTA would
    walk alone as a tail) or where the grid would hold fewer than two slabs
    an SM; one otherwise, which saves the cluster's exchange of partial
    slabs."""
    return 8 if longest > 2 * mean or slabs < 2 * sms else 1


def _cluster_of(m: BCSR, d: int, device) -> int:
    """:func:`cluster_size` for ``m`` at width ``d`` on ``device``.  The
    longest row-block list is ``m.longest_list``, counted by the packer on
    the host; a BCSR built without it has it read from the card (one
    synchronisation a call)."""
    longest = m.longest_list
    if longest is None:
        longest = int((m.row_ptr[1:] - m.row_ptr[:-1]).max())
    slabs = m.num_row_blocks * (m.block // _TILE_MULTIPLE) * -(-d // 128)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return cluster_size(longest, m.num_tiles / m.num_row_blocks, slabs, sms)


def x_operand(x: torch.Tensor, tile_dtype: torch.dtype) -> torch.Tensor:
    """``x`` as it enters a product with tiles of ``tile_dtype``, as f32:
    rounded to bf16 unless the tiles are f32 (the plain versions' half of
    the conversion rule)."""
    if tile_dtype == torch.float32:
        return x.float()
    return x.to(torch.bfloat16).float()


def check_float(name: str, t: torch.Tensor, ndim: int, device) -> None:
    """``t`` is a float32 or bfloat16 tensor of this rank on ``device``."""
    if t.dtype not in _FLOATS:
        raise ValueError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    check_tensor(name, t, t.dtype, ndim, device)


def out_dtype_of(out_dtype: Optional[torch.dtype]) -> torch.dtype:
    out_dtype = out_dtype or torch.float32
    if out_dtype not in _FLOATS:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    return out_dtype


def _lib():
    global _bound
    lib = library("bcsr_kernels")
    if not _bound:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.spmm_bcsr.argtypes = [vp, ci, vp, vp, vp, ci, vp, ci, ci, ci, ci, ci,
                                  ci, vp]
        lib.spmm_bcsr.restype = ci
        lib.sddmm_bcsr.argtypes = [vp, ci, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
        lib.sddmm_bcsr.restype = ci
        _bound = True
    return lib


def _check_layout(m: BCSR, device) -> None:
    if m.tiles.dtype not in TILE_KIND:
        raise ValueError(f"tiles must be one of {tuple(TILE_KIND)}, got "
                         f"{m.tiles.dtype}")
    check_tensor("tiles", m.tiles, m.tiles.dtype, 3, device)
    check_tensor("col_blk", m.col_blk, torch.int32, 1, device)
    check_tensor("row_ptr", m.row_ptr, torch.int32, 1, device)
    check_tensor("row_of", m.row_of, torch.int32, 1, device)
    b = m.block
    if tuple(m.tiles.shape[1:]) != (b, b):
        raise ValueError(f"tiles must be [T, B, B], got {tuple(m.tiles.shape)}")
    # the card's limit only: the plain versions take any B, as tpugraph's
    # interpret path does
    if torch.device(device).type == "cuda" and b % _TILE_MULTIPLE:
        raise ValueError(f"the kernels need B % {_TILE_MULTIPLE} == 0 on the "
                         f"card, got B = {b}")
    if m.col_blk.shape[0] != m.num_tiles or m.row_of.shape[0] != m.num_tiles:
        raise ValueError("col_blk / row_of must have one entry per tile")


def _check_spmm(m: BCSR, x: torch.Tensor, out_dtype) -> torch.dtype:
    _check_layout(m, x.device)
    check_float("x", x, 2, x.device)
    n, d = x.shape
    if n != m.num_nodes or d == 0:
        raise ValueError(f"x must be [{m.num_nodes}, D>0], got {tuple(x.shape)}")
    return out_dtype_of(out_dtype)


# ---------------------------------------------------------------- B1 SpMM


def spmm_bcsr_plain(m: BCSR, x: torch.Tensor,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch ``A @ x``: per-tile ``bmm`` of the widened tiles with
    the x block of ``col_blk[t]`` (cast as the kernel casts it), summed
    into row blocks taken from ``row_ptr``, one final cast."""
    b, d = m.block, x.shape[1]
    n_rb = m.num_row_blocks
    counts = (m.row_ptr[1:] - m.row_ptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(n_rb, device=x.device), counts)
    xb = x_operand(x, m.tiles.dtype).reshape(-1, b, d)[m.col_blk.long()]
    prod = torch.bmm(m.tiles.float(), xb)[: rows.numel()]
    y = torch.zeros((n_rb, b, d), dtype=torch.float32, device=x.device)
    y.index_add_(0, rows, prod)
    return y.reshape(n_rb * b, d).to(out_dtype or torch.float32)


def spmm_bcsr_support_plain(m: BCSR, x: torch.Tensor,
                            out_dtype: Optional[torch.dtype] = None
                            ) -> torch.Tensor:
    """Plain PyTorch ``A @ x`` in the kernel's order: the nonzeros of the
    tiles gathered in (row block, tile, row, ascending k) order, each
    times its x row (cast as the kernel casts it), and one ``index_add_``
    into f32 rows, one final cast.  Dead tiles and zero entries add
    nothing."""
    b, d = m.block, x.shape[1]
    t, i, k = (m.tiles != 0).nonzero(as_tuple=True)
    rows = m.row_of.long()[t] * b + i
    cols = m.col_blk.long()[t] * b + k
    prod = m.tiles[t, i, k].float()[:, None] * x_operand(x, m.tiles.dtype)[cols]
    y = torch.zeros((m.num_row_nodes, d), dtype=torch.float32, device=x.device)
    y.index_add_(0, rows, prod)
    return y.to(out_dtype or torch.float32)


def spmm_bcsr(m: BCSR, x: torch.Tensor,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``y[num_row_nodes, D] = A @ x`` with ``x [num_nodes, D]`` float32 or
    bfloat16, ``y`` at ``out_dtype`` (default float32;
    ``tpugraph/ops/pallas_spmm.py:98``)."""
    out_dtype = _check_spmm(m, x, out_dtype)
    if x.device.type == "cpu":
        return spmm_bcsr_plain(m, x, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no spmm_bcsr kernel for device {x.device}")
    return _spmm_launch(m, x, out_dtype, None, "spmm_bcsr")


def _spmm_launch(m: BCSR, x: torch.Tensor, out_dtype: torch.dtype,
                 crossover: Optional[int], key: Optional[str],
                 cluster: Optional[int] = None) -> torch.Tensor:
    """Launch the B1/B3 kernel (``crossover`` None: the measured
    :func:`spmm_crossover`; ``cluster`` None: :func:`cluster_size`),
    counting it under ``key`` (None: uncounted)."""
    d = x.shape[1]
    y = torch.empty((m.num_row_nodes, d), dtype=out_dtype, device=x.device)
    if m.num_row_blocks == 0:
        return y
    if m.tiles.data_ptr() % 16:
        raise ValueError("tiles must be 16-byte aligned (the kernel copies them "
                         "in 16-byte pieces)")
    if crossover is None:
        crossover = spmm_crossover(min(d, 128), m.tiles.dtype, m.block)
    if m.tiles.dtype != torch.float32:
        # the kernel's x operand for bf16/int8 tiles, rounded once a call (as
        # x_operand does): half the bytes of an f32 x, no rounding a load
        x = x.to(torch.bfloat16)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.spmm_bcsr(
            m.tiles.data_ptr(), TILE_KIND[m.tiles.dtype], m.col_blk.data_ptr(),
            m.row_ptr.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16),
            y.data_ptr(), int(out_dtype == torch.bfloat16), m.num_row_blocks,
            m.block, d, crossover,
            _cluster_of(m, d, x.device) if cluster is None else cluster,
            stream(x.device))
    raise_on(err, key or "spmm_bcsr")
    if key is not None:
        LAUNCHES[key] += 1
    return y


def _spmm_bcsr_crossover(m: BCSR, x: torch.Tensor, crossover: int,
                         k_pack: int = 0, cluster: Optional[int] = None
                         ) -> torch.Tensor:
    """B1 (or B3 on a ``k_pack``-padded layout) with its branch threshold
    forced: nonzeros of a strip above which the dense branch runs (-1:
    every nonempty strip dense; 2048 or more: every strip sparse), to
    measure the crossover; ``cluster`` (1, 2, 4 or 8) forces the CTAs that
    share a slab.  Card only; no launch is counted."""
    out_dtype = _check_spmm(m, x, None)
    if k_pack > 1:
        _check_k_pack(m, k_pack)
    if x.device.type != "cuda":
        raise ValueError("the forced-branch B1/B3 runs on a CUDA device only")
    return _spmm_launch(m, x, out_dtype, crossover, None, cluster)


# ------------------------------------------------------------ B3 packed SpMM


def spmm_bcsr_packed_plain(m: BCSR, x: torch.Tensor, k_pack: int,
                           out_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """Plain PyTorch ``A @ x`` over the ``k_pack``-padded layout: each row
    block's tiles, ``k_pack`` at a time, ``bmm`` with their x blocks and
    summed into the row block; dead tiles add zeros."""
    b, d = m.block, x.shape[1]
    n_rb = m.num_row_blocks
    groups = m.tiles.float().reshape(-1, k_pack, b, b)
    xb = x_operand(x, m.tiles.dtype).reshape(-1, b, d)[m.col_blk.long()]
    prod = torch.matmul(groups, xb.reshape(-1, k_pack, b, d)).sum(dim=1)
    rows = m.row_of.long()[::k_pack]
    y = torch.zeros((n_rb, b, d), dtype=torch.float32, device=x.device)
    y.index_add_(0, rows, prod)
    return y.reshape(n_rb * b, d).to(out_dtype or torch.float32)


def spmm_bcsr_packed(m: BCSR, x: torch.Tensor, k_pack: int = 4,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``y[num_row_nodes, D] = A @ x`` with every row block of ``m`` holding
    a multiple of ``k_pack`` tiles (``bcsr_from_coo(pad_rows_to=k_pack)``;
    ``tpugraph/ops/pallas_spmm.py:312``); dtypes as :func:`spmm_bcsr`.  On
    the card it launches B1's kernel on the padded layout (the dead tiles
    add nothing), counted under its own key."""
    out_dtype = _check_spmm(m, x, out_dtype)
    _check_k_pack(m, k_pack)
    if x.device.type == "cpu":
        return spmm_bcsr_packed_plain(m, x, k_pack, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no spmm_bcsr_packed kernel for device {x.device}")
    return _spmm_launch(m, x, out_dtype, None, "spmm_bcsr_packed")


def _check_k_pack(m: BCSR, k_pack: int) -> None:
    if k_pack < 1 or m.num_tiles % k_pack:
        raise ValueError(f"pad tiles per row to a multiple of k_pack={k_pack}")


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


def sddmm_bcsr_support_plain(m: BCSR, dy: torch.Tensor,
                             x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch B2 as the kernel's sparse branch computes it: the
    nonzeros of the tiles gathered, one dot of ``dy[row]`` and ``x[col]``
    each, +0.0 everywhere else."""
    t, i, j = (m.tiles != 0).nonzero(as_tuple=True)
    rows = m.row_of.long()[t] * m.block + i
    cols = m.col_blk.long()[t] * m.block + j
    out = torch.zeros(m.tiles.shape, dtype=torch.float32, device=x.device)
    out[t, i, j] = (dy[rows] * x[cols]).sum(1)
    return out


def _check_sddmm(m: BCSR, dy: torch.Tensor, x: torch.Tensor) -> None:
    _check_layout(m, x.device)
    check_tensor("x", x, torch.float32, 2, x.device)
    check_tensor("dy", dy, torch.float32, 2, x.device)
    n, d = x.shape
    if n != m.num_nodes or d == 0 or tuple(dy.shape) != (m.num_row_nodes, d):
        raise ValueError(
            f"need x [{m.num_nodes}, D>0] and dy [{m.num_row_nodes}, D], got "
            f"{tuple(x.shape)} and {tuple(dy.shape)}")


def sddmm_bcsr(m: BCSR, dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-tile gradient ``float32[T, B, B]``; ``dy`` spans the row nodes,
    ``x`` the column nodes, both float32; the tiles (of any dtype) give
    only their support (``tpugraph/ops/pallas_spmm.py:175``).  The kernel
    writes +0.0 off the support (JAX: ``prod * 0``, -0.0 or NaN there for
    a negative or non-finite product)."""
    _check_sddmm(m, dy, x)
    if x.device.type == "cpu":
        return sddmm_bcsr_plain(m, dy, x)
    if x.device.type != "cuda":
        raise ValueError(f"no sddmm_bcsr kernel for device {x.device}")
    return _sddmm_launch(m, dy, x, None)


def _sddmm_bcsr_crossover(m: BCSR, dy: torch.Tensor, x: torch.Tensor,
                          crossover: int) -> torch.Tensor:
    """B2 with its branch threshold forced (nonzeros of a 64x64 sub-tile up
    to which the sparse branch runs; -1 always dense, 4096 always sparse),
    to measure the crossover.  Card only; no launch is counted."""
    _check_sddmm(m, dy, x)
    if x.device.type != "cuda":
        raise ValueError("the forced-branch B2 runs on a CUDA device only")
    return _sddmm_launch(m, dy, x, crossover)


def _sddmm_launch(m: BCSR, dy: torch.Tensor, x: torch.Tensor,
                  crossover: Optional[int]) -> torch.Tensor:
    out = torch.empty(m.tiles.shape, dtype=torch.float32, device=x.device)
    if m.num_tiles == 0:
        return out
    if m.tiles.data_ptr() % 16:
        raise ValueError("tiles must be 16-byte aligned (the kernel reads the "
                         "support with 16-byte loads)")
    lib = _lib()
    args = (m.tiles.data_ptr(), TILE_KIND[m.tiles.dtype], m.row_of.data_ptr(),
            m.col_blk.data_ptr(), dy.data_ptr(), x.data_ptr(), out.data_ptr(),
            m.num_tiles, m.block, x.shape[1])
    with torch.cuda.device(x.device):
        err = lib.sddmm_bcsr(*args, sddmm_crossover(x.shape[1]) if crossover is None
                             else crossover, stream(x.device))
    raise_on(err, "sddmm_bcsr")
    if crossover is None:
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
    ``dtiles = B2(m, g, x)`` (``tpugraph/ops/pallas_spmm.py:511``).

    ``spmm_dtype`` casts the tiles for B1 and B2 inside the forward, as
    ``tpugraph``'s explainer casts ``w_run`` (``tpugraph/explain/
    bcsr_explain.py:215``).  The float32 tiles stay the autograd input:
    torch rounds a gradient to its input's dtype, and JAX hands the f32
    tile cotangent through unrounded."""

    @staticmethod
    def forward(ctx, tiles, x, m, m_t, spmm_dtype):
        run = tiles if spmm_dtype is None else tiles.to(spmm_dtype)
        m = dataclasses.replace(m, tiles=run)
        ctx.save_for_backward(run, x)
        ctx.m, ctx.m_t = m, m_t
        return spmm_bcsr(m, x)

    @staticmethod
    def backward(ctx, g):
        run, x = ctx.saved_tensors
        g = g.contiguous()
        dtiles = dx = None
        if ctx.needs_input_grad[0]:
            dtiles = sddmm_bcsr(dataclasses.replace(ctx.m, tiles=run), g, x)
        if ctx.needs_input_grad[1]:
            dx = spmm_bcsr(ctx.m_t, g)
        return dtiles, dx, None, None, None


_transposed = transposed_bcsr  # the BCSR of A^T the backward passes run


class BCSRMatvecDW(torch.autograd.Function):
    """``A @ x`` differentiable in the tile values and ``x``, with ``A^T``'s
    tiles built in the backward from the transpose plan ``tp``: forward
    B1(``m``), backward ``dx`` = B1 on ``transposed_bcsr(m.tiles, tp)``
    and ``dtiles`` = B2(``m``, g, x) (``tpugraph/ops/pallas_spmm.py:457``).
    The GAT layer's aggregation over score-scaled tiles, which change
    every step."""

    @staticmethod
    def forward(ctx, tiles, x, m, tp):
        m = dataclasses.replace(m, tiles=tiles)
        ctx.save_for_backward(tiles, x)
        ctx.m, ctx.tp = m, tp
        return spmm_bcsr(m, x)

    @staticmethod
    def backward(ctx, g):
        tiles, x = ctx.saved_tensors
        g = g.contiguous()
        dtiles = dx = None
        if ctx.needs_input_grad[0]:
            dtiles = sddmm_bcsr(dataclasses.replace(ctx.m, tiles=tiles), g, x)
        if ctx.needs_input_grad[1]:
            dx = spmm_bcsr(_transposed(tiles, ctx.tp), g)
        return dtiles, dx, None, None


class SDDMMDW(torch.autograd.Function):
    """Per-tile ``(a_row b_col^T) * [tiles != 0]``, differentiable in ``a``
    and ``b`` (``tpugraph/ops/pallas_spmm.py:546``): forward B2, backward
    with ``gs = g * [tiles != 0]`` as tile values, ``da`` = B1 on ``gs``
    and ``db`` = B1 on ``transposed_bcsr(gs, tp)``.  The tiles give only
    their support, so no gradient reaches them."""

    @staticmethod
    def forward(ctx, a, b, m, tp):
        ctx.save_for_backward(a, b)
        ctx.m, ctx.tp = m, tp
        return sddmm_bcsr(m, a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        m = ctx.m
        gs = g * (m.tiles != 0)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = spmm_bcsr(dataclasses.replace(m, tiles=gs), b)
        if ctx.needs_input_grad[1]:
            db = spmm_bcsr(_transposed(gs, ctx.tp), a)
        return da, db, None, None


def bcsr_matvec(m: BCSR, m_t: BCSR, x: torch.Tensor,
                k_pack: Optional[int] = None) -> torch.Tensor:
    """Differentiable ``A @ x`` with static weights (gradient to ``x``);
    ``k_pack > 1`` needs ``m`` and ``m_t`` padded to that multiple."""
    return BCSRMatvec.apply(x, m, m_t, k_pack or 0)


def make_bcsr_matvec(m: BCSR, m_t: BCSR, k_pack: Optional[int] = None
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``x -> bcsr_matvec(m, m_t, x, k_pack)``, a closure over one matrix
    and its transpose (``tpugraph/ops/pallas_spmm.py:437``)."""

    def matvec(x: torch.Tensor) -> torch.Tensor:
        return bcsr_matvec(m, m_t, x, k_pack=k_pack)

    return matvec


def bcsr_matvec_dw_pair(m: BCSR, m_t: BCSR, x: torch.Tensor,
                        spmm_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """Differentiable ``A @ x`` in both ``m.tiles`` and ``x``; ``m_t`` holds
    the tiles of A's transpose and gets no gradient.  ``spmm_dtype``
    (e.g. ``torch.bfloat16``) is the dtype the kernels read ``m.tiles``
    at; the gradient to ``m.tiles`` keeps their dtype."""
    return BCSRMatvecDWPair.apply(m.tiles, x, m, m_t, spmm_dtype)


def bcsr_matvec_dw(m: BCSR, tp: BCSRTranspose, x: torch.Tensor) -> torch.Tensor:
    """Differentiable ``A @ x`` in both ``m.tiles`` (float32) and ``x``, the
    transposed tiles rebuilt from ``tp`` in the backward."""
    return BCSRMatvecDW.apply(m.tiles, x, m, tp)


def sddmm_dw(m: BCSR, tp: BCSRTranspose, a: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """Differentiable ``(a_row b_col^T) * [tiles != 0]`` per tile, float32
    ``[T, B, B]``: the GAT scores on the tile support."""
    return SDDMMDW.apply(a, b, m, tp)
