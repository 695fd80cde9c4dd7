"""Port of ``tpugraph/ops/pallas_resident.py``: the column-stacked layout
and its SpMM (B4) with the autograd wrapper, and the pair layout with the
fused pair (B5) and power (B6) propagation kernels.

* :class:`BCSRStacked`, :func:`stack_bcsr`, :func:`pack_stacked_int4` and
  :func:`tile_window_bytes_for` — host-side layout, byte-identical to
  ``tpugraph``'s (``:62``, ``:122``, ``:102``, ``:723``).
* :func:`spmm_stacked_resident` — ``y = A @ x`` over the stacks; replaces
  the Pallas kernel ``spmm_stacked_resident`` (``:281``).
* :class:`StackedMatvec` — ``A @ x`` with ``dx = A^T g`` through the same
  kernel on the transposed stacks (``:747-794``).
* :class:`BCSRPair` and :func:`pack_pair` — A's and A_t's stack=1 tiles
  back to back (``:355``, ``:395``).
* :func:`spmm_pair_resident` — ``A_t @ bf16(A @ x)``; replaces
  ``spmm_pair_resident`` (``:476``).
* :func:`spmm_power_resident` — ``(hop_scale * A_t A)^hops @ x`` with bf16
  at every phase and hop boundary; replaces ``spmm_power_resident``
  (``:622``).
* :func:`_spmm_stacked_ablation` — B4 (int8 tiles) in a diagnostic mode,
  the counterpart of ``bench_resident_diag2.py:105 run_variant``.

On a CUDA tensor each kernel wrapper launches the hand-written kernels of
``tpugraph_torch/csrc/resident_kernels.cu`` or raises; on a CPU tensor it
runs its ``_plain`` twin, which walks the same tiles/``col_blk``/``rows``
structure with ``bmm`` and ``index_add_`` and repeats every rounding.

The TPU kernels keep x and the output resident in VMEM, which the H100
has no counterpart for; the VMEM budget (``resident_fits``) is therefore
not ported.  The CUDA kernels instead own output row blocks, so each
layout carries a row-block-major inverse index (``row_ptr``/``slots``)
derived once from ``rows``.  Tiles are a torch tensor (bfloat16 needs
one); the index arrays are numpy on the host and tensors on a device.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from tpugraph_torch.ops._build import check_tensor, library, raise_on, stream
from tpugraph_torch.ops.bcsr import BCSR, _host, _to
from tpugraph_torch.ops.bcsr_kernels import (TILE_KIND, check_float,
                                             out_dtype_of, x_operand)

Array = Union[np.ndarray, torch.Tensor]
_TILE_MULTIPLE = 64  # the f32 kernel's CTA slice of a tile (64 rows)
_MMA_MULTIPLE = 128  # the tensor-core kernel's (bf16/int8/int4 tiles: 128 rows)
ABLATIONS = ("full", "dmaonly", "nodot", "noconvert")

LAUNCHES: Dict[str, int] = {"spmm_stacked_resident": 0,
                            "spmm_pair_resident": 0,
                            "spmm_power_resident": 0}
_bound = False


def _as_tensor(a: Array) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a


def _row_index(rows: Array, n_row_blocks: int):
    """``(row_ptr, slots)``: the flat ``t*stack + s`` entries grouped by
    the row block they add into, in entry order within a row block."""
    r = _as_tensor(rows).long()
    if r.numel() and (int(r.min()) < 0 or int(r.max()) >= n_row_blocks):
        raise ValueError(f"rows must lie in [0, {n_row_blocks})")
    slots = torch.argsort(r, stable=True).to(torch.int32)
    row_ptr = torch.zeros(n_row_blocks + 1, dtype=torch.int32, device=r.device)
    row_ptr[1:] = torch.cumsum(torch.bincount(r, minlength=n_row_blocks), 0)
    return row_ptr, slots


@dataclasses.dataclass
class BCSRStacked:
    """Column-stacked BCSR (``tpugraph/ops/pallas_resident.py:63``):
    ``tiles[i]`` holds ``stack`` vertically stacked ``[B, B]`` tiles that
    all read column block ``col_blk[i]``; slice ``s`` adds into row block
    ``rows[i*stack + s]``.  ``row_ptr``/``slots`` are the inverse index
    the CUDA kernel walks; they are derived from ``rows`` when omitted."""

    tiles: Array          # [T, stack*B, B] f32/bf16/int8, or int8 [T, stack*B, B//2] packed4
    col_blk: Array        # int32[T]
    rows: Array           # int32[T*stack]
    num_nodes: int        # padded column count (rows of x)
    num_row_nodes: int    # padded row count (rows of y)
    block: int
    stack: int
    packed4: bool = False
    row_ptr: Optional[Array] = None  # int32[R+1] over slots
    slots: Optional[Array] = None    # int32[T*stack]

    def __post_init__(self):
        if self.row_ptr is None or self.slots is None:
            self.row_ptr, self.slots = _row_index(self.rows,
                                                  self.num_row_blocks)

    @property
    def num_tiles(self) -> int:
        return self.tiles.shape[0]

    @property
    def num_row_blocks(self) -> int:
        return self.num_row_nodes // self.block

    def to(self, device) -> "BCSRStacked":
        return dataclasses.replace(
            self, tiles=_to(self.tiles, device),
            col_blk=_to(self.col_blk, device), rows=_to(self.rows, device),
            row_ptr=_to(self.row_ptr, device), slots=_to(self.slots, device))


def pack_stacked_int4(st: BCSRStacked) -> BCSRStacked:
    """Nibble-pack a stacked layout whose tile values are integers in
    [0, 15] (``tpugraph/ops/pallas_resident.py:102``): byte ``(r, c)``
    holds column ``c`` (low nibble) and column ``c + B/2`` (high)."""
    tiles = _as_tensor(st.tiles)
    if tiles.dtype != torch.int8:
        tiles = torch.round(tiles.float()).to(torch.int8)
    u = tiles.view(torch.uint8)
    if bool((u > 15).any()):  # negatives view as >127
        raise ValueError("int4 packing needs integer weights in [0, 15]")
    h = st.block // 2
    packed = (u[:, :, :h] | (u[:, :, h:] << 4)).view(torch.int8)
    return dataclasses.replace(st, tiles=packed, packed4=True)


def stack_bcsr(m: BCSR, stack: int = 2, k_pack: int = 4) -> BCSRStacked:
    """Host-side regrouping of a BCSR into the column-stacked layout
    (``tpugraph/ops/pallas_resident.py:122``).

    ``stack == 1`` keeps the packer's order, drops the all-zero dead
    tiles among the column-block-0 candidates and pads the count to a
    multiple of ``k_pack``.  ``stack > 1`` drops every all-zero tile,
    sorts by (column block, row block), groups equal columns into
    ``stack``-high stacks (an odd remainder's empty lanes repeat lane 0's
    row and add zero) and pads the stack count to ``k_pack``."""
    tiles = _as_tensor(m.tiles)
    row = _host(m.row_of)
    col = _host(m.col_blk)
    b = m.block
    meta = dict(num_nodes=m.num_nodes, num_row_nodes=m.num_row_nodes, block=b)

    if stack == 1:
        cand = np.flatnonzero(col == 0)
        keep = None
        if cand.size:
            cand_live = (tiles[torch.from_numpy(cand)] != 0).flatten(1).any(1)
            cand_live = cand_live.numpy()
            if not cand_live.all():
                live_mask = np.ones(tiles.shape[0], bool)
                live_mask[cand[~cand_live]] = False
                keep = np.flatnonzero(live_mask)
        t = tiles.shape[0] if keep is None else len(keep)
        t2p = ((t + k_pack - 1) // k_pack) * k_pack
        if keep is not None or t2p != t:
            new_tiles = torch.zeros((t2p,) + tuple(tiles.shape[1:]),
                                    dtype=tiles.dtype)
            if keep is None:
                new_tiles[:t] = tiles
            else:
                torch.index_select(tiles, 0, torch.from_numpy(keep),
                                   out=new_tiles[:t])
                col = col[keep]
                row = row[keep]
            tiles = new_tiles
            col = np.concatenate([col, np.zeros(t2p - t, np.int32)])
            row = np.concatenate([row, np.zeros(t2p - t, np.int32)])
        return BCSRStacked(tiles=tiles, col_blk=col.astype(np.int32),
                           rows=row.astype(np.int32), stack=1, **meta)

    live = np.flatnonzero((tiles != 0).flatten(1).any(1).numpy())
    tiles, row, col = tiles[torch.from_numpy(live)], row[live], col[live]
    order = np.lexsort((row, col))
    tiles, row, col = tiles[torch.from_numpy(order)], row[order], col[order]
    t = len(row)

    if t == 0:
        return BCSRStacked(
            tiles=torch.zeros((k_pack, stack * b, b), dtype=tiles.dtype),
            col_blk=np.zeros((k_pack,), np.int32),
            rows=np.zeros((k_pack * stack,), np.int32), stack=stack, **meta)

    grp_start = np.r_[0, np.flatnonzero(np.diff(col)) + 1]
    sizes = np.diff(np.r_[grp_start, t])
    pos = np.arange(t) - np.repeat(grp_start, sizes)
    n_stacks = (sizes + stack - 1) // stack
    stack_base = np.r_[0, np.cumsum(n_stacks)]
    dst = np.repeat(stack_base[:-1], sizes) + pos // stack
    lane = pos % stack
    t2 = int(n_stacks.sum())
    t2p = ((t2 + k_pack - 1) // k_pack) * k_pack

    st_tiles = torch.zeros((t2p, stack, b, b), dtype=tiles.dtype)
    st_tiles[torch.from_numpy(dst), torch.from_numpy(lane)] = tiles
    del tiles
    st_tiles = st_tiles.reshape(t2p, stack * b, b)

    col2 = np.zeros((t2p,), np.int32)
    col2[dst] = col
    rows2 = np.zeros((t2p, stack), np.int32)
    first = lane == 0
    rows2[dst[first], 0] = row[first]
    for s in range(1, stack):
        rows2[:, s] = rows2[:, 0]
        sel = lane == s
        rows2[dst[sel], s] = row[sel]
    return BCSRStacked(tiles=st_tiles, col_blk=col2, rows=rows2.reshape(-1),
                       stack=stack, **meta)


def tile_window_bytes_for(k_pack: int, stack: int, block: int,
                          tile_itemsize: int = 1,
                          packed4: bool = False) -> int:
    """Bytes of ``2 * k_pack`` stacks of tiles (two windows of ``k_pack``
    stacks; ``tpugraph/ops/pallas_resident.py:723``)."""
    cols = block // 2 if packed4 else block
    return 2 * k_pack * stack * block * cols * tile_itemsize


# ----------------------------------------------------------------- B4 SpMM


def widen_tiles(m: BCSRStacked) -> torch.Tensor:
    """The tile values as float32 ``[T, stack*B, B]`` (int4 unpacked)."""
    t = _as_tensor(m.tiles)
    if m.packed4:
        v = t.view(torch.uint8)
        return torch.cat([v & 0xF, v >> 4], dim=2).float()
    return t.float()


def spmm_stacked_resident_plain(m: BCSRStacked, x: torch.Tensor,
                                out_dtype: Optional[torch.dtype] = None
                                ) -> torch.Tensor:
    """Plain PyTorch ``A @ x``: ``bmm`` of every widened stack with its x
    block (x rounded to bf16 unless the tiles are f32), slices summed
    into their row blocks with ``index_add_``, one final cast."""
    b, d = m.block, x.shape[1]
    xb = x_operand(x, m.tiles.dtype).reshape(-1, b, d)[m.col_blk.long()]
    prod = torch.bmm(widen_tiles(m), xb).reshape(-1, b, d)
    y = torch.zeros((m.num_row_blocks, b, d), dtype=torch.float32,
                    device=x.device)
    y.index_add_(0, m.rows.long(), prod)
    return y.reshape(m.num_row_nodes, d).to(out_dtype or torch.float32)


def _lib():
    global _bound
    lib = library("resident_kernels")
    if not _bound:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        cf = ctypes.c_float
        lib.spmm_stacked_resident.argtypes = [vp, ci, vp, vp, vp, vp, ci, vp,
                                              ci, ci, ci, ci, ci, vp]
        lib.spmm_pair_resident.argtypes = [vp, ci, vp, vp, vp, vp, vp, vp, ci,
                                           vp, vp, ci, ci, ci, ci, ci, vp]
        lib.spmm_power_resident.argtypes = [vp, ci, vp, vp, vp, vp, vp, vp, ci,
                                            vp, vp, vp, ci, ci, cf, ci, ci, ci,
                                            ci, vp]
        lib.spmm_stacked_ablation.argtypes = [vp] * 6 + [ci] * 5 + [vp]
        for fn in (lib.spmm_stacked_resident, lib.spmm_pair_resident,
                   lib.spmm_power_resident, lib.spmm_stacked_ablation):
            fn.restype = ci
        _bound = True
    return lib


def _check_layout(m: BCSRStacked, device) -> None:
    kinds = (torch.int8,) if m.packed4 else tuple(TILE_KIND)
    if m.tiles.dtype not in kinds:
        raise ValueError(f"tiles must be one of {kinds}, got {m.tiles.dtype}")
    check_tensor("tiles", m.tiles, m.tiles.dtype, 3, device)
    for name in ("col_blk", "rows", "row_ptr", "slots"):
        check_tensor(name, getattr(m, name), torch.int32, 1, device)
    b, t = m.block, m.num_tiles
    cols = b // 2 if m.packed4 else b
    if (tuple(m.tiles.shape[1:]) != (m.stack * b, cols)
            or m.num_row_nodes % b or m.num_nodes % b):
        raise ValueError(
            f"tiles must be [T, stack*B, {'B/2' if m.packed4 else 'B'}], got "
            f"{tuple(m.tiles.shape)}")
    # the card's limit only: the plain version on the CPU takes any B, as
    # tpugraph's interpret path does
    if torch.device(device).type == "cuda" and b % _TILE_MULTIPLE:
        raise ValueError(f"the kernels need B % {_TILE_MULTIPLE} == 0 on the "
                         f"card, got B = {b}")
    if (m.col_blk.shape[0] != t or m.rows.shape[0] != t * m.stack
            or m.slots.shape[0] != t * m.stack
            or m.row_ptr.shape[0] != m.num_row_blocks + 1):
        raise ValueError("col_blk / rows / row_ptr / slots do not match the tiles")
    _check_mma_block(m.tiles.dtype, b, device)


def _kernel_x(x: torch.Tensor, tile_dtype) -> torch.Tensor:
    """x as the phase kernel takes it: as given for f32 tiles; bf16 for
    the others (an f32 x rounded once a call, nearest even, as
    ``x_operand`` does: the kernel stages half the bytes)."""
    return x if tile_dtype == torch.float32 else x.to(torch.bfloat16)


def _check_mma_block(tile_dtype, b: int, device) -> None:
    """The tensor-core kernel (every tile type but f32) owns 128 tile rows
    a CTA."""
    if (torch.device(device).type == "cuda" and tile_dtype != torch.float32
            and b % _MMA_MULTIPLE):
        raise ValueError(f"the tensor-core kernel needs B % {_MMA_MULTIPLE} == 0 "
                         f"for {tile_dtype} tiles, got B = {b}")


def spmm_stacked_resident(m: BCSRStacked, x: torch.Tensor,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """``y[num_row_nodes, D] = A @ x`` over the stacks, ``x [num_nodes, D]``
    float32 or bfloat16, ``y`` at ``out_dtype`` (float32 or bfloat16;
    ``tpugraph/ops/pallas_resident.py:281``)."""
    _check_layout(m, x.device)
    check_float("x", x, 2, x.device)
    n, d = x.shape
    if n != m.num_nodes or d == 0:
        raise ValueError(f"x must be [{m.num_nodes}, D>0], got {tuple(x.shape)}")
    out_dtype = out_dtype_of(out_dtype)
    if x.device.type == "cpu":
        return spmm_stacked_resident_plain(m, x, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no spmm_stacked_resident kernel for device {x.device}")
    lib = _lib()
    y = torch.empty((m.num_row_nodes, d), dtype=out_dtype, device=x.device)
    if m.num_row_blocks == 0:
        return y
    kind = 3 if m.packed4 else TILE_KIND[m.tiles.dtype]
    x = _kernel_x(x, m.tiles.dtype)
    with torch.cuda.device(x.device):
        err = lib.spmm_stacked_resident(
            m.tiles.data_ptr(), kind, m.col_blk.data_ptr(),
            m.row_ptr.data_ptr(), m.slots.data_ptr(), x.data_ptr(),
            int(x.dtype == torch.bfloat16), y.data_ptr(),
            int(out_dtype == torch.bfloat16), m.num_row_blocks, m.block,
            m.stack, d, stream(x.device))
    raise_on(err, "spmm_stacked_resident")
    LAUNCHES["spmm_stacked_resident"] += 1
    return y


def _spmm_stacked_ablation(m: BCSRStacked, x: torch.Tensor,
                           mode: str) -> torch.Tensor:
    """B4's tensor-core phase (int8 tiles, f32 output) in one of its
    diagnostic modes, the counterpart of ``bench_resident_diag2.py:105
    run_variant``: ``full`` (B4 itself); ``dmaonly`` (the tile strips stream
    in, no x, no MMA; zeros plus a token are written); ``nodot`` (tile strips
    and x stream in, no MMA); ``noconvert`` (the same bytes
    and MMAs without the int8 -> bf16 widening; the values are not B4's).
    The TPU modes ``fixedrow``, ``storeonly`` and ``sorted`` time the
    read-modify-write of a shared accumulator, which row ownership does not
    have.  CUDA only; x float32 (rounded to bf16 as B4 rounds it) or
    bfloat16 with 16-byte rows; no launch is counted."""
    if mode not in ABLATIONS:
        raise ValueError(f"mode must be one of {ABLATIONS}, got {mode!r}")
    _check_layout(m, x.device)
    check_float("x", x, 2, x.device)
    if x.device.type != "cuda":
        raise ValueError("the B4 ablations run on a CUDA device only")
    n, d = x.shape
    x = _kernel_x(x, m.tiles.dtype)
    if (m.packed4 or m.tiles.dtype != torch.int8 or n != m.num_nodes
            or d % 8 or x.data_ptr() % 16):
        raise ValueError("the ablations take int8 tiles and an x of "
                         f"[{m.num_nodes}, D % 8 == 0], 16-byte aligned")
    y = torch.empty((m.num_row_nodes, d), dtype=torch.float32, device=x.device)
    if m.num_row_blocks == 0:
        return y
    with torch.cuda.device(x.device):
        err = _lib().spmm_stacked_ablation(
            m.tiles.data_ptr(), m.col_blk.data_ptr(), m.row_ptr.data_ptr(),
            m.slots.data_ptr(), x.data_ptr(), y.data_ptr(), m.num_row_blocks,
            m.block, m.stack, d, ABLATIONS.index(mode), stream(x.device))
    raise_on(err, "spmm_stacked_ablation")
    return y


class StackedMatvec(torch.autograd.Function):
    """Static-weight ``A @ x`` on the stacks: forward B4 on ``st``,
    backward ``dx = B4(st_t, g)`` (``tpugraph/ops/pallas_resident.py:781-791``;
    x, g and dx are all float32 here).  With bf16/int8 tiles the backward
    rounds ``g`` to bf16 as the forward rounds ``x``."""

    @staticmethod
    def forward(ctx, x, st, st_t):
        ctx.st_t = st_t
        return spmm_stacked_resident(st, x)

    @staticmethod
    def backward(ctx, g):
        return spmm_stacked_resident(ctx.st_t, g.contiguous()), None, None


def stacked_matvec(st: BCSRStacked, st_t: BCSRStacked,
                   x: torch.Tensor) -> torch.Tensor:
    """Differentiable ``A @ x`` (gradient to ``x``); ``st_t`` holds the
    stacks of ``A^T``."""
    return StackedMatvec.apply(x, st, st_t)


# ------------------------------------------------------- B5 / B6 pair layout


def _cat(a: Array, b: Array) -> Array:
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return np.concatenate([a, b])
    return torch.cat([_as_tensor(a), _as_tensor(b)])


@dataclasses.dataclass
class BCSRPair:
    """Pair layout (``tpugraph/ops/pallas_resident.py:355``): A's ``t1``
    stack=1 tiles then A_t's, in one array, for ``A_t @ (A @ x)``.  A maps
    ``num_nodes`` columns to ``num_mid_nodes`` rows, A_t ``num_mid_nodes``
    to ``num_out_nodes``.  ``row_ptr1``/``slots1`` are the inverse index of
    A's half over its row blocks, ``row_ptr2``/``slots2`` that of A_t's half
    (slots offset by ``t1``): the lists the CUDA phases walk.  Build with
    :func:`pack_pair`."""

    tiles: Array         # [t1 + t2, B, B] f32/bf16/int8
    col_blk: Array       # int32[t1 + t2]
    rows: Array          # int32[t1 + t2]
    t1: int
    num_nodes: int
    num_mid_nodes: int
    num_out_nodes: int
    block: int
    row_ptr1: Array      # int32[num_mid_nodes / B + 1]
    slots1: Array        # int32[t1], in [0, t1)
    row_ptr2: Array      # int32[num_out_nodes / B + 1]
    slots2: Array        # int32[t2], in [t1, t1 + t2)

    @property
    def num_tiles(self) -> int:
        return self.tiles.shape[0]

    def to(self, device) -> "BCSRPair":
        return dataclasses.replace(self, **{
            f: _to(getattr(self, f), device)
            for f in ("tiles", "col_blk", "rows", "row_ptr1", "slots1",
                      "row_ptr2", "slots2")})


def pack_pair(st: BCSRStacked, st_t: BCSRStacked) -> BCSRPair:
    """Concatenate two stack=1 layouts, A then A_t, into a :class:`BCSRPair`
    (``tpugraph/ops/pallas_resident.py:395``), on the device they are on;
    the inverse indexes are the two layouts' own."""
    if st.stack != 1 or st_t.stack != 1:
        raise ValueError("pack_pair needs two stack=1 layouts")
    if st.packed4 or st_t.packed4:
        raise ValueError("pack_pair does not take int4-packed tiles")
    if st.block != st_t.block:
        raise ValueError(f"blocks differ: {st.block} and {st_t.block}")
    if st_t.num_nodes != st.num_row_nodes:
        raise ValueError("A_t columns must be A rows")
    return BCSRPair(
        tiles=_cat(st.tiles, st_t.tiles), col_blk=_cat(st.col_blk, st_t.col_blk),
        rows=_cat(st.rows, st_t.rows), t1=st.num_tiles, num_nodes=st.num_nodes,
        num_mid_nodes=st.num_row_nodes, num_out_nodes=st_t.num_row_nodes,
        block=st.block, row_ptr1=st.row_ptr, slots1=st.slots,
        row_ptr2=st_t.row_ptr, slots2=st_t.slots + st.num_tiles)


def _phase_plain(pair: BCSRPair, src: torch.Tensor, lo: int, hi: int,
                 n_rows: int) -> torch.Tensor:
    """f32 ``A_half @ src`` over tiles ``[lo, hi)`` of the pair into
    ``n_rows`` rows: ``bmm`` of the widened tiles with their src blocks
    (cast to the tile compute type), summed with ``index_add_``."""
    b, d = pair.block, src.shape[1]
    tiles = pair.tiles[lo:hi]
    xb = x_operand(src, tiles.dtype).reshape(-1, b, d)[pair.col_blk[lo:hi].long()]
    prod = torch.bmm(tiles.float(), xb)
    y = torch.zeros((n_rows // b, b, d), dtype=torch.float32, device=src.device)
    y.index_add_(0, pair.rows[lo:hi].long(), prod)
    return y.reshape(n_rows, d)


def spmm_pair_resident_plain(pair: BCSRPair, x: torch.Tensor,
                             out_dtype: torch.dtype = torch.bfloat16
                             ) -> torch.Tensor:
    """Plain PyTorch B5: phase 1 over A's tiles, ``y`` rounded to bf16,
    phase 2 over A_t's tiles, one cast to ``out_dtype``."""
    y = _phase_plain(pair, x, 0, pair.t1, pair.num_mid_nodes)
    return _phase_plain(pair, y.to(torch.bfloat16), pair.t1, pair.num_tiles,
                        pair.num_out_nodes).to(out_dtype)


def spmm_power_resident_plain(pair: BCSRPair, x: torch.Tensor, hops: int,
                              out_dtype: torch.dtype = torch.bfloat16,
                              hop_scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch B6: ``hops`` pairs, ``y`` rounded to bf16 at each phase
    boundary, each hop's f32 sum times ``hop_scale`` (in f32) rounded to
    bf16, the last one cast to ``out_dtype`` instead."""
    scale = float(np.float32(hop_scale))
    h = x
    for i in range(hops):
        y = _phase_plain(pair, h, 0, pair.t1, pair.num_mid_nodes)
        acc = _phase_plain(pair, y.to(torch.bfloat16), pair.t1, pair.num_tiles,
                           pair.num_out_nodes) * scale
        h = acc.to(out_dtype if i == hops - 1 else torch.bfloat16)
    return h


def _check_pair(pair: BCSRPair, x: torch.Tensor, k_pack: int,
                out_dtype) -> torch.dtype:
    device = x.device
    if pair.tiles.dtype not in TILE_KIND:
        raise ValueError(f"tiles must be one of {tuple(TILE_KIND)}, got "
                         f"{pair.tiles.dtype}")
    check_tensor("tiles", pair.tiles, pair.tiles.dtype, 3, device)
    for name in ("col_blk", "rows", "row_ptr1", "slots1", "row_ptr2", "slots2"):
        check_tensor(name, getattr(pair, name), torch.int32, 1, device)
    b, t, t1 = pair.block, pair.num_tiles, pair.t1
    sizes = (pair.num_nodes, pair.num_mid_nodes, pair.num_out_nodes)
    if (tuple(pair.tiles.shape[1:]) != (b, b) or min(sizes) <= 0
            or any(v % b for v in sizes)):
        raise ValueError(f"tiles must be [T, B, B] over node counts that are "
                         f"positive multiples of B, got {tuple(pair.tiles.shape)} "
                         f"and {sizes}")
    if (pair.col_blk.shape[0] != t or pair.rows.shape[0] != t
            or not 0 <= t1 <= t or pair.slots1.shape[0] != t1
            or pair.slots2.shape[0] != t - t1
            or pair.row_ptr1.shape[0] != pair.num_mid_nodes // b + 1
            or pair.row_ptr2.shape[0] != pair.num_out_nodes // b + 1):
        raise ValueError("col_blk / rows / row_ptr / slots do not match the tiles")
    if k_pack < 1 or t1 % k_pack or (t - t1) % k_pack:
        raise ValueError(f"both halves ({t1}, {t - t1} tiles) must be multiples "
                         f"of k_pack={k_pack}")
    check_float("x", x, 2, device)
    if x.shape[0] != pair.num_nodes or x.shape[1] == 0:
        raise ValueError(f"x must be [{pair.num_nodes}, D>0], got {tuple(x.shape)}")
    out_dtype = out_dtype_of(out_dtype)
    if device.type == "cuda" and b % _TILE_MULTIPLE:
        raise ValueError(f"the kernels need B % {_TILE_MULTIPLE} == 0, got {b}")
    _check_mma_block(pair.tiles.dtype, b, device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no pair kernels for device {device}")
    return out_dtype


def _pair_args(pair: BCSRPair, x: torch.Tensor) -> tuple:
    return (pair.tiles.data_ptr(), TILE_KIND[pair.tiles.dtype],
            pair.col_blk.data_ptr(), pair.row_ptr1.data_ptr(),
            pair.slots1.data_ptr(), pair.row_ptr2.data_ptr(),
            pair.slots2.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16))


def spmm_pair_resident(pair: BCSRPair, x: torch.Tensor, k_pack: int = 128,
                       out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``out[num_out_nodes, D] = A_t @ (A @ x)`` in one call, ``y = A @ x``
    rounded to bf16 once (``tpugraph/ops/pallas_resident.py:476``); ``x``
    float32 or bfloat16, ``out`` at ``out_dtype``.  ``k_pack`` is kept as
    the layout contract (both halves are multiples of it); the CUDA
    schedule does not use it.  Not differentiable."""
    out_dtype = _check_pair(pair, x, k_pack, out_dtype)
    if x.device.type == "cpu":
        return spmm_pair_resident_plain(pair, x, out_dtype)
    lib = _lib()
    x = _kernel_x(x, pair.tiles.dtype)
    d, b = x.shape[1], pair.block
    ybuf = torch.empty((pair.num_mid_nodes, d), dtype=torch.bfloat16,
                       device=x.device)
    out = torch.empty((pair.num_out_nodes, d), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.spmm_pair_resident(
            *_pair_args(pair, x), ybuf.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.bfloat16), pair.num_mid_nodes // b,
            pair.num_out_nodes // b, b, d, stream(x.device))
    raise_on(err, "spmm_pair_resident")
    LAUNCHES["spmm_pair_resident"] += 2  # one phase kernel per phase
    return out


def spmm_power_resident(pair: BCSRPair, x: torch.Tensor, hops: int,
                        k_pack: int = 128,
                        out_dtype: torch.dtype = torch.bfloat16,
                        hop_scale: float = 1.0) -> torch.Tensor:
    """``(hop_scale * A_t A)^hops @ x`` in one call
    (``tpugraph/ops/pallas_resident.py:622``): bf16 at every phase and hop
    boundary, ``hop_scale`` applied in f32 before each hop's rounding and
    to the output.  Needs a square pair (``num_out_nodes == num_nodes``);
    ``x`` float32 or bfloat16.  Not differentiable."""
    out_dtype = _check_pair(pair, x, k_pack, out_dtype)
    if int(hops) != hops or hops < 1:
        raise ValueError(f"hops must be a positive integer, got {hops}")
    if pair.num_out_nodes != pair.num_nodes:
        raise ValueError("power iteration needs a square pair")
    if x.device.type == "cpu":
        return spmm_power_resident_plain(pair, x, hops, out_dtype, hop_scale)
    lib = _lib()
    x = _kernel_x(x, pair.tiles.dtype)
    d, b = x.shape[1], pair.block
    mid = torch.empty((pair.num_mid_nodes, d), dtype=torch.bfloat16,
                      device=x.device)
    hop = torch.empty((pair.num_out_nodes, d), dtype=torch.bfloat16,
                      device=x.device)
    out = torch.empty((pair.num_out_nodes, d), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.spmm_power_resident(
            *_pair_args(pair, x), mid.data_ptr(), hop.data_ptr(),
            out.data_ptr(), int(out_dtype == torch.bfloat16), int(hops),
            float(hop_scale), pair.num_mid_nodes // b, pair.num_out_nodes // b,
            b, d, stream(x.device))
    raise_on(err, "spmm_power_resident")
    LAUNCHES["spmm_power_resident"] += 2 * int(hops)  # two phases a hop
    return out
