"""Port of ``tpugraph/ops/pallas_resident.py`` for the training path: the
column-stacked layout and its SpMM (B4), with the autograd wrapper.

* :class:`BCSRStacked`, :func:`stack_bcsr`, :func:`pack_stacked_int4` and
  :func:`tile_window_bytes_for` — host-side layout, byte-identical to
  ``tpugraph``'s (``:62``, ``:122``, ``:102``, ``:723``).
* :func:`spmm_stacked_resident` — ``y = A @ x`` over the stacks; replaces
  the Pallas kernel ``spmm_stacked_resident`` (``:281``).  On a CUDA
  tensor it launches the hand-written kernel of
  ``tpugraph_torch/csrc/resident_kernels.cu`` or raises; on a CPU tensor
  it runs :func:`spmm_stacked_resident_plain`.
* :class:`StackedMatvec` — ``A @ x`` with ``dx = A^T g`` through the same
  kernel on the transposed stacks (``:747-794``).

The TPU kernel keeps x and the output resident in VMEM, which the H100
has no counterpart for; the VMEM budget (``resident_fits``) is therefore
not ported.  The CUDA kernel instead owns output row blocks, so each
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

Array = Union[np.ndarray, torch.Tensor]
_TILE_MULTIPLE = 64  # the kernel's CTA slice of a tile (BM = BN = 64)
_TILE_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

LAUNCHES: Dict[str, int] = {"spmm_stacked_resident": 0}
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
    if m.tiles.dtype != torch.float32:
        x = x.to(torch.bfloat16).float()
    xb = x.reshape(-1, b, d)[m.col_blk.long()]
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
        lib.spmm_stacked_resident.argtypes = [vp, ci, vp, vp, vp, vp, vp, ci,
                                              ci, ci, ci, ci, vp]
        lib.spmm_stacked_resident.restype = ci
        _bound = True
    return lib


def _check_layout(m: BCSRStacked, device) -> None:
    kinds = (torch.int8,) if m.packed4 else tuple(_TILE_KIND)
    if m.tiles.dtype not in kinds:
        raise ValueError(f"tiles must be one of {kinds}, got {m.tiles.dtype}")
    check_tensor("tiles", m.tiles, m.tiles.dtype, 3, device)
    for name in ("col_blk", "rows", "row_ptr", "slots"):
        check_tensor(name, getattr(m, name), torch.int32, 1, device)
    b, t = m.block, m.num_tiles
    cols = b // 2 if m.packed4 else b
    if (tuple(m.tiles.shape[1:]) != (m.stack * b, cols) or b % _TILE_MULTIPLE
            or m.num_row_nodes % b or m.num_nodes % b):
        raise ValueError(
            f"tiles must be [T, stack*B, {'B/2' if m.packed4 else 'B'}] with "
            f"B % {_TILE_MULTIPLE} == 0, got {tuple(m.tiles.shape)}")
    if (m.col_blk.shape[0] != t or m.rows.shape[0] != t * m.stack
            or m.slots.shape[0] != t * m.stack
            or m.row_ptr.shape[0] != m.num_row_blocks + 1):
        raise ValueError("col_blk / rows / row_ptr / slots do not match the tiles")


def spmm_stacked_resident(m: BCSRStacked, x: torch.Tensor,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """``y[num_row_nodes, D] = A @ x`` over the stacks, ``x [num_nodes, D]``
    float32, ``y`` at ``out_dtype`` (float32 or bfloat16;
    ``tpugraph/ops/pallas_resident.py:281``)."""
    _check_layout(m, x.device)
    check_tensor("x", x, torch.float32, 2, x.device)
    n, d = x.shape
    if n != m.num_nodes or d == 0:
        raise ValueError(f"x must be [{m.num_nodes}, D>0], got {tuple(x.shape)}")
    out_dtype = out_dtype or torch.float32
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if x.device.type == "cpu":
        return spmm_stacked_resident_plain(m, x, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no spmm_stacked_resident kernel for device {x.device}")
    lib = _lib()
    y = torch.empty((m.num_row_nodes, d), dtype=out_dtype, device=x.device)
    if m.num_row_blocks == 0:
        return y
    kind = 3 if m.packed4 else _TILE_KIND[m.tiles.dtype]
    with torch.cuda.device(x.device):
        err = lib.spmm_stacked_resident(
            m.tiles.data_ptr(), kind, m.col_blk.data_ptr(),
            m.row_ptr.data_ptr(), m.slots.data_ptr(), x.data_ptr(),
            y.data_ptr(), int(out_dtype == torch.bfloat16), m.num_row_blocks,
            m.block, m.stack, d, stream(x.device))
    raise_on(err, "spmm_stacked_resident")
    LAUNCHES["spmm_stacked_resident"] += 1
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
