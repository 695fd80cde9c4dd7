"""Port of ``tpugraph/ops/bcsr.py``: the block-CSR layout the kernels walk.

A BCSR matrix (row = receiver, col = sender) stores dense tiles over its
nonempty ``B x B`` blocks:

  tiles    float32[T, B, B]  — dense tile values
  col_blk  int32[T]          — column block of each tile
  row_ptr  int32[R+1]        — CSR offsets over row blocks
  row_of   int32[T]          — row block of each tile

Tiles are sorted by (row block, column block), and every row block holds
at least one tile: an empty row block gets one all-zero dead tile at
column block 0 (``tpugraph/ops/bcsr.py:126-136``); with ``pad_rows_to=k``
every row block holds a multiple of ``k`` tiles.  Packing is host-side
numpy and gives arrays byte-identical to ``tpugraph``'s packer; tiles may
be float32, int8 (numpy) or bfloat16 (a torch tensor, since numpy has no
bfloat16), and the arrays move to a device with :meth:`BCSR.to`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]


def _to(a: Array, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
    return t.to(device).contiguous()


@dataclasses.dataclass
class BCSR:
    """Block-sparse matrix; arrays are numpy on the host or tensors on a
    device.  ``num_nodes`` is the padded COLUMN count (rows of ``x`` in
    ``A @ x``); the row count is ``num_row_blocks * block``, which differs
    for a rectangular matrix."""

    tiles: Array     # float32 / bfloat16 / int8 [T, B, B]
    col_blk: Array   # int32[T]
    row_ptr: Array   # int32[R+1]
    row_of: Array    # int32[T]
    num_nodes: int
    block: int
    # tiles of the longest row-block list, counted on the host by the packer
    # (the B1/B3 kernels' cluster choice); None where a BCSR was built without
    longest_list: Optional[int] = None

    @property
    def num_tiles(self) -> int:
        return self.tiles.shape[0]

    @property
    def num_row_blocks(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def num_row_nodes(self) -> int:
        return (self.row_ptr.shape[0] - 1) * self.block

    def to(self, device) -> "BCSR":
        return dataclasses.replace(
            self, tiles=_to(self.tiles, device), col_blk=_to(self.col_blk, device),
            row_ptr=_to(self.row_ptr, device), row_of=_to(self.row_of, device),
        )


def _pad_rows_layout(row_ptr: np.ndarray, row_of: np.ndarray,
                     col_blk: np.ndarray, k_pack: int = 1):
    """Layout that pads every row block's tile count to a multiple of
    ``k_pack`` and gives each empty row block ``k_pack`` dead tiles at
    column block 0 (``tpugraph/ops/bcsr.py:279``): returns
    ``(dst, new_col, new_row, new_ptr, t_new)``, ``dst[i]`` the new slot
    of existing tile ``i``."""
    n_blocks = len(row_ptr) - 1
    t_old = int(row_ptr[-1])
    counts = np.diff(row_ptr)
    new_counts = ((counts + k_pack - 1) // k_pack) * k_pack
    new_counts = np.where(new_counts == 0, k_pack, new_counts)
    t_new = int(new_counts.sum())
    new_ptr = np.zeros(n_blocks + 1, dtype=np.int32)
    new_ptr[1:] = np.cumsum(new_counts)
    ro = row_of[:t_old]
    dst = (new_ptr[ro] + (np.arange(t_old) - row_ptr[ro])).astype(np.int64)
    new_col = np.zeros(t_new, dtype=np.int32)
    new_col[dst] = col_blk[:t_old]
    new_row = np.repeat(np.arange(n_blocks, dtype=np.int32), new_counts)
    return dst, new_col, new_row, new_ptr, t_new


def _cast_values(v: np.ndarray, tile_dtype) -> Array:
    """float32 tile values at ``tile_dtype`` as ``tpugraph`` casts them
    (``tpugraph/ops/bcsr.py:121-125``): int8 is ``clip(rint(v))`` to
    [-127, 127]; bfloat16 rounds to nearest even and is returned as a
    torch tensor (numpy has no bfloat16)."""
    if tile_dtype is None or tile_dtype == torch.float32:
        return v
    if tile_dtype == torch.int8:
        return np.clip(np.rint(v), -127, 127).astype(np.int8)
    if tile_dtype == torch.bfloat16:
        return torch.from_numpy(v).to(torch.bfloat16)
    raise ValueError(f"tile_dtype must be float32, bfloat16 or int8, got "
                     f"{tile_dtype}")


def _zero_tiles(shape, tile_dtype) -> Array:
    if tile_dtype == torch.bfloat16:
        return torch.zeros(shape, dtype=torch.bfloat16)
    dt = np.int8 if tile_dtype == torch.int8 else np.float32
    return np.zeros(shape, dtype=dt)


def bcsr_from_coo(
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: np.ndarray,
    num_nodes: int,
    block: int = 128,
    *,
    num_col_nodes: Optional[int] = None,
    tile_dtype: Optional[torch.dtype] = None,
    pad_rows_to: Optional[int] = None,
) -> BCSR:
    """Host-side COO -> BCSR (``tpugraph/ops/bcsr.py:79`` with
    ``device=False``): entry (row=receiver, col=sender) = weight, duplicate
    edges summed in edge order, zero-weight (padding) edges dropped.
    ``num_col_nodes`` makes the matrix rectangular (senders in
    ``[0, num_col_nodes)``); default square.  Every argument after
    ``block`` is keyword-only: ``tpugraph``'s positional order there
    (``pad_tiles_to, tile_dtype, pad_rows_to, num_col_nodes``) differs.

    ``tile_dtype`` (``torch.float32``, ``torch.bfloat16`` or
    ``torch.int8``) casts the summed values; bfloat16 tiles are a torch
    tensor, the other arrays numpy.  ``pad_rows_to`` pads every row
    block's tile count to that multiple with dead tiles (zero values,
    column block 0), the layout of the packed kernel B3.

    Only the touched entries are summed (in float32, in edge order) and
    cast; the tile array is allocated once, at its final dtype and
    padded layout."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    weights = np.asarray(weights, dtype=np.float32)
    live = weights != 0
    s, r, w = senders[live], receivers[live], weights[live]

    n_pad_r = ((num_nodes + block - 1) // block) * block
    n_cols = num_col_nodes if num_col_nodes is not None else num_nodes
    n_pad_c = ((n_cols + block - 1) // block) * block
    n_rb = n_pad_r // block
    n_cb = n_pad_c // block

    keys = (r // block).astype(np.int64) * n_cb + s // block
    order = np.argsort(keys, kind="stable")
    s, r, w, keys = s[order], r[order], w[order], keys[order]
    uniq, tile_of_edge = np.unique(keys, return_inverse=True)
    t = len(uniq)
    t_pad = max(t, 1)
    col_blk = np.zeros((t_pad,), dtype=np.int32)
    row_of = np.full((t_pad,), n_rb - 1, dtype=np.int32)
    col_blk[:t] = uniq % n_cb
    row_of[:t] = uniq // n_cb

    row_ptr = np.zeros((n_rb + 1,), dtype=np.int32)
    counts = np.bincount(row_of[:t], minlength=n_rb)
    counts[n_rb - 1] += t_pad - t
    row_ptr[1:] = np.cumsum(counts)

    k = pad_rows_to or 1
    slot = np.arange(t_pad, dtype=np.int64)
    if k > 1 or np.any(counts == 0):
        slot, col_blk, row_of, row_ptr, t_pad = _pad_rows_layout(
            row_ptr, row_of, col_blk, k)
    # np.add.at applies edges in (stable-sorted) edge order — the same
    # per-entry summation order as tpugraph's per-tile loop and native
    # packer
    entry = ((slot[tile_of_edge] * block + r % block) * block
             + s % block).astype(np.int64)
    cells, cell_of_edge = np.unique(entry, return_inverse=True)
    sums = np.zeros(len(cells), dtype=np.float32)
    np.add.at(sums, cell_of_edge, w)
    tiles = _zero_tiles((t_pad, block, block), tile_dtype)
    vals = _cast_values(sums, tile_dtype)
    if isinstance(tiles, torch.Tensor):
        tiles.view(-1)[torch.from_numpy(cells)] = vals
    else:
        tiles.reshape(-1)[cells] = vals
    return BCSR(tiles=tiles, col_blk=col_blk, row_ptr=row_ptr, row_of=row_of,
                num_nodes=n_pad_c, block=block, longest_list=_longest(row_ptr))


def bcsr_transpose_host(
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: np.ndarray,
    num_nodes: int,
    block: int = 128,
    *,
    tile_dtype: Optional[torch.dtype] = None,
    pad_rows_to: Optional[int] = None,
) -> BCSR:
    """BCSR of A^T, for the backward ``dx = A^T @ g``
    (``tpugraph/ops/bcsr.py:259``); keyword-only after ``block``, as
    :func:`bcsr_from_coo`."""
    return bcsr_from_coo(receivers, senders, weights, num_nodes, block,
                         tile_dtype=tile_dtype, pad_rows_to=pad_rows_to)


def coo_tile_counts(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    block: int = 128,
    weights: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Per-row-block tile counts of the BCSR :func:`bcsr_from_coo` would
    build, without packing (``tpugraph/ops/bcsr.py:337``); ``weights``
    drops zero-weight padding edges as the packer does."""
    s = np.asarray(senders)
    r = np.asarray(receivers)
    if weights is not None:
        live = np.asarray(weights) != 0
        s, r = s[live], r[live]
    n_pad = ((num_nodes + block - 1) // block) * block
    n_blocks = n_pad // block
    keys = (r.astype(np.int64) // block) * n_blocks + s // block
    uniq = np.unique(keys)
    return np.bincount((uniq // n_blocks).astype(np.int64),
                       minlength=n_blocks)


def choose_k_pack_counts(cnt: np.ndarray, max_overhead: float = 1.2) -> int:
    """``k_pack`` for the packed kernel from per-row-block tile counts
    (``tpugraph/ops/bcsr.py:367``): the median nonzero count clipped to
    [1, 8], or 1 when padding every row to it would add more than
    ``max_overhead`` times the tiles."""
    cnt = np.asarray(cnt)
    pos = cnt[cnt > 0]
    if not pos.size:
        return 1
    kp = int(np.clip(np.median(pos), 1, 8))
    if kp < 2:
        return 1
    padded = int(np.where(cnt == 0, kp, ((cnt + kp - 1) // kp) * kp).sum())
    if padded > max_overhead * max(int(cnt.sum()), 1):
        return 1
    return kp


def choose_k_pack(m: BCSR, max_overhead: float = 1.2) -> int:
    """:func:`choose_k_pack_counts` on a packed BCSR's row-block counts
    (``tpugraph/ops/bcsr.py:383``)."""
    return choose_k_pack_counts(np.diff(np.asarray(m.row_ptr)), max_overhead)


def _longest(row_ptr: Array) -> int:
    """Tiles of the longest row-block list of a host ``row_ptr``."""
    counts = np.diff(_host(row_ptr))
    return int(counts.max()) if counts.size else 0


def _host(a: Array) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def bcsr_pad_rows(m: BCSR, k_pack: int) -> BCSR:
    """Pad each row block's tile list with dead tiles (zero values, column
    block 0) to a multiple of ``k_pack`` (``tpugraph/ops/bcsr.py:394``).
    Tiles that are a tensor are scattered on their own device."""
    dst, new_col, new_row, new_ptr, t_new = _pad_rows_layout(
        _host(m.row_ptr), _host(m.row_of), _host(m.col_blk), k_pack)
    shape = (t_new, m.block, m.block)
    if isinstance(m.tiles, torch.Tensor):
        dev = m.tiles.device
        tiles = torch.zeros(shape, dtype=m.tiles.dtype, device=dev)
        tiles[torch.from_numpy(dst).to(dev)] = m.tiles[: len(dst)]
        new_col, new_row, new_ptr = (torch.from_numpy(a).to(dev)
                                     for a in (new_col, new_row, new_ptr))
    else:
        tiles = np.zeros(shape, dtype=m.tiles.dtype)
        tiles[dst] = m.tiles[: len(dst)]
    return BCSR(tiles=tiles, col_blk=new_col, row_ptr=new_ptr, row_of=new_row,
                num_nodes=m.num_nodes, block=m.block, longest_list=_longest(new_ptr))


@dataclasses.dataclass
class BCSRTranspose:
    """Structure-only transpose plan (``tpugraph/ops/bcsr.py:428``):
    ``tiles_T[i] = tiles[perm[i]]^T * keep[i]``; ``keep`` is 0 on tiles
    injected to cover row blocks of the transpose no real tile covers."""

    col_blk: Array  # int32[T']
    row_ptr: Array  # int32[R'+1]
    row_of: Array   # int32[T']
    perm: Array     # int32[T'] — source tile in the primal BCSR
    keep: Array     # float32[T'] — 1 real, 0 injected dead tile
    num_nodes: int
    block: int
    longest_list: Optional[int] = None  # as BCSR.longest_list

    @property
    def num_tiles(self) -> int:
        return self.perm.shape[0]

    def to(self, device) -> "BCSRTranspose":
        return dataclasses.replace(
            self, col_blk=_to(self.col_blk, device),
            row_ptr=_to(self.row_ptr, device), row_of=_to(self.row_of, device),
            perm=_to(self.perm, device), keep=_to(self.keep, device),
        )


def transpose_tiles(tiles: torch.Tensor, tp: BCSRTranspose) -> torch.Tensor:
    """Tiles of ``A^T`` from the primal tiles: a gather and a per-tile
    transpose (``tpugraph/ops/bcsr.py:464``); contiguous, as the kernels
    require."""
    out = tiles[tp.perm.long()].transpose(1, 2) * tp.keep[:, None, None]
    return out.contiguous()


def bcsr_transpose_plan(m: BCSR) -> BCSRTranspose:
    """Host-side :class:`BCSRTranspose` of a host BCSR
    (``tpugraph/ops/bcsr.py:469``).  Real tiles (any nonzero) regroup by
    transpose row block; each uncovered transpose row block gets one
    injected dead tile (perm 0, keep 0).  Rectangular-aware."""
    row = np.asarray(m.row_of)
    col = np.asarray(m.col_blk)
    tiles = np.asarray(m.tiles)
    n_blocks = m.num_nodes // m.block

    real = np.flatnonzero(np.any(tiles != 0, axis=(1, 2)))
    t_row, t_col = col[real], row[real]
    order = np.lexsort((t_col, t_row))
    t_row, t_col, perm = t_row[order], t_col[order], real[order]
    keep = np.ones(len(perm), dtype=np.float32)

    covered = np.zeros(n_blocks, dtype=bool)
    covered[t_row] = True
    missing = np.flatnonzero(~covered)
    if missing.size:
        t_row = np.concatenate([t_row, missing.astype(t_row.dtype)])
        t_col = np.concatenate([t_col, np.zeros(missing.size, t_col.dtype)])
        perm = np.concatenate([perm, np.zeros(missing.size, perm.dtype)])
        keep = np.concatenate([keep, np.zeros(missing.size, np.float32)])

    counts = np.bincount(t_row, minlength=n_blocks)
    row_ptr = np.zeros(n_blocks + 1, dtype=np.int32)
    row_ptr[1:] = np.cumsum(counts)
    return BCSRTranspose(
        col_blk=t_col.astype(np.int32),
        row_ptr=row_ptr,
        row_of=t_row.astype(np.int32),
        perm=perm.astype(np.int32),
        keep=keep,
        num_nodes=m.num_row_nodes,
        block=m.block,
        longest_list=_longest(row_ptr),
    )


def bcsr_sym_partner(m: BCSR) -> np.ndarray:
    """For each tile at block (rb, cb), the index of the first tile at
    (cb, rb), or itself when there is none (``tpugraph/ops/bcsr.py:518``)."""
    row = np.asarray(m.row_of).astype(np.int64)
    col = np.asarray(m.col_blk).astype(np.int64)
    n = int(max(row.max(initial=0), col.max(initial=0))) + 1
    keys, first = np.unique(row * n + col, return_index=True)
    want = col * n + row
    pos = np.minimum(np.searchsorted(keys, want), len(keys) - 1)
    found = keys[pos] == want
    return np.where(found, first[pos], np.arange(len(row))).astype(np.int32)
