"""Port of ``tpugraph/ops/bcsr.py``: the block-CSR layout the kernels walk.

A BCSR matrix (row = receiver, col = sender) stores dense tiles over its
nonempty ``B x B`` blocks:

  tiles    float32[T, B, B]  — dense tile values
  col_blk  int32[T]          — column block of each tile
  row_ptr  int32[R+1]        — CSR offsets over row blocks
  row_of   int32[T]          — row block of each tile

Tiles are sorted by (row block, column block), and every row block holds
at least one tile: an empty row block gets one all-zero dead tile at
column block 0 (``tpugraph/ops/bcsr.py:126-136``).  Packing is host-side
numpy and gives arrays byte-identical to ``tpugraph``'s packer; the arrays
move to a device with :meth:`BCSR.to`.  Only float32 tiles are ported.
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

    tiles: Array     # float32[T, B, B]
    col_blk: Array   # int32[T]
    row_ptr: Array   # int32[R+1]
    row_of: Array    # int32[T]
    num_nodes: int
    block: int

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
                     col_blk: np.ndarray):
    """Layout that gives each empty row block one dead tile at column
    block 0 (``tpugraph/ops/bcsr.py:279`` with ``k_pack=1``): returns
    ``(dst, new_col, new_row, new_ptr, t_new)``, ``dst[i]`` the new slot
    of existing tile ``i``."""
    n_blocks = len(row_ptr) - 1
    t_old = int(row_ptr[-1])
    counts = np.diff(row_ptr)
    new_counts = np.where(counts == 0, 1, counts)
    t_new = int(new_counts.sum())
    new_ptr = np.zeros(n_blocks + 1, dtype=np.int32)
    new_ptr[1:] = np.cumsum(new_counts)
    ro = row_of[:t_old]
    dst = (new_ptr[ro] + (np.arange(t_old) - row_ptr[ro])).astype(np.int64)
    new_col = np.zeros(t_new, dtype=np.int32)
    new_col[dst] = col_blk[:t_old]
    new_row = np.repeat(np.arange(n_blocks, dtype=np.int32), new_counts)
    return dst, new_col, new_row, new_ptr, t_new


def bcsr_from_coo(
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: np.ndarray,
    num_nodes: int,
    block: int = 128,
    num_col_nodes: Optional[int] = None,
) -> BCSR:
    """Host-side COO -> BCSR (``tpugraph/ops/bcsr.py:79`` with
    ``device=False``): entry (row=receiver, col=sender) = weight, duplicate
    edges summed in edge order, zero-weight (padding) edges dropped.
    ``num_col_nodes`` makes the matrix rectangular (senders in
    ``[0, num_col_nodes)``); default square."""
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
    tiles = np.zeros((t_pad, block, block), dtype=np.float32)
    # np.add.at applies edges in (stable-sorted) edge order — the same
    # summation order as tpugraph's per-tile loop and native packer
    np.add.at(tiles, (tile_of_edge, r % block, s % block), w)
    col_blk = np.zeros((t_pad,), dtype=np.int32)
    row_of = np.full((t_pad,), n_rb - 1, dtype=np.int32)
    col_blk[:t] = uniq % n_cb
    row_of[:t] = uniq // n_cb

    row_ptr = np.zeros((n_rb + 1,), dtype=np.int32)
    counts = np.bincount(row_of[:t], minlength=n_rb)
    counts[n_rb - 1] += t_pad - t
    row_ptr[1:] = np.cumsum(counts)

    if np.any(counts == 0):
        dst, col_blk, row_of, row_ptr, t_new = _pad_rows_layout(
            row_ptr, row_of, col_blk)
        padded = np.zeros((t_new, block, block), dtype=np.float32)
        padded[dst] = tiles[: len(dst)]
        tiles = padded
    return BCSR(tiles=tiles, col_blk=col_blk, row_ptr=row_ptr, row_of=row_of,
                num_nodes=n_pad_c, block=block)


def bcsr_transpose_host(
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: np.ndarray,
    num_nodes: int,
    block: int = 128,
) -> BCSR:
    """BCSR of A^T, for the backward ``dx = A^T @ g``
    (``tpugraph/ops/bcsr.py:259``)."""
    return bcsr_from_coo(receivers, senders, weights, num_nodes, block)


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
