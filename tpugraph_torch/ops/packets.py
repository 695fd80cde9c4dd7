"""Port of ``tpugraph/ops/packets.py``: the edge-packet layout for
low-locality (power-law) graphs.

Instead of dense tiles, each (receiver block, sender block) pair stores
its edges in packets of ``K`` slots:

  rows    int32[P, K]  — row within the receiver block (``block_r`` rows)
  cols    int32[P, K]  — row of x within the sender block (``block_c`` rows)
  w       f32  [P, K]  — edge weight (0 = dead padding slot)
  row_of  int32[P]     — receiver block of the packet
  col_blk int32[P]     — sender block of the packet

Packets are sorted by (receiver block, sender block); every receiver
block holds a multiple of ``pk_multiple`` packets (at least one group,
all dead for a block without edges).  The host packer is vectorized
numpy and gives arrays byte-identical to ``tpugraph``'s.  The port adds
``row_ptr`` int32[R+1], the packet offsets of each receiver block, which
the CUDA kernel walks (derived once here from the sorted ``row_of``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Union

import numpy as np
import torch

from tpugraph_torch.ops.bcsr import _host, _to

Array = Union[np.ndarray, torch.Tensor]


@dataclasses.dataclass
class EdgePackets:
    """Edge packets (``tpugraph/ops/packets.py:52``); arrays are numpy on
    the host and tensors on a device (:meth:`to`)."""

    rows: Array      # int32[P, K]
    cols: Array      # int32[P, K]
    w: Array         # float32[P, K]
    row_of: Array    # int32[P]
    col_blk: Array   # int32[P]
    row_ptr: Array   # int32[R+1] — packets of receiver block r: row_ptr[r]..row_ptr[r+1]
    num_nodes: int   # padded node count (multiple of lcm(block_r, block_c))
    block_r: int     # receiver (output) block height
    block_c: int     # sender (x window) block height

    @property
    def num_packets(self) -> int:
        return self.rows.shape[0]

    @property
    def k(self) -> int:
        return self.rows.shape[1]

    @property
    def num_row_blocks(self) -> int:
        return self.num_nodes // self.block_r

    @property
    def num_edge_slots(self) -> int:
        return self.rows.shape[0] * self.rows.shape[1]

    def to(self, device) -> "EdgePackets":
        return dataclasses.replace(
            self, rows=_to(self.rows, device), cols=_to(self.cols, device),
            w=_to(self.w, device), row_of=_to(self.row_of, device),
            col_blk=_to(self.col_blk, device), row_ptr=_to(self.row_ptr, device))


def _pad_nodes(num_nodes: int, block_r: int, block_c: int) -> int:
    m = math.lcm(block_r, block_c)
    return ((num_nodes + m - 1) // m) * m


def pack_edges(
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: np.ndarray,
    num_nodes: int,
    block_r: int = 256,
    block_c: int = 256,
    k: int = 128,
    pk_multiple: int = 8,
) -> EdgePackets:
    """Host-side COO -> :class:`EdgePackets` (``tpugraph/ops/packets.py:94``
    with float32 weights): entry (row=receiver, col=sender) = weight,
    zero-weight edges dropped, edges of one tile in edge order, a tile
    with more than ``k`` edges split over several packets."""
    s = np.asarray(senders)
    r = np.asarray(receivers)
    w = np.asarray(weights, dtype=np.float32)
    live = w != 0
    s, r, w = s[live], r[live], w[live]

    n_pad = _pad_nodes(num_nodes, block_r, block_c)
    n_rb = n_pad // block_r
    n_cb = n_pad // block_c

    rb = (r // block_r).astype(np.int64)
    cb = (s // block_c).astype(np.int64)
    key = rb * n_cb + cb
    order = np.argsort(key, kind="stable")
    s, r, w, key = s[order], r[order], w[order], key[order]
    e = len(key)

    uniq, start = np.unique(key, return_index=True)
    counts = np.diff(np.append(start, e))
    # packets per tile, then per row block (at least one for an empty
    # row block), padded to a multiple of pk_multiple
    pk_per_tile = (counts + k - 1) // k
    tile_rb = (uniq // n_cb).astype(np.int64)
    rb_packets = np.bincount(tile_rb, weights=pk_per_tile, minlength=n_rb)
    rb_packets = rb_packets.astype(np.int64)
    rb_packets[rb_packets == 0] = 1
    m = max(int(pk_multiple), 1)
    rb_packets = ((rb_packets + m - 1) // m) * m
    p_total = int(rb_packets.sum())

    rows = np.zeros((p_total, k), dtype=np.int32)
    cols = np.zeros((p_total, k), dtype=np.int32)
    wv = np.zeros((p_total, k), dtype=np.float32)
    row_of = np.repeat(np.arange(n_rb, dtype=np.int32), rb_packets)
    col_blk = np.zeros(p_total, dtype=np.int32)
    row_ptr = np.zeros(n_rb + 1, dtype=np.int64)
    row_ptr[1:] = np.cumsum(rb_packets)

    # first packet of each tile: after all packets of earlier row blocks,
    # plus the packets of the earlier tiles of its own row block
    tile_pk_cum = np.zeros(len(uniq), dtype=np.int64)
    if len(uniq):
        cum = np.cumsum(pk_per_tile)
        tile_pk_cum[1:] = cum[:-1]
        rb_first_tile = np.searchsorted(tile_rb, np.arange(n_rb))
        rb_base = np.zeros(n_rb, dtype=np.int64)
        valid = rb_first_tile < len(uniq)
        rb_base[valid] = tile_pk_cum[rb_first_tile[valid]]
        tile_pk_cum -= rb_base[tile_rb]
    tile_first_packet = row_ptr[tile_rb] + tile_pk_cum

    tile_of_edge = np.repeat(np.arange(len(uniq)), counts)
    slot_in_tile = np.arange(e) - start[tile_of_edge]
    pkt = tile_first_packet[tile_of_edge] + slot_in_tile // k
    slot = slot_in_tile % k

    rows[pkt, slot] = (r % block_r).astype(np.int32)
    cols[pkt, slot] = (s % block_c).astype(np.int32)
    wv[pkt, slot] = w
    if len(uniq):
        tile_cb = (uniq % n_cb).astype(np.int32)
        total_pk = int(pk_per_tile.sum())
        within = np.arange(total_pk) - np.repeat(
            np.cumsum(pk_per_tile) - pk_per_tile, pk_per_tile)
        pkt_ids = np.repeat(tile_first_packet, pk_per_tile) + within
        col_blk[pkt_ids] = np.repeat(tile_cb, pk_per_tile)

    return EdgePackets(rows=rows, cols=cols, w=wv, row_of=row_of,
                       col_blk=col_blk, row_ptr=row_ptr.astype(np.int32),
                       num_nodes=n_pad, block_r=block_r, block_c=block_c)


def pack_edges_transpose(
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: np.ndarray,
    num_nodes: int,
    block_r: int = 256,
    block_c: int = 256,
    k: int = 128,
    pk_multiple: int = 8,
) -> EdgePackets:
    """Packets of A^T, for the backward ``dx = A^T @ g``
    (``tpugraph/ops/packets.py:202``)."""
    return pack_edges(receivers, senders, weights, num_nodes, block_r,
                      block_c, k, pk_multiple=pk_multiple)


def packet_stats(p: EdgePackets, num_edges: int) -> dict:
    """Occupancy figures (``tpugraph/ops/packets.py:220``)."""
    return {
        "packets": p.num_packets,
        "k": p.k,
        "slot_occupancy": num_edges / max(p.num_edge_slots, 1),
        "edge_bytes": int(p.num_edge_slots * (4 + 4 + 4)),
    }


def packets_to_dense(p: EdgePackets) -> np.ndarray:
    """Densify (testing only; ``tpugraph/ops/packets.py:234``)."""
    n = p.num_nodes
    out = np.zeros((n, n), dtype=np.float32)
    rows, cols, w, rof, cof = (_host(a) for a in (p.rows, p.cols, p.w,
                                                  p.row_of, p.col_blk))
    rr = rof[:, None].astype(np.int64) * p.block_r + rows
    cc = cof[:, None].astype(np.int64) * p.block_c + cols
    np.add.at(out, (rr.ravel(), cc.ravel()), w.ravel())
    return out
