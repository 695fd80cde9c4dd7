"""Port of ``tpugraph/core/graph.py``: the padded COO ``Graph``.

Same padding rules as the JAX package — nodes and edges padded to a
multiple of 8, padding edges point at node 0 with weight exactly 0, and
both directions of an undirected edge share one ``edge_pair`` id — so
that a graph built here and one built by ``tpugraph`` hold the same
arrays.  The arrays are CPU tensors: the graph is host-side input to the
BCSR packer and the k-hop extraction, and moves to a device only as the
packed layout.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch


class Graph(NamedTuple):
    """A single padded sparse graph (see ``tpugraph.core.graph.Graph``).

    senders / receivers / edge_pair: int32[E_pad]; edge_weight:
    float32[E_pad] (0 on padding); node_mask: float32[N_pad];
    n_node / n_edge: the real node and directed-edge counts.
    """

    senders: torch.Tensor
    receivers: torch.Tensor
    edge_weight: torch.Tensor
    node_mask: torch.Tensor
    n_node: int
    n_edge: int
    edge_pair: torch.Tensor

    @property
    def num_nodes_padded(self) -> int:
        return self.node_mask.shape[-1]

    @property
    def num_edges_padded(self) -> int:
        return self.senders.shape[-1]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def graph_from_edges(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    edge_weight: Optional[np.ndarray] = None,
    pad_multiple: int = 8,
) -> Graph:
    """Padded :class:`Graph` from host-side directed edge arrays
    (``tpugraph/core/graph.py:87`` without normalization or explicit
    padding budgets)."""
    senders = np.asarray(senders, dtype=np.int32)
    receivers = np.asarray(receivers, dtype=np.int32)
    e = senders.shape[0]
    if edge_weight is None:
        edge_weight = np.ones((e,), dtype=np.float32)
    else:
        edge_weight = np.asarray(edge_weight, dtype=np.float32)

    n_pad = _round_up(max(num_nodes, 1), pad_multiple)
    e_pad = _round_up(max(e, 1), pad_multiple)
    s = np.zeros((e_pad,), dtype=np.int32)
    r = np.zeros((e_pad,), dtype=np.int32)
    w = np.zeros((e_pad,), dtype=np.float32)
    s[:e], r[:e], w[:e] = senders, receivers, edge_weight

    # undirected-pair ids: canonical (min, max) key; padding gets e_pad
    pair = np.full((e_pad,), e_pad, dtype=np.int32)
    if e > 0:
        lo = np.minimum(s[:e], r[:e]).astype(np.int64)
        hi = np.maximum(s[:e], r[:e]).astype(np.int64)
        _, inverse = np.unique(lo * np.int64(n_pad) + hi, return_inverse=True)
        pair[:e] = inverse.astype(np.int32)

    node_mask = np.zeros((n_pad,), dtype=np.float32)
    node_mask[:num_nodes] = 1.0
    return Graph(
        senders=torch.from_numpy(s),
        receivers=torch.from_numpy(r),
        edge_weight=torch.from_numpy(w),
        node_mask=torch.from_numpy(node_mask),
        n_node=int(num_nodes),
        n_edge=int(e),
        edge_pair=torch.from_numpy(pair),
    )


def graph_from_dense(adj: np.ndarray) -> Graph:
    """Dense adjacency (the cg bundle's format, optionally with a leading
    batch dim of 1) to a padded :class:`Graph`; nonzero ``adj[i, j]`` is
    the directed edge i -> j (``tpugraph/core/graph.py:159``)."""
    adj = np.asarray(adj)
    if adj.ndim == 3:
        adj = adj[0]
    senders, receivers = np.nonzero(adj)
    return graph_from_edges(
        senders.astype(np.int32),
        receivers.astype(np.int32),
        adj.shape[0],
        edge_weight=adj[senders, receivers].astype(np.float32),
    )


def graph_from_edge_list(num_nodes: int,
                         edges: Iterable[Tuple[int, int]]) -> Graph:
    """Padded :class:`Graph` from an undirected edge list over nodes
    ``0..num_nodes-1`` — the networkx-free replacement of
    ``graph_from_networkx`` (``tpugraph/core/graph.py:185``).  Each edge
    is stored in both directions (a self-loop once), in list order."""
    senders, receivers = [], []
    for u, v in edges:
        senders.append(u)
        receivers.append(v)
        if u != v:
            senders.append(v)
            receivers.append(u)
    return graph_from_edges(
        np.asarray(senders, dtype=np.int32),
        np.asarray(receivers, dtype=np.int32),
        num_nodes,
    )
