"""Port of ``tpugraph/core/graph.py``: the padded COO ``Graph``.

Same padding rules as the JAX package — nodes and edges padded to a
multiple of 8, padding edges point at node 0 with weight exactly 0, and
both directions of an undirected edge share one ``edge_pair`` id — so
that a graph built here and one built by ``tpugraph`` hold the same
arrays.  The arrays are CPU tensors: the graph is host-side input to the
packers and the k-hop extraction, and moves to a device as a packed
layout, as a ``SparseAdj`` or, for the COO explainer, as itself
(``Graph.to``).
"""

from __future__ import annotations

from typing import Iterable, List, NamedTuple, Optional, Tuple

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

    def to(self, device) -> "Graph":
        """This graph with its arrays on ``device`` (the COO explainer's
        copy; the graph is built on the host)."""
        return self._replace(**{k: getattr(self, k).to(device) for k in (
            "senders", "receivers", "edge_weight", "node_mask", "edge_pair")})


class BatchedGraphs(NamedTuple):
    """Same-budget padded graphs stacked on a leading batch axis
    (``tpugraph/core/graph.py:62``): each field is the :class:`Graph`
    field with that axis in front (``n_node`` / ``n_edge`` int64[B])."""

    senders: torch.Tensor      # int32[B, E_pad]
    receivers: torch.Tensor    # int32[B, E_pad]
    edge_weight: torch.Tensor  # float32[B, E_pad]
    node_mask: torch.Tensor    # float32[B, N_pad]
    n_node: torch.Tensor       # int64[B]
    n_edge: torch.Tensor       # int64[B]
    edge_pair: torch.Tensor    # int32[B, E_pad]

    @property
    def num_nodes_padded(self) -> int:
        return self.node_mask.shape[-1]

    @property
    def num_edges_padded(self) -> int:
        return self.senders.shape[-1]

    def graph(self, i: int) -> Graph:
        return Graph(*(x[i] if k not in ("n_node", "n_edge") else int(x[i])
                       for k, x in zip(self._fields, self)))

    def to(self, device) -> "BatchedGraphs":
        return BatchedGraphs(*(x.to(device) for x in self))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def graph_from_edges(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    edge_weight: Optional[np.ndarray] = None,
    pad_multiple: int = 8,
    *,
    num_edges_padded: Optional[int] = None,
    num_nodes_padded: Optional[int] = None,
    normalize: bool = False,
) -> Graph:
    """Padded :class:`Graph` from host-side directed edge arrays
    (``tpugraph/core/graph.py:87``); ``num_nodes_padded`` and
    ``num_edges_padded`` fix the budgets, which must hold every node and
    edge.  ``normalize`` scales the weights to ``D^-1/2 A D^-1/2`` with
    each node's weighted in-degree, in float64 as ``tpugraph`` does."""
    senders = np.asarray(senders, dtype=np.int32)
    receivers = np.asarray(receivers, dtype=np.int32)
    e = senders.shape[0]
    if edge_weight is None:
        edge_weight = np.ones((e,), dtype=np.float32)
    else:
        edge_weight = np.asarray(edge_weight, dtype=np.float32)
    if normalize and e > 0:
        deg = np.zeros((num_nodes,), dtype=np.float64)
        np.add.at(deg, receivers, edge_weight)
        inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
        edge_weight = (edge_weight * inv_sqrt[senders]
                       * inv_sqrt[receivers]).astype(np.float32)

    n_pad = num_nodes_padded or _round_up(max(num_nodes, 1), pad_multiple)
    e_pad = num_edges_padded or _round_up(max(e, 1), pad_multiple)
    if n_pad < num_nodes or e_pad < e:
        raise ValueError(f"padding budget too small: nodes {num_nodes}>{n_pad} "
                         f"or edges {e}>{e_pad}")
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


def graph_from_dense(adj: np.ndarray, *,
                     num_edges_padded: Optional[int] = None) -> Graph:
    """Dense adjacency (the cg bundle's format, optionally with a leading
    batch dim of 1) to a padded :class:`Graph`; nonzero ``adj[i, j]`` is
    the directed edge i -> j (``tpugraph/core/graph.py:159``), and
    ``num_edges_padded`` fixes the edge budget."""
    adj = np.asarray(adj)
    if adj.ndim == 3:
        adj = adj[0]
    senders, receivers = np.nonzero(adj)
    return graph_from_edges(
        senders.astype(np.int32),
        receivers.astype(np.int32),
        adj.shape[0],
        edge_weight=adj[senders, receivers].astype(np.float32),
        num_edges_padded=num_edges_padded,
    )


def graph_from_edge_list(num_nodes: int,
                         edges: Iterable[Tuple[int, int]]) -> Graph:
    """Padded :class:`Graph` from an undirected edge list over nodes
    ``0..num_nodes-1``, stored as :func:`graph_from_networkx` stores a
    graph's: each edge in both directions (a self-loop once), in list
    order."""
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


def graph_from_networkx(G, normalize: bool = False,
                        num_nodes_padded: Optional[int] = None,
                        num_edges_padded: Optional[int] = None) -> Graph:
    """Padded :class:`Graph` of an undirected graph read through
    ``G.nodes()`` and ``G.edges()`` (a networkx graph, or any object with
    the two; networkx is never imported), nodes in ``G.nodes()`` order
    (``tpugraph/core/graph.py:185``).  Each edge is stored in both
    directions (a self-loop once), in ``G.edges()`` order."""
    index = {u: i for i, u in enumerate(G.nodes())}
    senders, receivers = [], []
    for u, v in G.edges():
        ui, vi = index[u], index[v]
        senders.append(ui)
        receivers.append(vi)
        if ui != vi:
            senders.append(vi)
            receivers.append(ui)
    return graph_from_edges(np.asarray(senders, dtype=np.int32),
                            np.asarray(receivers, dtype=np.int32), len(index),
                            num_nodes_padded=num_nodes_padded,
                            num_edges_padded=num_edges_padded,
                            normalize=normalize)


def graph_to_dense(g: Graph, num_nodes: Optional[int] = None) -> torch.Tensor:
    """The ``[N, N]`` adjacency of ``g`` (``tpugraph/core/graph.py:216``):
    ``dense[r, s]`` sums the weights of the edges s -> r; ``N`` defaults
    to the padded node count."""
    n = num_nodes or g.num_nodes_padded
    dense = torch.zeros((n, n), dtype=g.edge_weight.dtype,
                        device=g.edge_weight.device)
    return dense.index_put_((g.receivers.long(), g.senders.long()),
                            g.edge_weight, accumulate=True)


def pad_graph(g: Graph, num_nodes_padded: int, num_edges_padded: int) -> Graph:
    """``g`` re-padded to larger node and edge budgets
    (``tpugraph/core/graph.py:224``): new padding edges point at node 0
    with weight 0, and the padding pair id moves to the new edge count."""
    e_old = g.num_edges_padded
    if e_old > num_edges_padded:
        raise ValueError("cannot shrink edge padding")
    s = np.zeros((num_edges_padded,), dtype=np.int32)
    r = np.zeros((num_edges_padded,), dtype=np.int32)
    w = np.zeros((num_edges_padded,), dtype=np.float32)
    p = np.full((num_edges_padded,), num_edges_padded, dtype=np.int32)
    s[:e_old] = g.senders.numpy()
    r[:e_old] = g.receivers.numpy()
    w[:e_old] = g.edge_weight.numpy()
    old_pair = g.edge_pair.numpy()
    p[:e_old] = np.where(old_pair == e_old, num_edges_padded, old_pair)
    mask = np.zeros((num_nodes_padded,), dtype=np.float32)
    mask[: int(g.n_node)] = 1.0
    return Graph(senders=torch.from_numpy(s), receivers=torch.from_numpy(r),
                 edge_weight=torch.from_numpy(w), node_mask=torch.from_numpy(mask),
                 n_node=g.n_node, n_edge=g.n_edge, edge_pair=torch.from_numpy(p))


def batch_graphs(graphs: List[Graph]) -> BatchedGraphs:
    """Same-budget padded graphs stacked on a batch axis
    (``tpugraph/core/graph.py:251``)."""
    return BatchedGraphs(
        senders=torch.stack([g.senders for g in graphs]),
        receivers=torch.stack([g.receivers for g in graphs]),
        edge_weight=torch.stack([g.edge_weight for g in graphs]),
        node_mask=torch.stack([g.node_mask for g in graphs]),
        n_node=torch.tensor([g.n_node for g in graphs], dtype=torch.int64),
        n_edge=torch.tensor([g.n_edge for g in graphs], dtype=torch.int64),
        edge_pair=torch.stack([g.edge_pair for g in graphs]),
    )
