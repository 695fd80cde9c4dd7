"""Port of ``tpugraph/viz/graphs.py:denoise_graph`` without networkx, on
:class:`tpugraph_torch.data.shapes.SimpleGraph`.

One divergence is kept: the largest component's nodes come out in
ascending id order, where networkx 3.6.1's ``G.subgraph(c).copy()``
orders them by its set's internals (for {3, 9, 20, 30, 35} of a 40-node
graph it lists ``[35, 3, 9, 20, 30]``).  The alignment that reads the
result is equivariant under a relabelling of either graph, so its results
match ``tpugraph``'s up to that permutation.  Rendering is not ported yet
(ROADMAP section 1 item 10).
"""

from __future__ import annotations

from typing import List, Optional, Set

import numpy as np

from tpugraph_torch.data.shapes import SimpleGraph


def _components(G: SimpleGraph) -> List[Set[int]]:
    """Connected components in the order their first node is visited."""
    seen: Set[int] = set()
    out = []
    for u in G.nodes():
        if u in seen:
            continue
        comp, frontier = {u}, [u]
        while frontier:
            v = frontier.pop()
            for w in G.neighbors(v):
                if w not in comp:
                    comp.add(w)
                    frontier.append(w)
        seen |= comp
        out.append(comp)
    return out


def _subgraph(G: SimpleGraph, keep) -> SimpleGraph:
    """The subgraph on ``keep``, nodes in ascending order, with the edge
    weights, features and attributes of its nodes."""
    keep = sorted(keep)
    kept = set(keep)
    h = SimpleGraph()
    h.add_nodes_from(keep)
    for u in keep:
        for v in G.neighbors(u):
            if v in kept:
                h.add_edge(u, v, G.weight(u, v))
    h.feat = {u: G.feat[u] for u in keep if u in G.feat}
    h.attrs = {u: G.attrs[u] for u in keep if u in G.attrs}
    return h


def denoise_graph(
    adj: np.ndarray,
    node_idx: int,
    feat: Optional[np.ndarray] = None,
    label: Optional[np.ndarray] = None,
    threshold: Optional[float] = None,
    threshold_num: Optional[int] = None,
    max_component: bool = True,
) -> SimpleGraph:
    """A weighted mask thresholded into an explanation subgraph
    (``tpugraph/viz/graphs.py:19``): entries ``>= threshold`` (``> 1e-6``
    without one), or with ``threshold_num`` the top-k undirected edges (the
    (2k)-th largest positive entry of the symmetric mask), become weighted
    edges, a pair's later entry in row-major order setting its weight; the
    query carries ``attrs[node_idx]["self"] = 1``, nodes carry ``feat``
    and ``attrs[u]["label"]`` when given.  Then the graph is restricted to
    its largest component (the first found, visiting nodes in ascending
    order) when it has edges, or with ``max_component=False`` loses its
    isolated nodes."""
    adj = np.asarray(adj)
    num_nodes = adj.shape[-1]
    if threshold_num is not None:
        positive = adj[adj > 0]
        keep = min(2 * threshold_num, positive.size)
        threshold = float(np.partition(positive, -keep)[-keep]) if keep else 1.0
    cutoff = 1e-6 if threshold is None else threshold
    rows, cols = np.nonzero(adj > cutoff if threshold is None else adj >= cutoff)

    G = SimpleGraph()
    G.add_nodes_from(range(num_nodes))
    G.attrs = {u: {} for u in range(num_nodes)}
    G.attrs[node_idx]["self"] = 1
    if feat is not None:
        G.feat = {u: feat[u] for u in range(num_nodes)}
    if label is not None:
        for u in range(num_nodes):
            G.attrs[u]["label"] = label[u]
    for u, v, w in zip(rows.tolist(), cols.tolist(), adj[rows, cols].tolist()):
        G.add_edge(u, v, w)

    if not max_component:
        return _subgraph(G, [u for u in G.nodes() if G.neighbors(u)])
    if G.number_of_edges() > 0:
        return _subgraph(G, max(_components(G), key=len))
    return G
