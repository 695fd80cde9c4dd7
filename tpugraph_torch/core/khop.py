"""Port of ``tpugraph/core/khop.py``: k-hop neighborhood masks.

The JAX version propagates a frontier with ``segment_max`` inside a
jitted ``vmap``; here the same frontier propagation runs on the host in
numpy, once per query, since its result only selects which nodes and
edges the explainer keeps (O(k * E) per query).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from tpugraph_torch.core.graph import Graph


def khop_reachability(g: Graph, node_idx: int, n_hops: int) -> np.ndarray:
    """float32[N_pad] mask of the nodes within ``n_hops`` live edges of
    ``node_idx``, the query included, masked to real nodes
    (``tpugraph/core/khop.py:28``)."""
    s = g.senders.numpy()
    r = g.receivers.numpy()
    live = g.edge_weight.numpy() != 0
    s, r = s[live], r[live]
    reach = np.zeros((g.num_nodes_padded,), dtype=np.float32)
    reach[node_idx] = 1.0
    for _ in range(n_hops):
        nxt = np.zeros_like(reach)
        np.maximum.at(nxt, r, reach[s])
        reach = np.maximum(reach, nxt)
    return reach * g.node_mask.numpy()


class Neighborhood(NamedTuple):
    """k-hop computation subgraph of one query, as masks over the padded
    node and edge sets (``tpugraph/core/khop.py:49``)."""

    node_mask: np.ndarray  # float32[N_pad] — nodes in the neighborhood
    edge_mask: np.ndarray  # bool[E_pad] — live edges with both endpoints inside
    num_nodes: int         # neighborhood size
    new_index: int         # rank of the query among kept nodes


def khop_subgraph(g: Graph, node_idx: int, n_hops: int) -> Neighborhood:
    """The neighborhood masks of one query (``tpugraph/core/khop.py:62``);
    ``new_index`` is the query's rank among the kept nodes in ascending
    order (reference ``explain.py:496``)."""
    reach = khop_reachability(g, node_idx, n_hops)
    edge_keep = ((reach[g.senders.numpy()] > 0)
                 & (reach[g.receivers.numpy()] > 0)
                 & (g.edge_weight.numpy() != 0))
    return Neighborhood(
        node_mask=reach,
        edge_mask=edge_keep,
        num_nodes=int(reach.sum()),
        new_index=int(reach[:node_idx].sum()),
    )


def extract_dense_subgraph(
    adj: np.ndarray,
    feat: np.ndarray,
    labels: np.ndarray,
    node_idx: int,
    n_hops: int,
) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host-side dense neighborhood of ``node_idx`` by BFS over the nonzero
    structure (``tpugraph/core/khop.py:84``): ``(node_idx_new, sub_adj,
    sub_feat, sub_label, neighbors)``, ``neighbors`` the kept nodes'
    original indices in ascending order."""
    adj = np.asarray(adj)
    n = adj.shape[0]
    nbrs = [np.nonzero(adj[i])[0] for i in range(n)]
    reach = {int(node_idx)}
    frontier = {int(node_idx)}
    for _ in range(n_hops):
        nxt = set()
        for u in frontier:
            nxt.update(int(v) for v in nbrs[u])
        frontier = nxt - reach
        reach |= nxt
    neighbors = np.asarray(sorted(reach), dtype=np.int64)
    node_idx_new = int(np.searchsorted(neighbors, node_idx))
    sub_adj = adj[np.ix_(neighbors, neighbors)]
    sub_feat = np.asarray(feat)[neighbors]
    sub_label = np.asarray(labels)[neighbors]
    return node_idx_new, sub_adj, sub_feat, sub_label, neighbors
