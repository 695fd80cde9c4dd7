"""Port of ``tpugraph/core/khop.py``: k-hop neighborhood masks.

The JAX version propagates a frontier with ``segment_max`` inside a
jitted ``vmap``; here the same frontier propagation runs on the host in
numpy, once per query, since its result only selects which nodes the
explainer keeps (O(k * E) per query).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from tpugraph_torch.core.graph import Graph


class Neighborhood(NamedTuple):
    """k-hop computation subgraph of one query, as masks over the padded
    node set (``tpugraph.core.khop.Neighborhood`` without the edge mask,
    which the tile-space explainer does not use)."""

    node_mask: np.ndarray  # float32[N_pad] — nodes in the neighborhood
    num_nodes: int         # neighborhood size
    new_index: int         # rank of the query among kept nodes


def khop_subgraph(g: Graph, node_idx: int, n_hops: int) -> Neighborhood:
    """Nodes within ``n_hops`` live edges of ``node_idx`` (the query
    included), masked to real nodes (``tpugraph/core/khop.py:62``)."""
    n = g.num_nodes_padded
    s = g.senders.numpy()
    r = g.receivers.numpy()
    live = g.edge_weight.numpy() != 0
    s, r = s[live], r[live]
    reach = np.zeros((n,), dtype=np.float32)
    reach[node_idx] = 1.0
    for _ in range(n_hops):
        nxt = np.zeros_like(reach)
        np.maximum.at(nxt, r, reach[s])
        reach = np.maximum(reach, nxt)
    reach = reach * g.node_mask.numpy()
    return Neighborhood(
        node_mask=reach,
        num_nodes=int(reach.sum()),
        new_index=int(reach[:node_idx].sum()),
    )
