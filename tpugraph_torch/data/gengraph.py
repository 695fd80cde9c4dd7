"""Port of ``tpugraph/data/gengraph.py``: syn1 and the dense cg contract,
on :class:`tpugraph_torch.data.shapes.SimpleGraph` instead of networkx.
Same seed, same graph, labels and features as ``tpugraph``."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from tpugraph_torch.data.featgen import ConstFeatureGen
from tpugraph_torch.data.shapes import SimpleGraph, build_graph


def perturb(
    graph_list: List[SimpleGraph], p: float,
    rng: Optional[np.random.Generator] = None,
) -> List[SimpleGraph]:
    """Add ``p * |E|`` random new edges to each graph
    (``tpugraph/data/gengraph.py:22``)."""
    rng = rng or np.random.default_rng()
    out = []
    for G_original in graph_list:
        G = G_original.copy()
        edge_count = int(G.number_of_edges() * p)
        for _ in range(edge_count):
            while True:
                u = int(rng.integers(0, G.number_of_nodes()))
                v = int(rng.integers(0, G.number_of_nodes()))
                if (not G.has_edge(u, v)) and (u != v):
                    break
            G.add_edge(u, v)
        out.append(G)
    return out


def preprocess_input_graph(G: SimpleGraph, labels) -> dict:
    """Dense ``adj``/``feat``/``labels`` with a leading batch dim of 1 —
    the checkpoint ``cg`` contract (``tpugraph/data/gengraph.py:62``).
    Node order is ``G.nodes()``; each undirected edge has weight 1."""
    nodes = G.nodes()
    index = {u: i for i, u in enumerate(nodes)}
    adj = np.zeros((len(nodes), len(nodes)), dtype=np.float64)
    for u, v in G.edges():
        adj[index[u], index[v]] = 1.0
        adj[index[v], index[u]] = 1.0
    f = np.stack([G.feat[u] for u in nodes]).astype(np.float32)
    return {
        "adj": adj[None].astype(np.float32),
        "feat": f[None],
        "labels": np.asarray(labels)[None],
    }


def gen_syn1(
    nb_shapes: int = 80,
    width_basis: int = 300,
    feature_generator: Optional[ConstFeatureGen] = None,
    m: int = 5,
    seed: Optional[int] = None,
) -> Tuple[SimpleGraph, List[int], str]:
    """BA basis + 80 house motifs, 1% edge perturbation
    (``tpugraph/data/gengraph.py:81``).  Roles: 0 basis, 1/2/3 house."""
    rng = np.random.default_rng(seed)
    basis_type = "ba"
    list_shapes = [["house"]] * nb_shapes
    G, role_id, _ = build_graph(
        width_basis, basis_type, list_shapes, start=0, m=m, rng=rng
    )
    G = perturb([G], 0.01, rng=rng)[0]
    if feature_generator is None:
        feature_generator = ConstFeatureGen(np.ones(10, dtype=np.float32))
    feature_generator.gen_node_features(G)
    name = basis_type + "_" + str(width_basis) + "_" + str(nb_shapes)
    return G, role_id, name
