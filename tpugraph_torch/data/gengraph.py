"""Port of ``tpugraph/data/gengraph.py``: syn1–syn5 and the dense cg
contract, on :class:`tpugraph_torch.data.shapes.SimpleGraph` instead of
networkx.  Same seed, same graph (node and edge order included), labels
and features as ``tpugraph``."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from tpugraph_torch.data.featgen import ConstFeatureGen, GaussianFeatureGen
from tpugraph_torch.data.shapes import SimpleGraph, build_graph, compose


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


def join_graph(
    G1: SimpleGraph, G2: SimpleGraph, n_pert_edges: int,
    rng: Optional[np.random.Generator] = None,
) -> SimpleGraph:
    """The union of two graphs (``nx.compose`` order) and ``n_pert_edges``
    random edges from G1 to G2 (``tpugraph/data/gengraph.py:43``)."""
    rng = rng or np.random.default_rng()
    assert n_pert_edges > 0
    F = compose(G1, G2)
    nodes1, nodes2 = G1.nodes(), G2.nodes()
    for _ in range(n_pert_edges):
        u = nodes1[int(rng.integers(0, len(nodes1)))]
        v = nodes2[int(rng.integers(0, len(nodes2)))]
        F.add_edge(u, v)
    return F


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
    G, role_id = _syn_motifs(width_basis, "ba", [["house"]] * nb_shapes,
                             0.01, feature_generator, m, seed)
    name = "ba_" + str(width_basis) + "_" + str(nb_shapes)
    return G, role_id, name


def gen_syn2(
    nb_shapes: int = 100, width_basis: int = 350, seed: Optional[int] = None,
) -> Tuple[SimpleGraph, List[int], str]:
    """Two syn1 communities (BA ``m = 4``) with Gaussian features, joined by
    ``width_basis`` random edges; 8 classes (``tpugraph/data/gengraph.py:141``).
    Both feature generators draw from the outer generator, in the order
    G1's seed, G1's features, G2's seed, G2's features, the join."""
    rng = np.random.default_rng(seed)
    random_mu = [0.0] * 8
    random_sigma = [1.0] * 8
    mu_1 = np.array([-1.0] * 2 + random_mu)
    sigma_1 = np.array([0.5] * 2 + random_sigma)
    mu_2 = np.array([1.0] * 2 + random_mu)
    sigma_2 = np.array([0.5] * 2 + random_sigma)
    feat_gen1 = GaussianFeatureGen(mu=mu_1, sigma=sigma_1, rng=rng)
    feat_gen2 = GaussianFeatureGen(mu=mu_2, sigma=sigma_2, rng=rng)
    G1, role_id1, _ = gen_syn1(feature_generator=feat_gen1, m=4,
                               seed=int(rng.integers(2**31)))
    G2, role_id2, _ = gen_syn1(feature_generator=feat_gen2, m=4,
                               seed=int(rng.integers(2**31)))
    G1_size = G1.number_of_nodes()
    num_roles = max(role_id1) + 1
    label = role_id1 + [r + num_roles for r in role_id2]
    G1 = G1.relabeled({n: i for i, n in enumerate(G1.nodes())})
    G2 = G2.relabeled({n: i + G1_size for i, n in enumerate(G2.nodes())})
    G = join_graph(G1, G2, width_basis, rng=rng)
    name = "ba_" + str(width_basis) + "_" + str(nb_shapes) + "_2comm"
    return G, label, name


def _syn_motifs(width_basis, basis_type, list_shapes, p, feature_generator,
                m, seed):
    rng = np.random.default_rng(seed)
    G, role_id, _ = build_graph(width_basis, basis_type, list_shapes,
                                start=0, m=m, rng=rng)
    G = perturb([G], p, rng=rng)[0]
    if feature_generator is None:
        feature_generator = ConstFeatureGen(np.ones(10, dtype=np.float32))
    feature_generator.gen_node_features(G)
    return G, role_id


def gen_syn3(
    nb_shapes: int = 80,
    width_basis: int = 300,
    feature_generator: Optional[ConstFeatureGen] = None,
    m: int = 5,
    seed: Optional[int] = None,
) -> Tuple[SimpleGraph, List[int], str]:
    """BA basis + 3x3 grid motifs, 1% perturbation
    (``tpugraph/data/gengraph.py:187``)."""
    G, role_id = _syn_motifs(width_basis, "ba", [["grid", 3]] * nb_shapes,
                             0.01, feature_generator, m, seed)
    return G, role_id, "ba_" + str(width_basis) + "_" + str(nb_shapes)


def gen_syn4(
    nb_shapes: int = 60,
    width_basis: int = 8,
    feature_generator: Optional[ConstFeatureGen] = None,
    seed: Optional[int] = None,
) -> Tuple[SimpleGraph, List[int], str]:
    """Balanced binary tree of height 8 + 6-cycles, 1% perturbation
    (``tpugraph/data/gengraph.py:221``)."""
    G, role_id = _syn_motifs(width_basis, "tree", [["cycle", 6]] * nb_shapes,
                             0.01, feature_generator, 5, seed)
    return G, role_id, "tree_" + str(width_basis) + "_" + str(nb_shapes)


def gen_syn5(
    nb_shapes: int = 80,
    width_basis: int = 8,
    feature_generator: Optional[ConstFeatureGen] = None,
    m: int = 3,
    seed: Optional[int] = None,
) -> Tuple[SimpleGraph, List[int], str]:
    """Balanced binary tree of height 8 + 3x3 grids (``m`` is the grid's
    side), 10% perturbation (``tpugraph/data/gengraph.py:260``)."""
    G, role_id = _syn_motifs(width_basis, "tree", [["grid", m]] * nb_shapes,
                             0.1, feature_generator, 5, seed)
    return G, role_id, "tree_" + str(width_basis) + "_" + str(nb_shapes)


GENERATORS = {
    "syn1": gen_syn1,
    "syn2": gen_syn2,
    "syn3": gen_syn3,
    "syn4": gen_syn4,
    "syn5": gen_syn5,
}
