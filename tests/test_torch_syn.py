"""syn2–syn5 against tpugraph's generators on the CPU: every shape alone,
``build_graph``'s options, the feature generators, the four datasets
byte for byte for seeds 0–2 (node order, edge order, labels, features and
the dense cg bundle), and the motif ground truth with its AUC."""

import networkx as nx
import numpy as np
import pytest
import torch

from tpugraph.core.graph import graph_from_networkx as jax_graph_from_networkx
from tpugraph.data import featgen as jax_featgen
from tpugraph.data import gengraph as jax_gengraph
from tpugraph.data import shapes as jax_shapes
from tpugraph.explain import groundtruth as jax_groundtruth
from tpugraph_torch.core.graph import graph_from_edge_list
from tpugraph_torch.data import featgen, gengraph, shapes
from tpugraph_torch.explain import groundtruth

torch.set_num_threads(1)


def _same_graph(G_j, G_t):
    assert list(G_j.nodes()) == G_t.nodes()
    assert list(G_j.edges()) == list(G_t.edges())  # order included
    for u in G_j.nodes():  # neighbour order too
        assert list(G_j.adj[u]) == list(G_t._adj[u]), u


@pytest.mark.parametrize("name,args", [
    ("clique", (3, 6, 4)),
    ("clique", (0, 5)),
    ("cycle", (7, 6)),
    ("diamond", (2,)),
    ("tree", (0, 8)),
    ("tree", (5, 3, 3)),
    ("star", (4, 5)),
    ("fan", (4, 6)),
    ("grid", (9, 3)),
    ("grid", (0, 4)),
    ("path", (1, 5)),
    ("house", (3,)),
])
def test_shape_matches_tpugraph(name, args):
    """Each shape alone: the same nodes, edges in the same order,
    neighbour order and roles (clique's edge removal from the same
    generator)."""
    g_j, roles_j = jax_shapes.SHAPES[name](*args, rng=np.random.default_rng(1))
    g_t, roles_t = shapes.SHAPES[name](*args, rng=np.random.default_rng(1))
    _same_graph(g_j, g_t)
    assert list(roles_j) == list(roles_t)


def test_barabasi_albert_m4_matches_networkx():
    """syn2's basis: m = 4."""
    for seed in (0, 11):
        ref = nx.barabasi_albert_graph(300, 4, seed=seed)
        _same_graph(ref, shapes._barabasi_albert(300, 4, seed))
    g_j, _ = jax_shapes.ba(0, 300, m=4, rng=np.random.default_rng(2))
    g_t, _ = shapes.ba(0, 300, m=4, rng=np.random.default_rng(2))
    _same_graph(g_j, g_t)


@pytest.mark.parametrize("kw", [
    dict(width_basis=8, basis_type="tree", list_shapes=[["cycle", 6]] * 20),
    dict(width_basis=60, basis_type="ba", list_shapes=[["grid", 3]] * 5
         + [["cycle", 5]] * 5 + [["clique", 5, 2]] * 3,
         rdm_basis_plugins=True, add_random_edges=7),
    dict(width_basis=40, basis_type="ba", list_shapes=[["fan", 4], ["star", 3],
                                                       ["path", 4], ["diamond"]],
         m=3, add_random_edges=3),
])
def test_build_graph_matches_tpugraph(kw):
    """build_graph with cycles' second anchors, random plugins and random
    edges: graph, roles and plugins."""
    G_j, roles_j, plugins_j = jax_shapes.build_graph(
        rng=np.random.default_rng(4), **kw)
    G_t, roles_t, plugins_t = shapes.build_graph(
        rng=np.random.default_rng(4), **kw)
    _same_graph(G_j, G_t)
    assert list(roles_j) == list(roles_t)
    assert [int(p) for p in plugins_j] == plugins_t


def test_feature_generators_match_tpugraph():
    G_j, _, _ = jax_gengraph.gen_syn3(seed=1)
    G_t, _, _ = gengraph.gen_syn3(seed=1)
    mu, sigma = np.array([-1.0, 0.5, 2.0]), np.array([0.5, 1.0, 2.0])
    jax_featgen.GaussianFeatureGen(mu, sigma, rng=np.random.default_rng(3)
                                   ).gen_node_features(G_j)
    featgen.GaussianFeatureGen(mu, sigma, rng=np.random.default_rng(3)
                               ).gen_node_features(G_t)
    for u in G_j.nodes():
        assert G_j.nodes[u]["feat"].tobytes() == G_t.feat[u].tobytes()
    com_j = jax_featgen.GridFeatureGen(0.0, 1.0, [0, 1], rng=np.random.default_rng(5)
                                       ).gen_node_features(G_j)
    com_t = featgen.GridFeatureGen(0.0, 1.0, [0, 1], rng=np.random.default_rng(5)
                                   ).gen_node_features(G_t)
    assert com_j == com_t
    for u in G_j.nodes():
        assert G_j.nodes[u]["feat"].tobytes() == G_t.feat[u].tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["syn2", "syn3", "syn4", "syn5"])
def test_gen_syn_matches_tpugraph(name, seed):
    """The dataset as the CLI generates it: node and edge order, labels,
    features, the padded graph arrays and the dense cg bundle, byte for
    byte."""
    kw = {} if name == "syn2" else dict(
        feature_generator=jax_featgen.ConstFeatureGen(np.ones(10, np.float32)))
    G_j, labels_j, name_j = jax_gengraph.GENERATORS[name](seed=seed, **kw)
    kw = {} if name == "syn2" else dict(
        feature_generator=featgen.ConstFeatureGen(np.ones(10, np.float32)))
    G_t, labels_t, name_t = gengraph.GENERATORS[name](seed=seed, **kw)
    _same_graph(G_j, G_t)
    assert list(labels_j) == list(labels_t) and name_j == name_t
    for u in G_j.nodes():
        assert G_j.nodes[u]["feat"].tobytes() == G_t.feat[u].tobytes(), u
    g_j = jax_graph_from_networkx(G_j)
    g_t = graph_from_edge_list(G_t.number_of_nodes(), G_t.edges())
    for k in ("senders", "receivers", "edge_weight", "node_mask", "edge_pair"):
        a, b = np.asarray(getattr(g_j, k)), getattr(g_t, k).numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    cg_j = jax_gengraph.preprocess_input_graph(G_j, labels_j)
    cg_t = gengraph.preprocess_input_graph(G_t, labels_t)
    for k in ("adj", "feat", "labels"):
        assert cg_j[k].dtype == cg_t[k].dtype, k
        assert cg_j[k].tobytes() == cg_t[k].tobytes(), k


# the first node of three motifs of each dataset at seed 0
MOTIF_STARTS = {"syn1": [300, 305, 310], "syn2": [300, 305, 1000],
                "syn3": [300, 309, 318], "syn4": [511, 517, 523],
                "syn5": [511, 520, 529]}


@pytest.mark.parametrize("dataset", sorted(MOTIF_STARTS))
def test_motif_ground_truth_and_auc_match(dataset):
    """The motif edges, and make_pred_real and the AUC of fixed masks over
    each dataset's own graph, against tpugraph's (sklearn's AUC)."""
    assert groundtruth.MOTIF_EDGES[dataset] == jax_groundtruth.MOTIF_EDGES[dataset]
    G, _, _ = gengraph.GENERATORS[dataset](seed=0)
    adj = gengraph.preprocess_input_graph(G, [0] * G.number_of_nodes())["adj"][0]
    rng = np.random.default_rng(7)
    masks = []
    for st in MOTIF_STARTS[dataset]:
        sub = adj[st - 20: st + 20, st - 20: st + 20]
        masks.append(np.triu(sub * rng.random(sub.shape), 1) + np.triu(
            sub * rng.random(sub.shape), 1).T)
    local = [20] * len(masks)
    for ma, st in zip(masks, local):
        p_j, r_j = jax_groundtruth.make_pred_real(ma, st, dataset)
        p_t, r_t = groundtruth.make_pred_real(ma, st, dataset)
        np.testing.assert_array_equal(p_t, p_j)
        np.testing.assert_array_equal(r_t, r_j)
        assert r_t.sum() > 0
    auc_j, _, _ = jax_groundtruth.explanation_auc(masks, local, dataset)
    auc_t, _, _ = groundtruth.explanation_auc(masks, local, dataset)
    assert auc_t == pytest.approx(auc_j, rel=1e-12)
