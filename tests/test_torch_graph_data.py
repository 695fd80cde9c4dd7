"""The port's graph-classification data path against tpugraph's on the CPU:
the TU reader (node order, edges, one-hot and remapped labels, node
attributes, edge labels, the ``max_nodes`` cut), ``GraphBatcher`` and
``prepare_data`` byte for byte in every feature mode from the same seeded
generator, the batched-graph helpers of ``core/graph.py``, and the
networkx-free SYNBENCH writer of ``chip_smoke.py`` against
``bench_catalog.py``'s."""

import os

import numpy as np
import pytest
import torch

import bench_catalog
import chip_smoke
from test_tasks import write_tu_dataset
from tpugraph.core import graph as jax_graph
from tpugraph.data import pipeline as jax_pipeline
from tpugraph.data.readers import read_graphfile as jax_read_graphfile
from tpugraph_torch.core.graph import (batch_graphs, graph_from_dense,
                                       graph_to_dense)
from tpugraph_torch.data import pipeline
from tpugraph_torch.data.readers import read_graphfile

torch.set_num_threads(1)

FEATURE_MODES = ("default", "id", "deg-num", "deg", "struct")


def _same_graphs(jax_graphs, graphs, feats=False, edge_labels=False):
    assert len(jax_graphs) == len(graphs)
    for a, b in zip(jax_graphs, graphs):
        assert list(a.nodes()) == b.nodes()
        assert list(a.edges()) == list(b.edges())
        assert a.graph["label"] == b.graph["label"]
        assert a.graph.get("feat_dim") == b.graph.get("feat_dim")
        for u in a.nodes():
            assert a.nodes[u].get("label") == b.node_label.get(u)
            if feats:
                assert a.nodes[u]["feat"].tobytes() == b.feat[u].tobytes()
        if edge_labels:
            for u, v, data in a.edges(data=True):
                assert b.edge_label[(u, v)] == b.edge_label[(v, u)] == data["label"]


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tu"))
    write_tu_dataset(root, "TOY")
    return root


def test_read_graphfile_matches_tpugraph(toy):
    """TOY: node order, edges, one-hot node labels and the graph-label
    remap {1, 6} -> {0, 1}."""
    graphs = read_graphfile(toy, "TOY")
    _same_graphs(jax_read_graphfile(toy, "TOY"), graphs)
    assert sorted({G.graph["label"] for G in graphs}) == [0, 1]
    assert graphs[0].node_label[0] in ([0, 1], [1, 0])


def _write_irregular(root):
    """A TU dataset networkx's reader must be exact on: edges listed out of
    node order, one edge in both orientations with two labels (the later
    wins), a self-loop, a node that no edge touches (dropped), node
    attributes, sparse graph and node label values, and a graph of 7
    nodes that ``max_nodes=6`` drops."""
    d = os.path.join(root, "ODD")
    os.makedirs(d, exist_ok=True)
    indicator = [1] * 5 + [2] * 7 + [3] * 3
    edges = [(3, 1), (1, 2), (2, 3), (3, 2), (4, 4), (2, 4),
             (6, 7), (7, 8), (8, 9), (9, 10), (10, 11), (11, 12), (12, 6),
             (14, 13), (13, 15), (15, 14)]
    edge_labels = [5, 2, 9, 7, 2, 5, 2, 2, 5, 5, 9, 2, 2, 9, 5, 2]
    node_labels = [4, 0, 4, 9, 0, 0, 4, 4, 9, 9, 0, 4, 9, 0, 4]
    rng = np.random.default_rng(5)
    attrs = rng.standard_normal((15, 3)).round(4)
    prefix = os.path.join(d, "ODD")
    for suffix, rows in (("graph_indicator", indicator),
                         ("node_labels", node_labels),
                         ("edge_labels", edge_labels),
                         ("graph_labels", [-1, 10, -1])):
        with open(f"{prefix}_{suffix}.txt", "w") as f:
            f.write("\n".join(map(str, rows)) + "\n")
    with open(prefix + "_A.txt", "w") as f:
        f.write("\n".join(f"{a}, {b}" for a, b in edges) + "\n")
    with open(prefix + "_node_attributes.txt", "w") as f:
        f.write("\n".join(", ".join(map(str, r)) for r in attrs) + "\n")


@pytest.mark.parametrize("max_nodes", [None, 6])
def test_read_graphfile_attributes_edge_labels_max_nodes(tmp_path, max_nodes):
    _write_irregular(str(tmp_path))
    graphs = read_graphfile(str(tmp_path), "ODD", max_nodes=max_nodes,
                            edge_labels=True)
    _same_graphs(jax_read_graphfile(str(tmp_path), "ODD", max_nodes=max_nodes,
                                    edge_labels=True),
                 graphs, feats=True, edge_labels=True)
    assert len(graphs) == (2 if max_nodes else 3)
    assert graphs[0].number_of_nodes() == 4  # node 5 has no edge
    # nodes 3, 1, 2, 4 in first-occurrence order become 0..3; "3, 2" (label
    # 7, remapped to 2) comes after "2, 3" (9) and wins
    assert graphs[0].edge_label[(0, 2)] == graphs[0].edge_label[(2, 0)] == 2


def _with_label_feats(jax_graphs, graphs):
    for G in jax_graphs:
        for u in G.nodes():
            G.nodes[u]["feat"] = np.asarray(G.nodes[u]["label"], np.float32)
    for G in graphs:
        G.feat = {u: np.asarray(lab, np.float32) for u, lab in G.node_label.items()}


BATCH_FIELDS = ("adj", "feats", "label", "num_nodes", "node_mask", "assign_feats")


@pytest.mark.parametrize("mode", FEATURE_MODES)
def test_prepare_data_byte_identical(toy, mode):
    """The seeded shuffle and split, every batcher array, and the shuffled
    minibatches of two epochs (final batch padded), byte for byte."""
    jg, tg = jax_read_graphfile(toy, "TOY"), read_graphfile(toy, "TOY")
    _with_label_feats(jg, tg)
    ja = jax_pipeline.prepare_data(jg, features=mode, max_nodes=12,
                                   rng=np.random.default_rng(3))
    ta = pipeline.prepare_data(tg, features=mode, max_nodes=12,
                               rng=np.random.default_rng(3))
    for jb, tb in zip(ja, ta):
        for k in ("adj", "feats", "labels", "num_nodes", "assign_feats"):
            assert getattr(jb, k).tobytes() == getattr(tb, k).tobytes(), k
        assert (jb.feat_dim, jb.assign_feat_dim) == (tb.feat_dim, tb.assign_feat_dim)
    rj, rt = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(2):
        for bj, bt in zip(ja[0].batches(5, rng=rj), ta[0].batches(5, rng=rt)):
            for k in BATCH_FIELDS:
                assert getattr(bj, k).tobytes() == getattr(bt, k).tobytes(), k


@pytest.mark.parametrize("mode", FEATURE_MODES)
@pytest.mark.parametrize("assign_feat", ["default", "id"])
def test_graph_batcher_normalized_byte_identical(tmp_path, mode, assign_feat):
    """``GraphBatcher`` with symmetric normalization (float64, then f32; the
    ``deg`` mode's degrees read off the normalized adjacency), node
    attributes as features and the ``id`` assignment features, on the
    irregular dataset with its self-loop."""
    _write_irregular(str(tmp_path))
    jg = jax_read_graphfile(str(tmp_path), "ODD")
    tg = read_graphfile(str(tmp_path), "ODD")
    jb = jax_pipeline.GraphBatcher(jg, features=mode, assign_feat=assign_feat)
    tb = pipeline.GraphBatcher(tg, features=mode, assign_feat=assign_feat)
    for k in ("adj", "feats", "labels", "num_nodes", "assign_feats"):
        assert getattr(jb, k).tobytes() == getattr(tb, k).tobytes(), k


def test_clustering_matches_networkx(toy):
    import networkx as nx

    for G_j, G_t in zip(jax_read_graphfile(toy, "TOY"), read_graphfile(toy, "TOY")):
        G_j.add_edge(0, 2)
        G_j.add_edge(1, 3)
        G_t.add_edge(0, 2)
        G_t.add_edge(1, 3)
        want = np.asarray(list(nx.clustering(G_j).values()), np.float32)
        assert want.tobytes() == pipeline.clustering(G_t).astype(np.float32).tobytes()


def test_batch_graphs_and_graph_to_dense():
    """``graph_from_dense`` at a fixed edge budget, ``batch_graphs`` and
    ``graph_to_dense`` hold tpugraph's arrays."""
    rng = np.random.default_rng(2)
    adjs = []
    for _ in range(3):
        a = (rng.random((10, 10)) < 0.3).astype(np.float32)
        a = np.triu(a, 1)
        adjs.append(a + a.T)
    e_pad = max(8, ((max(int((a != 0).sum()) for a in adjs) + 7) // 8) * 8)
    jb = jax_graph.batch_graphs([jax_graph.graph_from_dense(a, num_edges_padded=e_pad)
                                 for a in adjs])
    tb = batch_graphs([graph_from_dense(a, num_edges_padded=e_pad) for a in adjs])
    for k in jb._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jb, k)),
                                      getattr(tb, k).numpy(), err_msg=k)
    for i, a in enumerate(adjs):
        g = tb.graph(i)
        assert g.n_node == 10 and g.num_edges_padded == e_pad
        np.testing.assert_array_equal(graph_to_dense(g, 10).numpy(), a.T)
        np.testing.assert_array_equal(
            graph_to_dense(g).numpy(),
            np.asarray(jax_graph.graph_to_dense(jb.graph(i))))
    with pytest.raises(ValueError, match="budget"):
        graph_from_dense(adjs[0], num_edges_padded=8)
    with pytest.raises(TypeError):
        graph_from_dense(adjs[0], None)  # the budget is keyword-only


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synbench_writer_byte_identical(tmp_path, seed):
    """``chip_smoke.write_tu_synthetic`` writes ``bench_catalog``'s files byte
    for byte (networkx there, none here), and the port reads them as
    tpugraph does."""
    a = bench_catalog.write_tu_synthetic(str(tmp_path / "nx"), "SYNBENCH",
                                         n_graphs=30, seed=seed)
    b = chip_smoke.write_tu_synthetic(str(tmp_path / "port"), "SYNBENCH",
                                      n_graphs=30, seed=seed)
    assert a == b
    for suffix in ("graph_indicator", "node_labels", "A", "graph_labels"):
        name = f"SYNBENCH/SYNBENCH_{suffix}.txt"
        with open(tmp_path / "nx" / name, "rb") as f1, \
                open(tmp_path / "port" / name, "rb") as f2:
            assert f1.read() == f2.read(), suffix
    _same_graphs(jax_read_graphfile(str(tmp_path / "nx"), "SYNBENCH", max_nodes=100),
                 read_graphfile(str(tmp_path / "port"), "SYNBENCH", max_nodes=100))
