"""The port's remaining tasks against ``tpugraph``'s on the CPU, on
synthetic fixtures written here (as ``tests/test_tasks.py`` and
``tests/test_readers.py`` write theirs): ``read_biosnap`` (networkx's node
order reproduced, not sorted), the Enron slices and their disjoint union,
the networkx-free unpickler, and the ppi_essential and enron node tasks,
``enron_multigraph_task``, ``pkl_task`` and ``benchmark_task_val`` from
``tpugraph``'s own initial weights."""

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from tpugraph.cli import tasks as jax_tasks
from tpugraph.cli.config import Config as JaxConfig
from tpugraph.data import readers as jax_readers
from tpugraph.nn import GcnEncoderGraph as JaxGcnEncoderGraph
from tpugraph.nn import GcnEncoderNode as JaxGcnEncoderNode
from tpugraph.nn.layers import SparseAdj as JaxSparseAdj
from tpugraph_torch.cli import tasks
from tpugraph_torch.cli.config import Config
from tpugraph_torch.data import readers
from tpugraph_torch.data.pipeline import to_numpy_array
from tpugraph_torch.nn import params_from_jax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5    # node tasks: 20 epochs of losses, and final parameters
GRAPH_TOL = 1e-4   # graph tasks: test_torch_graph_model.py's trajectory tolerance


# ------------------------------------------------------------- fixtures


def write_ppi(root, n=48, seed=0, islands=1):
    """A BioSnap-style fixture under ``root/ppi_essential``: a random graph
    on gene ids 100.., ``islands`` small extra components, labels for all
    but a few genes and motif features for all but a few."""
    rng = np.random.default_rng(seed)
    d = os.path.join(root, "ppi_essential")
    os.makedirs(d, exist_ok=True)
    G = nx.gnp_random_graph(n, 4.0 / n, seed=seed)
    ids = rng.permutation(np.arange(100, 100 + 3 * n))[:n]
    edges = [(int(ids[u]), int(ids[v])) for u, v in G.edges()]
    for k in range(islands):
        a = 1000 + 10 * k
        edges += [(a, a + 1), (a + 1, a + 2)]
    rng.shuffle(edges)
    with open(os.path.join(d, "hi-union-ppi.tsv"), "w") as f:
        f.write("# gene_a\tgene_b\n")
        f.write("x\ty\n")
        for a, b in edges:
            f.write(f"{a}\t{b}\n")
    genes = sorted({g for e in edges for g in e})
    with open(os.path.join(d, "G-HumanEssential.tsv"), "w") as f:
        for g in genes[3:]:
            f.write(f"{g}\t{'Essential' if rng.random() < 0.3 else 'Non-Essential'}\n")
    with open(os.path.join(d, "G-MtfPathways_gene-motifs.csv"), "w") as f:
        f.write("gene,m1,m2,m3,m4\n")
        for g in genes[:-2]:
            f.write(f"{g}," + ",".join(f"{rng.random() * 3:.3f}" if rng.random() < 0.8
                                       else "" for _ in range(4)) + "\n")
    return root


def write_enron(root, n=14, seed=0):
    """Ten pickled ``nx.Graph`` slices on nodes 0..n-1, roles on some nodes,
    views accessed before pickling (as a live graph would have them)."""
    d = os.path.join(root, "gnn-explainer-enron")
    os.makedirs(d, exist_ok=True)
    roles = list(jax_readers.ENRON_LABELS)
    rng = np.random.default_rng(seed)
    for i in range(10):
        G = nx.gnp_random_graph(n, 0.3, seed=seed + i)
        for u in G.nodes():
            if rng.random() < 0.7:
                G.nodes[u]["role"] = roles[int(rng.integers(len(roles)))]
        list(G.nodes()), list(G.edges()), G.degree  # noqa: B018
        with open(os.path.join(d, f"enron_slice_{i}.pkl"), "wb") as f:
            pickle.dump(G, f)
    return root


def write_graph_pickle(path, seed=1):
    """``(graphs, labels, test_graphs, test_labels)`` of cycles and stars
    (``tests/test_tasks.py:test_pkl_task``'s bundle) with seeded N(0, 1)
    node features, so no max-pool readout ties."""
    rng = np.random.default_rng(seed)
    graphs, labels = [], []
    for i in range(16):
        n = int(rng.integers(5, 9))
        G = nx.cycle_graph(n) if i % 2 else nx.star_graph(n - 1)
        for u in G.nodes():
            G.nodes[u]["feat"] = rng.standard_normal(4).astype(np.float32)
        graphs.append(G)
        labels.append(i % 2)
    with open(path, "wb") as f:
        pickle.dump((graphs[:12], labels[:12], graphs[12:], labels[12:]), f)


def write_random_tu(root, name="RND", n_graphs=18, seed=0):
    """A TU dataset of random graphs with random node labels (4 kinds), the
    graph label the parity of the edge count over the node count, so no
    max-pool readout ties."""
    rng = np.random.default_rng(seed)
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    ind, nl, edges, gl, nid = [], [], [], [], 1
    for gi in range(1, n_graphs + 1):
        n = int(rng.integers(6, 11))
        G = nx.gnp_random_graph(n, 0.4, seed=int(rng.integers(1 << 30)))
        G.add_edges_from((u, u + 1) for u in range(n - 1))
        for u in G.nodes():
            ind.append(gi)
            nl.append(int(rng.integers(4)))
        for u, v in G.edges():
            edges += [(nid + u, nid + v), (nid + v, nid + u)]
        gl.append(int(G.number_of_edges() > 1.6 * n))
        nid += n
    prefix = os.path.join(d, name)
    for suffix, rows in (("graph_indicator", ind), ("node_labels", nl),
                         ("graph_labels", gl)):
        with open(f"{prefix}_{suffix}.txt", "w") as f:
            f.write("\n".join(map(str, rows)) + "\n")
    with open(prefix + "_A.txt", "w") as f:
        f.write("\n".join(f"{a}, {b}" for a, b in edges) + "\n")
    return root


def jax_node_init(real):
    """``train_node_classifier`` (or the multigraph trainer) of the port,
    started from the flax parameters ``tpugraph`` draws: ``PRNGKey(seed)``
    on a ``GcnEncoderNode`` of the same widths."""
    def wrapped(model, g, feat, labels, cfg, seed=0, **kw):
        kw.pop("init_params", None)
        multi = isinstance(g, list)
        num_classes = (max(readers.ENRON_LABELS.values()) + 1 if multi
                       else int(max(labels)) + 1)
        g0, x0 = (g[0], feat[0]) if multi else (g, feat)
        mj = JaxGcnEncoderNode(input_dim=x0.shape[-1], hidden_dim=20, embedding_dim=20,
                               label_dim=num_classes, num_layers=3)
        params = mj.init(jax.random.PRNGKey(seed), jnp.asarray(x0), JaxSparseAdj(
            jnp.asarray(g0.senders.numpy()), jnp.asarray(g0.receivers.numpy()),
            jnp.asarray(g0.edge_weight.numpy())))
        return real(model, g, feat, labels, cfg, seed=seed,
                    init_params=params_from_jax(params), **kw)
    return wrapped


def jax_graph_init(real, num_classes=2):
    """The port's ``train_graph_classifier`` started from the flax
    parameters ``tpugraph``'s draws from its first batch."""
    def wrapped(model, train_b, cfg, seed=0, **kw):
        first = train_b.batch(np.arange(min(len(train_b), cfg.batch_size)))
        mj = JaxGcnEncoderGraph(input_dim=train_b.feat_dim, hidden_dim=20,
                                embedding_dim=20, label_dim=num_classes,
                                num_layers=3)
        params = mj.init(jax.random.PRNGKey(seed), jnp.asarray(first.feats),
                         jnp.asarray(first.adj),
                         node_mask=jnp.asarray(first.node_mask))
        return real(model, train_b, cfg, seed=seed,
                    init_params=params_from_jax(params), **kw)
    return wrapped


def both_cfgs(tmp_path, **kw):
    kw = dict(datadir=str(tmp_path), **kw)
    return (JaxConfig(ckptdir=str(tmp_path / "ck_jax"), **kw),
            Config(platform="cpu", ckptdir=str(tmp_path / "ck_port"), **kw))


# ---------------------------------------------------------------- readers


def _graph_dump(G_t, G_j):
    assert G_t.nodes() == list(G_j.nodes())
    assert list(G_t.edges()) == list(G_j.edges())


@pytest.mark.parametrize("n,islands,feat", [(10, 1, True), (48, 1, True),
                                            (48, 1, False), (12, 14, True)],
                         ids=["small", "component-over-half", "no-feat-file",
                              "component-under-half"])
def test_read_biosnap_matches(tmp_path, n, islands, feat):
    """Graph, node order, labels and features byte for byte; with 14
    islands the kept component is under half the graph, where networkx
    lists it in its set's order."""
    write_ppi(str(tmp_path), n=n, islands=islands)
    d = str(tmp_path / "ppi_essential")
    args = ("hi-union-ppi.tsv", "G-HumanEssential.tsv")
    kw = {"feat_file": "G-MtfPathways_gene-motifs.csv"} if feat else {}
    G_j = jax_readers.read_biosnap(d, *args, **kw)
    G_t = readers.read_biosnap(d, *args, **kw)
    _graph_dump(G_t, G_j)
    assert G_t.number_of_nodes() > 3
    for u in G_j.nodes():
        assert G_t.attrs[u]["label"] == G_j.nodes[u]["label"]
        assert G_t.feat[u].dtype == G_j.nodes[u]["feat"].dtype
        assert G_t.feat[u].tobytes() == G_j.nodes[u]["feat"].tobytes()


def test_largest_component_order_is_networkx_set_order():
    """A component under half of a 40-node graph: networkx's copy lists its
    nodes in the order of the set it builds, not ascending."""
    G_j = nx.Graph()
    G_j.add_nodes_from(range(40))
    ring = [35, 3, 20, 9, 30]
    G_j.add_edges_from(zip(ring, ring[1:]))
    G_j.add_edges_from([(0, 1), (5, 6)])
    want = list(G_j.subgraph(max(nx.connected_components(G_j), key=len)).copy())
    G_t = readers.SimpleGraph()
    G_t.add_nodes_from(range(40))
    G_t.add_edges_from(zip(ring, ring[1:]))
    G_t.add_edges_from([(0, 1), (5, 6)])
    assert readers._largest_component_nx_order(G_t) == want == [3, 35, 9, 20, 30]


def test_enron_slices_and_union_match(tmp_path):
    write_enron(str(tmp_path))
    sj = jax_readers.load_enron_slices(str(tmp_path), input_dim=6)
    st = readers.load_enron_slices(str(tmp_path), input_dim=6)
    assert len(st) == len(sj) == 10
    for a, b in zip(st, sj):
        _graph_dump(a, b)
        for u in b.nodes():
            assert a.attrs[u].get("role") == b.nodes[u].get("role")
            assert a.feat[u].tobytes() == b.nodes[u]["feat"].tobytes()
    U_j = nx.disjoint_union_all(sj)
    U_t = readers.disjoint_union_all(st)
    _graph_dump(U_t, U_j)
    assert to_numpy_array(U_t).tobytes() == nx.to_numpy_array(U_j).tobytes()
    assert ([U_t.attrs[u].get("role") for u in U_t.nodes()]
            == [d.get("role") for _, d in U_j.nodes(data=True)])


def test_unpickler_needs_no_networkx(tmp_path):
    """A bundle written with real networkx (weights, attributes, numpy
    features, cached views) read in a process where networkx cannot be
    imported: the same nodes, neighbour order, weights and attributes."""
    rng = np.random.default_rng(0)
    G = nx.gnp_random_graph(9, 0.4, seed=3)
    for u, v in G.edges():
        G.edges[u, v]["weight"] = float(rng.random())
    for u in G.nodes():
        G.nodes[u]["feat"] = rng.standard_normal(3).astype(np.float32)
        G.nodes[u]["role"] = f"r{u % 3}"
    G.graph["label"] = 4
    list(G.nodes()), list(G.edges()), G.degree, G.adj  # noqa: B018
    path = tmp_path / "b.pkl"
    with open(path, "wb") as f:
        pickle.dump(([G, nx.path_graph(3)], [np.int64(1), 0]), f)
    code = (
        "import sys, json; sys.modules['networkx'] = None\n"
        "from tpugraph_torch.data.readers import load_graph_pickle\n"
        f"gs, labels = load_graph_pickle({str(path)!r})\n"
        "g = gs[0]\n"
        "print(json.dumps({'nodes': g.nodes(), 'adj': [[u, v, g.weight(u, v)] "
        "for u in g.nodes() for v in g.neighbors(u)], 'attrs': {str(k): v for k, v in "
        "g.attrs.items()}, 'feat': [g.feat[u].tolist() for u in g.nodes()], "
        "'graph': g.graph, 'labels': [int(x) for x in labels], "
        "'path': list(gs[1].edges())}))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout)
    assert got["nodes"] == list(G.nodes())
    assert got["adj"] == [[u, v, G.edges[u, v]["weight"]] for u in G.nodes()
                          for v in G.adj[u]]
    assert got["attrs"] == {str(u): {"role": G.nodes[u]["role"]} for u in G.nodes()}
    np.testing.assert_array_equal(got["feat"], [G.nodes[u]["feat"] for u in G.nodes()])
    assert got["graph"] == {"label": 4} and got["labels"] == [1, 0]
    assert got["path"] == [[0, 1], [1, 2]]


def test_unpickler_refuses_other_classes(tmp_path):
    import collections

    path = tmp_path / "x.pkl"
    with open(path, "wb") as f:
        pickle.dump([collections.OrderedDict(a=1)], f)
    with pytest.raises(pickle.UnpicklingError, match="collections.OrderedDict"):
        readers.load_graph_pickle(str(path))


# ------------------------------------------------------------------ tasks


def test_ppi_task_matches(tmp_path, monkeypatch):
    """Class-weighted [1, 5] training: 20 epochs of losses at 1e-5 and the
    cg bundle byte for byte."""
    write_ppi(str(tmp_path), n=48)
    cfg_j, cfg = both_cfgs(tmp_path, dataset="ppi_essential", num_epochs=20)
    out_j = jax_tasks.ppi_task(cfg_j)
    monkeypatch.setattr(tasks, "train_node_classifier",
                        jax_node_init(tasks.train_node_classifier))
    out = tasks.node_task(cfg)
    np.testing.assert_allclose(out["history"]["loss"], out_j["history"]["loss"],
                               rtol=0, atol=LOSS_TOL)
    for k in ("adj", "feat", "label", "train_idx"):
        assert np.asarray(out["cg"][k]).tobytes() == np.asarray(out_j["cg"][k]).tobytes(), k
    assert os.path.isdir(out["ckpt_path"])


def test_class_weight_changes_the_loss(tmp_path, monkeypatch):
    """The weight reaches the loss: ppi without it trains another way."""
    write_ppi(str(tmp_path), n=48)
    _, cfg = both_cfgs(tmp_path, dataset="ppi_essential", num_epochs=2)
    a = tasks.node_task(cfg)["history"]["loss"][0]
    real = tasks.run_node_task
    monkeypatch.setattr(tasks, "run_node_task",
                        lambda c, G, lab, class_weight=None, log_fn=None:
                        real(c, G, lab, log_fn=log_fn))
    b = tasks.node_task(cfg)["history"]["loss"][0]
    assert abs(a - b) > 1e-4


def test_enron_task_matches(tmp_path, monkeypatch):
    write_enron(str(tmp_path))
    cfg_j, cfg = both_cfgs(tmp_path, dataset="enron", num_epochs=20)
    out_j = jax_tasks.enron_task(cfg_j)
    monkeypatch.setattr(tasks, "train_node_classifier",
                        jax_node_init(tasks.train_node_classifier))
    out = tasks.node_task(cfg)
    np.testing.assert_allclose(out["history"]["loss"], out_j["history"]["loss"],
                               rtol=0, atol=LOSS_TOL)
    assert out["cg"]["adj"].tobytes() == np.asarray(out_j["cg"]["adj"]).tobytes()
    assert np.array_equal(out["cg"]["label"], np.asarray(out_j["cg"]["label"]))


def test_enron_multigraph_matches(tmp_path, monkeypatch):
    """The slices as one stack: the loss trajectory and the final
    parameters at 1e-5, the stacked cg bundle byte for byte."""
    write_enron(str(tmp_path))
    cfg_j, cfg = both_cfgs(tmp_path, dataset="enron_multigraph", num_epochs=20)
    out_j = jax_tasks.enron_multigraph_task(cfg_j)
    monkeypatch.setattr(tasks, "train_node_classifier_multigraph",
                        jax_node_init(tasks.train_node_classifier_multigraph))
    out = tasks.enron_multigraph_task(cfg)
    np.testing.assert_allclose(out["history"]["loss"], out_j["history"]["loss"],
                               rtol=0, atol=LOSS_TOL)
    want = params_from_jax(out_j["params"])
    assert set(out["params"]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(out["params"][k].numpy(), v.numpy(), rtol=0,
                                   atol=LOSS_TOL, err_msg=k)
    for k in ("adj", "feat", "label", "train_idx"):
        assert np.asarray(out["cg"][k]).tobytes() == np.asarray(out_j["cg"][k]).tobytes(), k
    assert out["ypred"].shape[0] == 10


def test_pkl_task_matches(tmp_path, monkeypatch):
    write_graph_pickle(tmp_path / "toy.pkl")
    cfg_j, cfg = both_cfgs(tmp_path, pkl_fname="toy.pkl", num_epochs=12,
                           batch_size=6, eval_every=4)
    out_j = jax_tasks.pkl_task(cfg_j)
    monkeypatch.setattr(tasks, "train_graph_classifier",
                        jax_graph_init(tasks.train_graph_classifier))
    out = tasks.pkl_task(cfg)
    err = np.abs(np.subtract(out["history"]["loss"], out_j["history"]["loss"])).max()
    assert err <= GRAPH_TOL, err
    for k in ("train_acc", "test_acc"):
        np.testing.assert_allclose(out["history"][k], out_j["history"][k], atol=1e-12)


def test_benchmark_task_val_matches(tmp_path, monkeypatch):
    """Three folds: every fold's validation accuracies equal, so the mean
    curve, its best value and its index too."""
    write_random_tu(str(tmp_path))
    kw = dict(bmname="RND", num_epochs=6, batch_size=6, eval_every=3, max_nodes=0)
    cfg_j, cfg = both_cfgs(tmp_path, **kw)
    folds_j, folds = [], []
    real_j = jax_tasks.__dict__.get("train_graph_classifier")
    import tpugraph.train.loop as jax_loop

    real_loop = jax_loop.train_graph_classifier

    def record_j(*a, **k):
        out = real_loop(*a, **k)
        folds_j.append(out["history"]["val_acc"])
        return out

    monkeypatch.setattr(jax_loop, "train_graph_classifier", record_j)
    out_j = jax_tasks.benchmark_task_val(cfg_j, n_splits=3)
    assert real_j is None or real_j is not record_j
    start = jax_graph_init(tasks.train_graph_classifier)

    def record(*a, **k):
        out = start(*a, **k)
        folds.append(out["history"]["val_acc"])
        return out

    monkeypatch.setattr(tasks, "train_graph_classifier", record)
    out = tasks.benchmark_task_val(cfg, n_splits=3)
    assert len(folds) == len(folds_j) == 3
    np.testing.assert_allclose(folds, folds_j, atol=1e-12)
    np.testing.assert_allclose(out["val_acc_mean"], out_j["val_acc_mean"], atol=1e-12)
    assert out["best_val_acc"] == pytest.approx(out_j["best_val_acc"])
    assert out["best_epoch_idx"] == out_j["best_epoch_idx"]
