"""The port's graph-mode GNNExplainer against tpugraph's on the CPU, from the
same weights and the same mask init: ``_explain_graph`` and
``explain_graphs`` on the COO path and ``explain_graph_bcsr`` in tile
space (B1/B2's plain versions here, Pallas in interpret mode on the JAX
side) at blocks 8 and 128; each graph of an ``explain_graphs`` call
getting the result it gets alone; and the graph CLI on TOY
(``cli.train --bmname`` for base, att and soft-assign, then
``cli.explain --graph-mode``, ``--graph-idx`` and ``--multigraph-class``)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_tasks import write_tu_dataset
from tpugraph.core.graph import graph_from_dense as jax_graph_from_dense
from tpugraph.data.pipeline import prepare_data as jax_prepare_data
from tpugraph.data.readers import read_graphfile as jax_read_graphfile
from tpugraph.explain import bcsr_explain as jax_bcsr_explain
from tpugraph.explain import module as jax_module
from tpugraph.explain.explainer import Explainer as JaxExplainer
from tpugraph.nn import GcnEncoderGraph as JaxGcnEncoderGraph
from tpugraph.ops import bcsr as jax_bcsr
from tpugraph_torch import ops
from tpugraph_torch.cli import explain as cli_explain
from tpugraph_torch.cli import train as cli_train
from tpugraph_torch.explain import ExplainConfig, Explainer
from tpugraph_torch.nn import GcnEncoderGraph, params_from_jax

torch.set_num_threads(1)

EPOCHS = 30  # mask-optimization epochs of the parity runs
MASK_TOL = 1e-4  # |port - JAX| of a masked-adjacency entry (each in [0, 1])
ALONE_TOL = 1e-5  # a graph in a batch against the same graph alone


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A graph cg bundle from TOY's graphs (padded to 12 nodes, seeded
    N(0, 1) features of width 4, so that the max-pool readout has one
    maximum a channel) and one ``GcnEncoderGraph`` (width 8, 3 layers) in
    both packages from flax's init, with an explainer each."""
    root = str(tmp_path_factory.mktemp("tu"))
    write_tu_dataset(root, "TOY")
    graphs = jax_read_graphfile(root, "TOY")
    rng = np.random.default_rng(11)
    for G in graphs:
        for u in G.nodes():
            G.nodes[u]["feat"] = rng.standard_normal(4).astype(np.float32)
    train_b = jax_prepare_data(graphs, max_nodes=12, rng=np.random.default_rng(0))[0]
    cg = train_b.batch(np.arange(len(train_b)))
    dims = dict(input_dim=4, hidden_dim=8, embedding_dim=8, label_dim=2, num_layers=3)
    model_j = JaxGcnEncoderGraph(**dims)
    params = model_j.init(jax.random.PRNGKey(2), jnp.asarray(cg.feats),
                          jnp.asarray(cg.adj), node_mask=jnp.asarray(cg.node_mask))
    logits, _ = model_j.apply(params, jnp.asarray(cg.feats), jnp.asarray(cg.adj),
                              node_mask=jnp.asarray(cg.node_mask))
    bundle = dict(adj=cg.adj, feat=cg.feats, label=cg.label,
                  pred=np.asarray(logits)[None])
    cfg = ExplainConfig(num_epochs=EPOCHS)
    ex_j = JaxExplainer(model_j, params, **bundle, n_hops=3, graph_mode=True,
                        cfg=jax_module.ExplainConfig(num_epochs=EPOCHS), seed=0)
    ex = Explainer(GcnEncoderGraph(**dims, device="cpu"), params_from_jax(params),
                   **bundle, n_hops=3, graph_mode=True, cfg=cfg, seed=0,
                   device="cpu")
    return dict(ex=ex, ex_j=ex_j, bundle=bundle, cfg=cfg)


def _close(got, want, tol=MASK_TOL):
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol, err


def _jax_edge_init(setup, graph_idx, num_pairs):
    """tpugraph's COO mask init of one graph over ``num_pairs`` pairs."""
    g = jax_graph_from_dense(setup["bundle"]["adj"][graph_idx])
    st = jax_module.init_masks(jax.random.PRNGKey(graph_idx), num_pairs, 4,
                               g.n_node, jax_module.ExplainConfig())
    return np.asarray(st.edge_logits)


@pytest.mark.parametrize("graph_idx", [0, 3])
def test_explain_graph_matches_tpugraph(setup, graph_idx):
    """``_explain_graph`` (and ``explain(graph_mode=True)``) from tpugraph's
    init for the graph (key ``seed + graph_idx``)."""
    want = setup["ex_j"]._explain_graph(graph_idx)
    g = jax_graph_from_dense(setup["bundle"]["adj"][graph_idx])
    init = (_jax_edge_init(setup, graph_idx, g.num_edges_padded)[None],
            np.zeros((1, 4), np.float32))
    got = setup["ex"]._explain_graph(graph_idx, init_state=init)
    assert got.shape == (12, 12)
    _close(got, np.asarray(want))
    assert np.allclose(got, got.T) and np.any(got > 0)
    # the default init, through the public entry point: a finite mask of the
    # graph's support
    adj = setup["bundle"]["adj"][graph_idx]
    mask = setup["ex"].explain(0, graph_idx=graph_idx)
    assert np.all(np.isfinite(mask)) and np.all((mask != 0) <= (adj.T != 0))


@pytest.mark.parametrize("idxs", [[1, 2], [0, 1, 2, 3]], ids=["2", "4"])
def test_explain_graphs_matches_tpugraph(setup, idxs):
    """``explain_graphs`` over graphs padded to one edge budget, each from
    tpugraph's init over that budget."""
    want = setup["ex_j"].explain_graphs(idxs)
    adjs = setup["bundle"]["adj"][idxs]
    e_pad = max(8, ((max(int((a != 0).sum()) for a in adjs) + 7) // 8) * 8)
    init = (np.stack([_jax_edge_init(setup, i, e_pad) for i in idxs]),
            np.zeros((len(idxs), 4), np.float32))
    got = setup["ex"].explain_graphs(idxs, init_state=init)
    assert len(got) == len(want) == len(idxs)
    for a, b in zip(got, want):
        _close(a, np.asarray(b))


def test_explain_graphs_each_as_alone(setup):
    """With the port's own init, each graph of a batch of 4 gets the mask
    it gets alone (its init covers its own edge budget only)."""
    idxs = [3, 0, 5, 2]
    batch = setup["ex"].explain_graphs(idxs)
    for i, mask in zip(idxs, batch):
        _close(mask, setup["ex"].explain_graphs([i])[0], ALONE_TOL)
    assert setup["ex"].explain_graphs([]) == []


@pytest.mark.parametrize("block", [8, 128])
def test_explain_graph_bcsr_matches_tpugraph(setup, block):
    """Tile space on the kernels' plain versions against tpugraph's
    ``explain_graph_bcsr`` (Pallas interpret mode), from tpugraph's tile
    init; the loss history too."""
    graph_idx = 2
    want = setup["ex_j"].explain_graph_bcsr(graph_idx, block=block)
    g = jax_graph_from_dense(setup["bundle"]["adj"][graph_idx])
    m = jax_bcsr.bcsr_from_coo(np.asarray(g.senders), np.asarray(g.receivers),
                               np.asarray(g.edge_weight), g.num_nodes_padded,
                               block=block)
    st = jax_bcsr_explain.init_tile_masks(
        jax.random.PRNGKey(0), m.num_tiles, block, 4, g.n_node,
        jax_module.ExplainConfig())
    ops.reset_launch_counts()
    got = setup["ex"].explain_graph_bcsr(
        graph_idx, block=block,
        init_state=(np.asarray(st.tile_logits), np.asarray(st.feat_logits)))
    assert sum(ops.launch_counts().values()) == 0  # CPU tensors: the twins
    assert got["graph_idx"] == graph_idx and got["masked_adj"].shape == (12, 12)
    _close(got["masked_adj"], np.asarray(want["masked_adj"]))
    _close(got["feat_mask"], np.asarray(want["feat_mask"]))
    for k in ("pred", "size", "ent", "feat_size", "lap", "total", "density"):
        np.testing.assert_allclose(got["history"][k], np.asarray(want["history"][k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    assert np.all(got["history"]["lap"] == 0)
    # the COO and tile paths learn the same function class: from the same
    # default seed both give masks on the graph's support
    coo = setup["ex"]._explain_graph(graph_idx)
    assert np.array_equal(coo != 0, got["masked_adj"] != 0)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """TOY trained by ``cli.train --bmname`` for each method (10 epochs)."""
    root = str(tmp_path_factory.mktemp("cli"))
    write_tu_dataset(root, "TOY")
    dirs = ["--platform", "cpu", "--datadir", root, "--bmname", "TOY",
            "--ckptdir", os.path.join(root, "ckpt"),
            "--logdir", os.path.join(root, "log"), "--max-nodes", "0"]
    summaries = {}
    for method, extra in (("base", []), ("att", []),
                          ("soft-assign", ["--linkpred", "--assign-ratio", "0.3"])):
        summaries[method] = cli_train.main(
            dirs + ["--method", method, "--epochs", "10", "--batch-size", "8",
                    "--eval-every", "5"] + extra)
    return dict(root=root, dirs=dirs, summaries=summaries)


@pytest.mark.parametrize("method", ["base", "att", "soft-assign"])
def test_cli_train_bmname(trained, method):
    """The summary's best-val and test results, and the graph task's meta
    and cg bundle in the checkpoint (``tpugraph/cli/tasks.py:300-318``)."""
    s = trained["summaries"][method]
    assert s["dataset"] == "TOY" and s["method"] == method
    assert set(s) == {"dataset", "method", "ckpt_path", "elapsed_s",
                      "best_val", "test_result", "train_curve"}
    assert s["train_curve"] == os.path.join(trained["root"], "log", "results",
                                            f"TOY_{method}_h20_o20.png")
    assert 0.0 <= s["test_result"]["acc"] <= 1.0
    with open(os.path.join(s["ckpt_path"], "meta.json")) as f:
        meta = json.load(f)
    assert meta["task"] == "graph" and meta["model_type"] == method
    assert (meta["num_classes"], meta["max_num_nodes"], meta["input_dim"]) == (2, 9, 2)
    assert meta["best_val"] == s["best_val"] and meta["test_result"] == s["test_result"]
    with np.load(os.path.join(s["ckpt_path"], "cg.npz")) as z:
        assert sorted(z.files) == ["adj", "feat", "label", "num_nodes", "pred"]
        assert z["adj"].shape == (24, 9, 9) and z["pred"].shape == (1, 24, 2)
    assert np.load(os.path.join(s["ckpt_path"], "train_idx.npy")).tolist() == list(range(19))


@pytest.mark.parametrize("method", ["base", "att"])
def test_cli_explain_graph_modes(trained, method):
    """``--graph-mode`` (graphs 1-4), ``--graph-idx 0`` and
    ``--multigraph-class 0`` on the checkpoint, as
    ``tests/test_tasks.py:178-219`` drives tpugraph's; each writes finite,
    square masks as ``.npy``."""
    keep = trained["dirs"] + ["--method", method, "--epochs", "5"]
    logdir = os.path.join(trained["root"], "log", f"TOY_{method}_h20_o20_explain")
    s = cli_explain.main(keep + ["--graph-mode"])
    viz = s.pop("viz")
    assert s == {"dataset": "TOY", "mode": "graph", "graph_indices": [1, 2, 3, 4]}
    assert viz == [os.path.join(logdir, f"graph_{gi}_0.pdf") for gi in (1, 2, 3, 4)]
    s = cli_explain.main(keep + ["--graph-idx", "0"])
    assert s.pop("viz") == [os.path.join(logdir, "graph_0_0.pdf")]
    assert s == {"dataset": "TOY", "mode": "graph", "graph_idx": 0,
                 "mask_shape": [9, 9]}
    s = cli_explain.main(keep + ["--multigraph-class", "0"])
    with np.load(os.path.join(trained["summaries"][method]["ckpt_path"],
                              "cg.npz")) as z:
        want = [i for i, lab in enumerate(z["label"]) if lab == 0][:31]
    assert s["graph_indices"] == want and len(want) > 1
    for gi in [1, 2, 3, 4] + want:
        mask = np.load(os.path.join(logdir, f"masked_adj_node_idx_0graph_idx_{gi}.npy"))
        assert mask.shape == (9, 9) and np.all(np.isfinite(mask))


def test_cli_explain_soft_assign_raises(trained):
    with pytest.raises(ValueError, match="soft-assign"):
        cli_explain.main(trained["dirs"] + ["--method", "soft-assign",
                                            "--graph-mode"])
