"""The explainer's query sharding (``mesh=``) on gloo ranks, against the
port's own single-device runs and tpugraph's sharded runs on its 8
virtual CPU devices; mirrors ``tests/test_parallel.py:84`` and
``tests/test_explain.py:176`` on syn1 (seed 0) with flax's random
weights, random features and random predicted labels:

* ``explain_nodes_batch(mesh=)`` at 2 and 4 ranks on 3 queries (the
  last rank's block padded), ``seed_ensemble`` 1 and 2 and with
  ``marginalize``: every result equals the single-device run within
  1e-6; from tpugraph's own inits (``jax.random.split(PRNGKey(0), 8)``
  over its padded list, passed as ``init_state``) ``masked_adj`` is
  within 1e-4 of tpugraph's ``explain_nodes_batch(mesh=mesh8)``;
* ``explain_nodes_bcsr(mesh=)`` at 2 ranks on 5 queries (3 rounds, the
  last padded): the sequential run within 1e-6, and from tpugraph's
  tile inits its 8-device sharded run within 1e-5 on ``masked_adj`` and
  ``feat_mask``;
* ``explain_nodes_gnn_stats(mesh=)`` at 2 ranks: the AUC of the
  single-device run.

One group of 2 and one of 4 ranks run every port case."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from tpugraph.core.graph import graph_from_dense as jax_graph_from_dense
from tpugraph.core.khop import khop_subgraph as jax_khop
from tpugraph.data.gengraph import gen_syn1 as jax_gen_syn1
from tpugraph.data.gengraph import preprocess_input_graph as jax_preprocess
from tpugraph.explain import bcsr_explain as jax_bx
from tpugraph.explain import module as jax_module
from tpugraph.explain.explainer import Explainer as JaxExplainer
from tpugraph.nn import GcnEncoderNode as JaxGcnEncoderNode
from tpugraph.nn.layers import SparseAdj as JaxSparseAdj
from tpugraph_torch.explain import Explainer, ExplainConfig
from tpugraph_torch.nn import GcnEncoderNode, params_from_jax
from tpugraph_torch.parallel.launch import call_each, call_with_mesh, run_ranks

torch.set_num_threads(1)

DIMS = dict(input_dim=10, hidden_dim=20, embedding_dim=20, label_dim=4,
            num_layers=3)
EPOCHS = 20
QUERIES = [400, 405, 410]
BCSR_QUERIES = list(range(400, 700, 60))
STATS = list(range(400, 700, 10))
COO_CASES = {"ens1": {}, "ens2": {"seed_ensemble": 2},
             "marginalize": {"marginalize": True}}
PORT_TOL = dict(rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def syn1():
    G, labels, _ = jax_gen_syn1(seed=0)
    cg = jax_preprocess(G, labels)
    adj = cg["adj"]
    n = adj.shape[1]
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((1, n, 10)).astype(np.float32)
    pred = np.zeros((1, n, 4), np.float32)
    pred[0, np.arange(n), rng.integers(0, 4, n)] = 1.0
    gj = jax_graph_from_dense(adj[0])
    x = np.zeros((gj.num_nodes_padded, 10), np.float32)
    x[:n] = feat[0]
    model_j = JaxGcnEncoderNode(**DIMS)
    params = model_j.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          JaxSparseAdj(gj.senders, gj.receivers, gj.edge_weight))
    model = GcnEncoderNode(**DIMS, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return dict(adj=adj, feat=feat, label=cg["labels"], pred=pred, gj=gj,
                model_j=model_j, params=params, model=model)


def _ex(syn1, **cfg):
    return Explainer(syn1["model"], None, syn1["adj"], syn1["feat"], syn1["label"],
                     syn1["pred"], cfg=ExplainConfig(num_epochs=EPOCHS, **cfg),
                     dataset="syn1", device="cpu")


def _jax_ex(syn1):
    return JaxExplainer(syn1["model_j"], syn1["params"], syn1["adj"], syn1["feat"],
                        syn1["label"], syn1["pred"], n_hops=3, dataset="syn1",
                        cfg=jax_module.ExplainConfig(num_epochs=EPOCHS))


def _num_sub(syn1, node):
    return jax_khop(syn1["gj"], jnp.int32(node), 3).num_nodes


def _jax_coo_init(syn1):
    """tpugraph's inits of ``QUERIES`` padded to its 8 devices."""
    gj = syn1["gj"]
    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    cfg = jax_module.ExplainConfig(num_epochs=EPOCHS)
    edge = np.stack([np.asarray(jax_module.init_masks(
        keys[q], gj.num_edges_padded, 10, _num_sub(syn1, node), cfg).edge_logits)
        for q, node in enumerate(QUERIES)])
    return edge, np.zeros((len(QUERIES), 10), np.float32), None


def _jax_tile_inits(syn1, ex):
    m = ex._bcsr_pack(0, 128)[1]
    cfg = jax_module.ExplainConfig(num_epochs=EPOCHS)
    out = []
    for node in BCSR_QUERIES:
        st = jax_bx.init_tile_masks(jax.random.PRNGKey(0), m.num_tiles, m.block, 10,
                                    _num_sub(syn1, node), cfg)
        out.append((np.asarray(st.tile_logits), np.asarray(st.feat_logits)))
    return out


def _sharded(fn, ex, *args, **kw):
    return (call_with_mesh, (fn, (ex,) + args, kw), {})


@pytest.fixture(scope="module")
def runs(syn1):
    port = _ex(syn1)
    coo_init = _jax_coo_init(syn1)
    tile_inits = _jax_tile_inits(syn1, port)
    out = {"single": {k: _ex(syn1, **kw).explain_nodes_batch(QUERIES)
                      for k, kw in COO_CASES.items()},
           "single_jax_init": port.explain_nodes_batch(QUERIES, init_state=coo_init),
           "seq_bcsr": port.explain_nodes_bcsr(BCSR_QUERIES),
           "seq_bcsr_jax_init": port.explain_nodes_bcsr(BCSR_QUERIES,
                                                        init_state=tile_inits),
           "stats": port.explain_nodes_gnn_stats(STATS)["auc"]}
    batch = Explainer.explain_nodes_batch
    for n in (2, 4):
        calls = [_sharded(batch, _ex(syn1, **kw), QUERIES) for kw in COO_CASES.values()]
        calls.append(_sharded(batch, port, QUERIES, init_state=coo_init))
        if n == 2:
            calls += [_sharded(Explainer.explain_nodes_bcsr, port, BCSR_QUERIES),
                      _sharded(Explainer.explain_nodes_bcsr, port, BCSR_QUERIES,
                               init_state=tile_inits),
                      _sharded(Explainer.explain_nodes_gnn_stats, port, STATS)]
        res = run_ranks(call_each, n, "gloo", calls, timeout_s=300)
        out[n] = dict(zip(list(COO_CASES) + ["jax_init", "bcsr", "bcsr_jax_init",
                                             "stats"], res))
    mesh8 = JaxMesh(np.array(jax.devices()[:8]), ("data",))
    ex_j = _jax_ex(syn1)
    out["jax"] = ex_j.explain_nodes_batch(QUERIES, mesh=mesh8)
    out["jax_bcsr"] = ex_j.explain_nodes_bcsr(BCSR_QUERIES, mesh=mesh8)
    return out


def _same(got, want, tol, keys=("masked_adj", "feat_mask")):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["node_idx"] == b["node_idx"]
        assert a["node_idx_new"] == b["node_idx_new"]
        np.testing.assert_array_equal(a["neighbors"], b["neighbors"])
        for k in keys:
            np.testing.assert_allclose(a[k], b[k], **tol, err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", list(COO_CASES))
def test_coo_sharding_matches_one_device(runs, n, case):
    got, want = runs[n][case], runs["single"][case]
    _same(got, want, PORT_TOL)
    for a, b in zip(got, want):
        assert set(a["history"]) == set(b["history"])
        for k, v in b["history"].items():
            np.testing.assert_allclose(a["history"][k], v, **PORT_TOL, err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
def test_coo_sharding_matches_tpugraph(runs, n):
    """From tpugraph's inits: tpugraph's 8-device sharded masks at
    tests/test_parallel.py:84's 1e-4, and the port's one device within
    1e-6."""
    _same(runs[n]["jax_init"], runs["single_jax_init"], PORT_TOL)
    _same(runs[n]["jax_init"], runs["jax"], dict(rtol=0, atol=1e-4),
          keys=("masked_adj",))


def test_bcsr_sharding_matches_sequential(runs):
    _same(runs[2]["bcsr"], runs["seq_bcsr"], PORT_TOL)
    for a, b in zip(runs[2]["bcsr"], runs["seq_bcsr"]):
        for k, v in b["history"].items():
            np.testing.assert_allclose(a["history"][k], v, **PORT_TOL, err_msg=k)


def test_bcsr_sharding_matches_tpugraph(runs):
    """From tpugraph's tile inits: its 8-device sharded run within 1e-5
    (tests/test_explain.py:176's tolerance), the sequential port within
    1e-6."""
    _same(runs[2]["bcsr_jax_init"], runs["seq_bcsr_jax_init"], PORT_TOL)
    _same(runs[2]["bcsr_jax_init"], runs["jax_bcsr"], dict(rtol=0, atol=1e-5))


def test_stats_auc_unchanged_by_sharding(runs):
    assert runs[2]["stats"]["auc"] == runs["stats"]
    assert len(runs[2]["stats"]["masked_adjs"]) == len(STATS)
