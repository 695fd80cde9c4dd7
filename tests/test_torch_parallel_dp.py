"""Data-parallel graph classification (``--dp N``) on gloo ranks: each rank
runs its contiguous slice of every batch, the loss is the whole batch's
mean and the gradients are summed, so the update is the single-device
one.  Mirrors ``tests/test_parallel.py:608`` on the TOY fixture (8
epochs, batches of 8):

* ``benchmark_task`` at ``--dp 2`` and ``--dp 4`` against the port's own
  single-device run, base, ``--bn`` (the whole batch's statistics),
  ``--dropout 0.1`` (each rank's slice of the whole batch's mask, as
  drawn on one device) and ``soft-assign --linkpred``: per-epoch losses at
  1e-5 relative plus 1e-6, the accuracies and the cg logits too;
* ``train_graph_classifier`` at 4 ranks from tpugraph's own initial
  weights against tpugraph's ``dp_devices=4`` on its 4-device virtual
  mesh: losses at tpugraph's 1e-3 relative plus 1e-4.

One group of 2 and one of 4 ranks run every port case."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_tasks import write_tu_dataset
from tpugraph.cli.config import Config as JaxConfig
from tpugraph.cli.tasks import benchmark_task as jax_benchmark_task
from tpugraph.data.pipeline import prepare_data as jax_prepare_data
from tpugraph.data.readers import read_graphfile as jax_read_graphfile
from tpugraph.nn import GcnEncoderGraph as JaxGcnEncoderGraph
from tpugraph_torch.cli.config import Config
from tpugraph_torch.cli.tasks import benchmark_task, build_graph_model, train_config
from tpugraph_torch.data.pipeline import prepare_data
from tpugraph_torch.data.readers import read_graphfile
from tpugraph_torch.nn import params_from_jax
from tpugraph_torch.parallel.launch import call_each, call_with_mesh, run_ranks
from tpugraph_torch.train import train_graph_classifier

torch.set_num_threads(1)

OPTIONS = {"base": {}, "bn": {"bn": True}, "dropout": {"dropout": 0.1},
           "linkpred": {"method": "soft-assign", "linkpred": True,
                        "assign_ratio": 0.3}}
COMMON = dict(bmname="TOY", num_epochs=8, batch_size=8, eval_every=8, max_nodes=0,
              seed=0)
PORT_TOL = dict(rtol=1e-5, atol=1e-6)
JAX_TOL = dict(rtol=1e-3, atol=1e-4)


def _cfg(root, tag, **kw):
    return Config(datadir=root, ckptdir=os.path.join(root, f"ck_{tag}"),
                  platform="cpu", **COMMON, **kw)


def _port_data(root, cfg):
    """The batchers ``benchmark_task`` builds (node-label features, the
    seeded split)."""
    graphs = read_graphfile(root, "TOY")
    for G in graphs:
        G.feat = {u: np.asarray(lab, dtype=np.float32) for u, lab in G.node_label.items()}
    train_b, val_b, test_b = prepare_data(graphs, train_ratio=cfg.train_ratio,
                                          test_ratio=cfg.test_ratio,
                                          features=cfg.feature_type,
                                          rng=np.random.default_rng(cfg.seed))
    return train_b, val_b, test_b


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tu"))
    write_tu_dataset(root, "TOY")
    out = {"single": {k: benchmark_task(_cfg(root, f"1_{k}", **kw))
                      for k, kw in OPTIONS.items()}}
    # tpugraph's data parallelism over 4 of its virtual devices, and the
    # port's from tpugraph's initial weights
    jcfg = JaxConfig(datadir=root, ckptdir=os.path.join(root, "ck_jax"), dp_devices=4,
                     **COMMON)
    out["jax"] = jax_benchmark_task(jcfg)
    cfg = _cfg(root, "jaxinit")
    train_b, val_b, test_b = _port_data(root, cfg)
    jg = jax_read_graphfile(root, "TOY")
    for G in jg:
        for u in G.nodes():
            G.nodes[u]["feat"] = np.asarray(G.nodes[u]["label"], dtype=np.float32)
    jtr = jax_prepare_data(jg, train_ratio=jcfg.train_ratio, test_ratio=jcfg.test_ratio,
                           features=jcfg.feature_type, rng=np.random.default_rng(0))[0]
    first = jtr.batch(np.arange(min(len(jtr), 8)))
    model_j = JaxGcnEncoderGraph(input_dim=jtr.feat_dim, hidden_dim=20, embedding_dim=20,
                                 label_dim=2, num_layers=3)
    init = model_j.init(jax.random.PRNGKey(0), jnp.asarray(first.feats),
                        jnp.asarray(first.adj), node_mask=jnp.asarray(first.node_mask))
    model = build_graph_model(cfg, train_b, 2, "cpu")
    model.load_state_dict(params_from_jax(init))
    jax_init_call = (call_with_mesh, (train_graph_classifier,
                                      (model, train_b, train_config(cfg)),
                                      dict(val_batcher=val_b, test_batcher=test_b,
                                           seed=0, device="cpu")), {})
    for n in (2, 4):
        calls = [(benchmark_task, (_cfg(root, f"{n}_{k}", dp_devices=n, **kw),), {})
                 for k, kw in OPTIONS.items()]
        res = run_ranks(call_each, n, "gloo", calls + ([jax_init_call] if n == 4 else []),
                        timeout_s=300)
        out[n] = dict(zip(OPTIONS, res))
        if n == 4:
            out["jax_init"] = res[-1]
    out["root"] = root
    return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_dp_matches_single_device(runs, n, option):
    one, dp = runs["single"][option], runs[n][option]
    np.testing.assert_allclose(dp["history"]["loss"], one["history"]["loss"], **PORT_TOL)
    for k in ("train_acc", "val_acc", "test_acc"):
        np.testing.assert_allclose(dp["history"][k], one["history"][k], atol=1e-12)
    np.testing.assert_allclose(dp["cg"]["pred"], one["cg"]["pred"], rtol=1e-4, atol=1e-5)
    assert dp["test_result"] == one["test_result"]
    assert (dp["best_val"]["epoch"], dp["best_val"]["acc"]) == (
        one["best_val"]["epoch"], one["best_val"]["acc"])
    np.testing.assert_allclose(dp["best_val"]["loss"], one["best_val"]["loss"], **PORT_TOL)
    assert sorted(os.listdir(dp["ckpt_path"])) == sorted(os.listdir(one["ckpt_path"]))


def test_dp_matches_tpugraph(runs):
    """From tpugraph's initial weights, 4 ranks follow tpugraph's
    ``dp_devices=4`` loss trajectory (tests/test_parallel.py:608's
    tolerance)."""
    np.testing.assert_allclose(runs["jax_init"]["history"]["loss"],
                               runs["jax"]["history"]["loss"], **JAX_TOL)


def test_dp_batch_must_divide(runs):
    """tpugraph's error: a batch size the mesh does not divide."""
    cfg = _cfg(runs["root"], "bad", dp_devices=3)
    with pytest.raises(RuntimeError, match="batch_size 8 must divide by the 3-device mesh"):
        benchmark_task(cfg)
