"""The port's halo trainer (``train_node_classifier_halo``, ``--halo N``)
across 4 gloo ranks against tpugraph's on a 4-device virtual CPU mesh,
from the same graph, features, labels, split and flax weights; mirrors
``tests/test_parallel.py:883`` (locality partition, block 8, overlap off
and on, COO and tiles, with and without attention).  Epoch 0's loss is
held at 1e-5, the 6-epoch trajectory at 2e-4 (tpugraph's own test: 2e-3),
the accuracies exactly, and ``ypred`` in the original node ids at
tpugraph's 5e-2 relative plus 5e-3.

It also pins tpugraph's halo gradient factor on both packages: one SGD
step without clip or decay moves every parameter ``n_dev`` times as far as
the single-device step (``ROADMAP.md`` section 3), the port's halo step
equal to tpugraph's; and the 2-D ``("dcn", "data")`` mesh trains as the
1-D one.  One group of 4 ranks runs every port case."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpugraph.core.graph import graph_from_dense as jax_graph_from_dense
from tpugraph.nn import GcnEncoderNode as JaxGcnEncoderNode
from tpugraph.nn.layers import SparseAdj as JaxSparseAdj
from tpugraph.train import loop as jax_loop
from tpugraph_torch.core.graph import graph_from_dense
from tpugraph_torch.nn import GcnEncoderNode, params_from_jax
from tpugraph_torch.parallel.launch import call_each, run_ranks
from tpugraph_torch.train import loop

torch.set_num_threads(1)

N_DEV = 4
ROWS = {  # name: (attention, use_bcsr, overlap)
    "coo_off": (False, False, "off"),
    "bcsr_on": (False, True, "on"),
    "att_coo_on": (True, False, "on"),
    "att_bcsr_off": (True, True, "off"),
}
SGD = dict(opt="sgd", lr=0.5, clip=0.0, weight_decay=0.0, num_epochs=1, eval_every=1)


def _problem():
    rng = np.random.default_rng(0)
    a = (rng.random((64, 64)) < 0.07).astype(np.float32)
    a = np.triu(a, 1)
    a = a + a.T
    feat = rng.standard_normal((64, 6)).astype(np.float32)
    labels = rng.integers(0, 3, 64).astype(np.int64)
    return a, feat, labels


def _models(att, gj, feat):
    dims = dict(input_dim=6, hidden_dim=8, embedding_dim=8, label_dim=3,
                num_layers=2, att=att)
    model_j = JaxGcnEncoderNode(**dims)
    params = model_j.init(jax.random.PRNGKey(0), jnp.asarray(feat),
                          JaxSparseAdj(gj.senders, gj.receivers, gj.edge_weight))
    model = GcnEncoderNode(**dims, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model_j, params, model


@pytest.fixture(scope="module")
def runs():
    a, feat, labels = _problem()
    g, gj = graph_from_dense(a), jax_graph_from_dense(a)
    wants, calls = {}, []
    for name, (att, bcsr, ov) in ROWS.items():
        model_j, _, model = _models(att, gj, feat)
        cfg_kw = dict(num_epochs=6, eval_every=3, use_bcsr=bcsr, bcsr_block=8)
        wants[name] = jax_loop.train_node_classifier_halo(
            model_j, gj, feat, labels, jax_loop.TrainConfig(**cfg_kw), n_dev=N_DEV,
            overlap=ov, partition="locality", seed=0)
        calls.append((loop.train_node_classifier_halo,
                      (model, g, feat, labels, loop.TrainConfig(**cfg_kw), N_DEV),
                      dict(overlap=ov, partition="locality", seed=0)))
    # one SGD step on each package's halo path and on one device
    model_j, params, model = _models(False, gj, feat)
    wants["sgd"] = {
        "p0": params_from_jax(params),
        "halo": params_from_jax(jax_loop.train_node_classifier_halo(
            model_j, gj, feat, labels, jax_loop.TrainConfig(**SGD), n_dev=N_DEV,
            overlap="off", seed=0)["params"]),
        "single": params_from_jax(jax_loop.train_node_classifier(
            model_j, gj, feat, labels, jax_loop.TrainConfig(**SGD), seed=0)["params"]),
        "port_single": loop.train_node_classifier(
            GcnEncoderNode(6, 8, 8, 3, 2, device="cpu"), g, feat, labels,
            loop.TrainConfig(**SGD), seed=0, init_params=params_from_jax(params),
            device="cpu")["params"],
    }
    calls.append((loop.train_node_classifier_halo,
                  (model, g, feat, labels, loop.TrainConfig(**SGD), N_DEV),
                  dict(overlap="off", seed=0)))
    # the 2-D mesh (two hosts of two devices) against the 1-D row
    _, _, model2 = _models(False, gj, feat)
    wants["2d"] = None
    calls.append((loop.train_node_classifier_halo,
                  (model2, g, feat, labels,
                   loop.TrainConfig(num_epochs=6, eval_every=3), N_DEV),
                  dict(axis=("dcn", "data"), overlap="off", seed=0)))
    got = run_ranks(call_each, N_DEV, "gloo", calls, timeout_s=300)
    return {name: (wants[name], res) for name, res in zip(wants, got)}


@pytest.mark.parametrize("name", list(ROWS))
def test_halo_trainer_matches_tpugraph(runs, name):
    want, got = runs[name]
    np.testing.assert_allclose(got["history"]["loss"][0], want["history"]["loss"][0],
                               rtol=1e-5)
    np.testing.assert_allclose(got["history"]["loss"], want["history"]["loss"],
                               rtol=2e-4)
    for k in ("train_acc", "test_acc"):
        np.testing.assert_allclose(got["history"][k], want["history"][k], atol=1e-6)
    np.testing.assert_array_equal(got["train_idx"], want["train_idx"])
    assert got["halo_size"] == want["halo_size"] and got["n_dev"] == N_DEV
    assert got["ypred"].shape == want["ypred"].shape
    np.testing.assert_allclose(got["ypred"], want["ypred"], rtol=5e-2, atol=5e-3)


def test_halo_gradient_factor_is_n_dev(runs):
    """tpugraph's halo step psums the loss inside value_and_grad and the
    gradients again: its update is n_dev times the single-device one.  The
    port reproduces it (within 1e-5 of the largest update plus two float32
    ulps of the largest parameter, the rounding of ``p1 - p0``), and each
    package's single-device step is the true one."""
    want, got = runs["sgd"]
    p0 = want["p0"]
    for k in p0:
        single_j = want["single"][k] - p0[k]
        halo_j = want["halo"][k] - p0[k]
        single_t = want["port_single"][k] - p0[k]
        halo_t = got["params"][k] - p0[k]
        tol = (1e-5 * N_DEV * float(single_j.abs().max())
               + 2 * float(np.finfo(np.float32).eps) * float(p0[k].abs().max()))
        assert float(single_j.abs().max()) > 0
        for a, b in ((halo_j, N_DEV * single_j), (halo_t, N_DEV * single_t),
                     (halo_t, halo_j), (single_t, single_j)):
            assert float((a - b).abs().max()) <= tol, k


def test_halo_trainer_2d_mesh(runs):
    """``axis=("dcn", "data")``: a (2, 2) mesh and the hierarchical
    exchange train as the flat 1-D mesh (1e-6)."""
    _, flat = runs["coo_off"]
    _, got = runs["2d"]
    np.testing.assert_allclose(got["history"]["loss"], flat["history"]["loss"],
                               rtol=1e-6)
    np.testing.assert_allclose(got["ypred"], flat["ypred"], rtol=0, atol=1e-6)
