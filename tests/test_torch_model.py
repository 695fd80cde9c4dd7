"""The port's GcnEncoderNode and training loop against tpugraph's on the
BCSR, resident-stacked and edge-packet paths (Pallas kernels in interpret
mode), from the same parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugraph.core.graph import graph_from_networkx as jax_graph_from_networkx
from tpugraph.data.gengraph import gen_syn1 as jax_gen_syn1
from tpugraph.nn import GcnEncoderNode as JaxGcnEncoderNode
from tpugraph.nn.layers import BCSRAdj as JaxBCSRAdj, SparseAdj
from tpugraph.nn.losses import node_cross_entropy as jax_node_ce
from tpugraph.ops import bcsr as jax_bcsr
from tpugraph.train import loop as jax_loop
from tpugraph_torch.core.graph import graph_from_edge_list
from tpugraph_torch.data import gen_syn1
from tpugraph_torch.nn import (BCSRAdj, GcnEncoderNode, PacketAdj,
                                StackedAdj, params_from_jax)
from tpugraph_torch.nn.losses import node_cross_entropy
from tpugraph_torch.ops import bcsr
from tpugraph_torch.train import TrainConfig, train_node_classifier

torch.set_num_threads(1)

DIMS = dict(input_dim=10, hidden_dim=20, embedding_dim=20, label_dim=4,
            num_layers=3)


@pytest.fixture(scope="module")
def syn1():
    """syn1 (seed 0) in both packages, random features, and JAX params."""
    G_j, labels, _ = jax_gen_syn1(seed=0)
    G_t, _, _ = gen_syn1(seed=0)
    g_j = jax_graph_from_networkx(G_j)
    g_t = graph_from_edge_list(G_t.number_of_nodes(), G_t.edges())
    rng = np.random.default_rng(0)
    feat = np.zeros((g_t.num_nodes_padded, 10), np.float32)
    feat[: g_t.n_node] = rng.standard_normal((g_t.n_node, 10))
    model_j = JaxGcnEncoderNode(**DIMS)
    params = model_j.init(jax.random.PRNGKey(0), jnp.asarray(feat),
                          SparseAdj(g_j.senders, g_j.receivers, g_j.edge_weight))
    return dict(G_j=G_j, labels=np.asarray(labels), g_j=g_j, g_t=g_t,
                feat=feat, model_j=model_j, params=params)


def test_gcn_encoder_logits_and_grads_match(syn1):
    g = syn1["g_t"]
    s, r, w = g.senders.numpy(), g.receivers.numpy(), g.edge_weight.numpy()
    n = g.num_nodes_padded
    m_j = jax_bcsr.bcsr_from_coo(s, r, w, n)
    mt_j = jax_bcsr.bcsr_transpose_host(s, r, w, n)
    x = np.zeros((m_j.num_nodes, 10), np.float32)
    x[:n] = syn1["feat"]
    y = np.zeros((m_j.num_nodes,), np.int32)
    y[: g.n_node] = syn1["labels"]
    mask = np.zeros((m_j.num_nodes,), np.float32)
    mask[: g.n_node: 2] = 1.0

    def loss_j(p):
        logits, _ = syn1["model_j"].apply(p, jnp.asarray(x),
                                          JaxBCSRAdj(m_j, mt_j))
        return jax_node_ce(logits, jnp.asarray(y),
                           node_mask=jnp.asarray(mask)), logits

    (l_ref, logits_ref), grads_ref = jax.value_and_grad(
        loss_j, has_aux=True)(syn1["params"])

    model = GcnEncoderNode(**DIMS, device="cpu")
    model.load_state_dict(params_from_jax(syn1["params"]))
    adj = BCSRAdj(bcsr.bcsr_from_coo(s, r, w, n).to("cpu"),
                  bcsr.bcsr_transpose_host(s, r, w, n).to("cpu"))
    logits, _ = model(torch.from_numpy(x), adj)
    loss = node_cross_entropy(logits, torch.from_numpy(y),
                              node_mask=torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(l_ref), rtol=1e-5)
    grads = params_from_jax(grads_ref)
    named = dict(model.named_parameters())
    assert set(grads) == set(named)
    for k, gref in grads.items():
        np.testing.assert_allclose(named[k].grad.numpy(), gref.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_training_trajectory_matches(syn1):
    epochs = 20
    cfg_j = jax_loop.TrainConfig(num_epochs=epochs, use_bcsr=True,
                                 bcsr_format="tiles", bcsr_resident="off",
                                 scan_chunk=epochs)
    out_j = jax_loop.train_node_classifier(
        syn1["model_j"], syn1["g_j"], syn1["feat"], syn1["labels"], cfg_j,
        init_params=syn1["params"])
    model = GcnEncoderNode(**DIMS, device="cpu")
    out = train_node_classifier(
        model, syn1["g_t"], syn1["feat"], syn1["labels"],
        TrainConfig(num_epochs=epochs, use_bcsr=True),
        init_params=params_from_jax(syn1["params"]), device="cpu")
    np.testing.assert_array_equal(out["train_idx"], out_j["train_idx"])
    np.testing.assert_allclose(out["history"]["loss"], out_j["history"]["loss"],
                               rtol=1e-4, atol=1e-4)
    assert out["history"]["loss"][-1] < out["history"]["loss"][0]
    np.testing.assert_allclose(out["ypred"], np.asarray(out_j["ypred"]),
                               rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def small_syn1():
    """The small syn1 of tests/test_train.py:145-159 in both packages,
    random features and JAX params."""
    from tpugraph.data import featgen as jax_featgen
    from tpugraph_torch.data.featgen import ConstFeatureGen

    kw = dict(nb_shapes=8, width_basis=40, seed=3)
    G_j, labels, _ = jax_gen_syn1(
        feature_generator=jax_featgen.ConstFeatureGen(np.ones(10, np.float32)),
        **kw)
    G_t, labels_t, _ = gen_syn1(
        feature_generator=ConstFeatureGen(np.ones(10, np.float32)), **kw)
    assert list(labels) == list(labels_t)
    g_j = jax_graph_from_networkx(G_j)
    g_t = graph_from_edge_list(G_t.number_of_nodes(), G_t.edges())
    rng = np.random.default_rng(1)
    feat = np.zeros((g_t.num_nodes_padded, 10), np.float32)
    feat[: g_t.n_node] = rng.standard_normal((g_t.n_node, 10))
    dims = dict(input_dim=10, hidden_dim=8, embedding_dim=8,
                label_dim=int(max(labels)) + 1, num_layers=3)
    model_j = JaxGcnEncoderNode(**dims)
    params = model_j.init(jax.random.PRNGKey(0), jnp.asarray(feat),
                          SparseAdj(g_j.senders, g_j.receivers, g_j.edge_weight))
    return dict(g_j=g_j, g_t=g_t, labels=np.asarray(labels), feat=feat,
                dims=dims, model_j=model_j, params=params)


@pytest.mark.parametrize("fmt", [
    dict(bcsr_resident="on"),
    dict(bcsr_format="packets", packet_geom=(32, 32, 8)),
    dict(bcsr_k_pack=4),
    dict(bcsr_k_pack=-1),
])
def test_format_training_trajectory_matches(small_syn1, fmt):
    """20 epochs in each static-weight format from the same parameters:
    the loss trajectory and predictions match tpugraph's (int8 tiles and
    f32 packet compute are exact here, so only summation order differs;
    1e-5 relative)."""
    d = small_syn1
    epochs = 20
    out_j = jax_loop.train_node_classifier(
        d["model_j"], d["g_j"], d["feat"], d["labels"],
        jax_loop.TrainConfig(num_epochs=epochs, scan_chunk=epochs,
                             use_bcsr=True, **fmt),
        init_params=d["params"])
    out = train_node_classifier(
        GcnEncoderNode(**d["dims"], device="cpu"), d["g_t"], d["feat"],
        d["labels"], TrainConfig(num_epochs=epochs, use_bcsr=True, **fmt),
        init_params=params_from_jax(d["params"]), device="cpu")
    np.testing.assert_allclose(out["history"]["loss"], out_j["history"]["loss"],
                               rtol=1e-5, atol=0)
    assert out["history"]["loss"][-1] < out["history"]["loss"][0]
    ypred_j = np.asarray(out_j["ypred"])
    assert out["ypred"].shape == ypred_j.shape
    np.testing.assert_allclose(out["ypred"], ypred_j, rtol=1e-5,
                               atol=1e-5 * np.abs(ypred_j).max())
    kind = {"bcsr_resident": StackedAdj, "bcsr_format": PacketAdj,
            "bcsr_k_pack": BCSRAdj}[next(iter(fmt))]
    assert isinstance(out["adj"], kind)
