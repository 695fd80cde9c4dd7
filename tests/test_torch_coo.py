"""The port's COO main path against tpugraph's on the CPU, from the same
numpy inputs and parameters: the message-passing ops and their dense
oracles, GcnEncoderNode on SparseAdj, COO training, the k-hop masks and
the COO GNNExplainer (mask weights, loss terms, gradients, Adam steps,
the batched explainer)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugraph.cli.tasks import padded_features as jax_padded_features
from tpugraph.core import khop as jax_khop
from tpugraph.core.graph import graph_from_networkx as jax_graph_from_networkx
from tpugraph.data import featgen as jax_featgen
from tpugraph.data.gengraph import gen_syn1 as jax_gen_syn1
from tpugraph.explain import module as jax_module
from tpugraph.nn import GcnEncoderNode as JaxGcnEncoderNode
from tpugraph.nn.layers import SparseAdj as JaxSparseAdj
from tpugraph.nn.losses import node_cross_entropy as jax_node_ce
from tpugraph.ops import dense as jax_dense
from tpugraph.ops import message as jax_message
from tpugraph.train import loop as jax_loop
from tpugraph_torch.cli.tasks import padded_features
from tpugraph_torch.core import khop
from tpugraph_torch.core.graph import graph_from_edge_list, graph_from_networkx
from tpugraph_torch.data import ConstFeatureGen, gen_syn1, preprocess_input_graph
from tpugraph_torch.explain import Explainer, ExplainConfig
from tpugraph_torch.explain import module
from tpugraph_torch.nn import GcnEncoderNode, SparseAdj, params_from_jax
from tpugraph_torch.nn.losses import node_cross_entropy
from tpugraph_torch.ops import dense, message
from tpugraph_torch.parallel.launch import single_rank
from tpugraph_torch.parallel.mesh import make_mesh
from tpugraph_torch.train import TrainConfig, train_node_classifier

torch.set_num_threads(1)

DIMS = dict(input_dim=10, hidden_dim=20, embedding_dim=20, label_dim=4,
            num_layers=3)
NODE = 305
QUERIES = [305, 410, 602]


def _t(a):
    return torch.from_numpy(np.array(a))


def _edges(seed, n=50, e=300, d=16):
    """Random COO edges with duplicates, self-loops and zero-weight
    (padding) edges, and features."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n - 5, e).astype(np.int32)  # the last 5 receive nothing
    w = rng.standard_normal(e).astype(np.float32)
    w[rng.random(e) < 0.1] = 0.0
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.standard_normal((n, d)).astype(np.float32)
    return s, r, w, x, y


@pytest.mark.parametrize("seed", [0, 1])
def test_spmm_and_sddmm_match(seed):
    s, r, w, x, y = _edges(seed)
    np.testing.assert_allclose(
        message.spmm(_t(s), _t(r), _t(w), _t(x)).numpy(),
        np.asarray(jax_message.spmm(s, r, w, x)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        message.spmm(_t(s).long(), _t(r).long(), _t(w), _t(x), 64).numpy(),
        np.asarray(jax_message.spmm(s, r, w, x, 64)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        message.sddmm(_t(s), _t(r), _t(x), _t(y)).numpy(),
        np.asarray(jax_message.sddmm(s, r, x, y)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_segment_softmax_matches(masked):
    """Padding edges masked out, one segment with no edge and one whose
    edges are all masked: both divide by the 1e-16 floor."""
    rng = np.random.default_rng(3)
    e, nseg = 200, 12
    seg = rng.integers(0, nseg - 1, e).astype(np.int32)  # segment 11: empty
    logits = (3 * rng.standard_normal(e)).astype(np.float32)
    mask = (rng.random(e) < 0.8).astype(np.float32)
    mask[seg == 4] = 0.0                                 # segment 4: all masked
    em = mask if masked else None
    ref = np.asarray(jax_message.segment_softmax(
        logits, seg, nseg, None if em is None else jnp.asarray(em)))
    out = message.segment_softmax(_t(logits), _t(seg), nseg,
                                  None if em is None else _t(em)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    if masked:
        assert np.all(out[mask == 0] == 0)


def test_sym_normalize_weights_matches():
    s, r, w, _, _ = _edges(4)
    w = np.abs(w)
    np.testing.assert_allclose(
        message.sym_normalize_weights(_t(s), _t(r), _t(w), 50).numpy(),
        np.asarray(jax_message.sym_normalize_weights(s, r, w, 50)),
        rtol=1e-6, atol=1e-7)


def test_dense_oracles_match():
    rng = np.random.default_rng(5)
    adj = rng.standard_normal((2, 30, 30)).astype(np.float32)
    adj[rng.random(adj.shape) < 0.7] = 0.0
    a = rng.standard_normal((2, 30, 8)).astype(np.float32)
    b = rng.standard_normal((2, 30, 8)).astype(np.float32)
    np.testing.assert_allclose(dense.dense_spmm(_t(adj), _t(a)).numpy(),
                               np.asarray(jax_dense.dense_spmm(adj, a)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dense.dense_sddmm(_t(adj), _t(a), _t(b)).numpy(),
                               np.asarray(jax_dense.dense_sddmm(adj, a, b)),
                               rtol=1e-6, atol=1e-6)
    # the COO spmm equals the dense oracle on the same edges
    s, r, w, x, _ = _edges(6)
    dense_adj = np.zeros((50, 50), np.float32)
    np.add.at(dense_adj, (r, s), w)
    np.testing.assert_allclose(
        message.spmm(_t(s), _t(r), _t(w), _t(x)).numpy(),
        dense.dense_spmm(_t(dense_adj), _t(x)).numpy(), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def syn1():
    """syn1 (seed 0) in both packages, random features and labels, JAX
    params, and the port's encoder loaded with them."""
    G_j, labels, _ = jax_gen_syn1(seed=0)
    G_t, _, _ = gen_syn1(seed=0)
    g_j = jax_graph_from_networkx(G_j)
    g_t = graph_from_edge_list(G_t.number_of_nodes(), G_t.edges())
    rng = np.random.default_rng(0)
    feat = np.zeros((g_t.num_nodes_padded, 10), np.float32)
    feat[: g_t.n_node] = rng.standard_normal((g_t.n_node, 10))
    model_j = JaxGcnEncoderNode(**DIMS)
    params = model_j.init(jax.random.PRNGKey(0), jnp.asarray(feat),
                          JaxSparseAdj(g_j.senders, g_j.receivers,
                                       g_j.edge_weight))
    model = GcnEncoderNode(**DIMS, device="cpu")
    model.load_state_dict(params_from_jax(params))
    model.requires_grad_(False)
    pred_vec = np.zeros((g_t.num_nodes_padded,), np.int32)
    pred_vec[: g_t.n_node] = rng.integers(0, 4, g_t.n_node)
    return dict(G_j=G_j, G_t=G_t, labels=np.asarray(labels), g_j=g_j,
                g_t=g_t, feat=feat, model_j=model_j, params=params,
                model=model, pred_vec=pred_vec)


@pytest.mark.parametrize("normalize", [False, True])
def test_graph_from_networkx_matches(syn1, normalize):
    """On tpugraph's networkx syn1 and on the port's networkx-free copy of
    it: tpugraph's arrays, with normalization and node/edge budgets."""
    kw = dict(normalize=normalize, num_nodes_padded=712, num_edges_padded=4200)
    want = jax_graph_from_networkx(syn1["G_j"], **kw)
    for G in (syn1["G_j"], syn1["G_t"]):
        got = graph_from_networkx(G, **kw)
        for f in ("senders", "receivers", "edge_weight", "node_mask", "edge_pair"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)), err_msg=f)
        assert (got.n_node, got.n_edge) == (int(want.n_node), int(want.n_edge))
        assert got.num_nodes_padded == 712 and got.num_edges_padded == 4200


def test_cli_graph_and_features_match(syn1):
    """The CLI's syn1 (constant features of --input-dim): the padded graph,
    edge_pair included, and the padded features are byte-identical."""
    kw = dict(seed=0)
    G_j, _, _ = jax_gen_syn1(feature_generator=jax_featgen.ConstFeatureGen(
        np.ones(10, np.float32)), **kw)
    G_t, _, _ = gen_syn1(feature_generator=ConstFeatureGen(
        np.ones(10, np.float32)), **kw)
    g_j = jax_graph_from_networkx(G_j)
    g_t = graph_from_edge_list(G_t.number_of_nodes(), G_t.edges())
    for name in ("senders", "receivers", "edge_weight", "node_mask",
                 "edge_pair"):
        a, b = np.asarray(getattr(g_j, name)), getattr(g_t, name).numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert int(g_j.n_node) == g_t.n_node and int(g_j.n_edge) == g_t.n_edge
    assert (jax_padded_features(G_j, g_j).tobytes()
            == padded_features(G_t, g_t).tobytes())


def test_encoder_on_sparse_adj_matches(syn1):
    """Forward logits, loss and every parameter gradient on SparseAdj
    against jax.grad, at 1e-5."""
    g = syn1["g_t"]
    x = syn1["feat"]
    y = np.zeros((g.num_nodes_padded,), np.int32)
    y[: g.n_node] = syn1["labels"]
    mask = np.zeros((g.num_nodes_padded,), np.float32)
    mask[: g.n_node: 2] = 1.0
    g_j = syn1["g_j"]

    def loss_j(p):
        logits, _ = syn1["model_j"].apply(
            p, jnp.asarray(x), JaxSparseAdj(g_j.senders, g_j.receivers,
                                            g_j.edge_weight))
        return jax_node_ce(logits, jnp.asarray(y),
                           node_mask=jnp.asarray(mask)), logits

    (l_ref, logits_ref), grads_ref = jax.value_and_grad(
        loss_j, has_aux=True)(syn1["params"])
    model = GcnEncoderNode(**DIMS, device="cpu")
    model.load_state_dict(params_from_jax(syn1["params"]))
    logits, _ = model(_t(x), SparseAdj(g.senders, g.receivers, g.edge_weight))
    loss = node_cross_entropy(logits, _t(y), node_mask=_t(mask))
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


def test_coo_training_trajectory_matches(syn1):
    """20 COO epochs from the same parameters: the split, the loss and
    accuracy trajectories and the final predictions, at 1e-5."""
    epochs = 20
    out_j = jax_loop.train_node_classifier(
        syn1["model_j"], syn1["g_j"], syn1["feat"], syn1["labels"],
        jax_loop.TrainConfig(num_epochs=epochs, use_bcsr=False),
        init_params=syn1["params"])
    logged = []
    out = train_node_classifier(
        GcnEncoderNode(**DIMS, device="cpu"), syn1["g_t"], syn1["feat"],
        syn1["labels"], TrainConfig(num_epochs=epochs),
        init_params=params_from_jax(syn1["params"]), device="cpu",
        log_fn=lambda ep, sc: logged.append((ep, sc)))
    assert isinstance(out["adj"], SparseAdj)
    np.testing.assert_array_equal(out["train_idx"], out_j["train_idx"])
    np.testing.assert_allclose(out["history"]["loss"], out_j["history"]["loss"],
                               rtol=1e-5, atol=0)
    for k in ("train_acc", "test_acc"):
        np.testing.assert_allclose(out["history"][k], out_j["history"][k],
                                   atol=1e-6, err_msg=k)
    assert out["history"]["loss"][-1] < out["history"]["loss"][0]
    ypred_j = np.asarray(out_j["ypred"])
    assert out["ypred"].shape == ypred_j.shape
    np.testing.assert_allclose(out["ypred"], ypred_j, rtol=1e-5,
                               atol=1e-5 * np.abs(ypred_j).max())
    # JAX's scan_chunk cadence: 20 epochs are one chunk, reported once
    assert [ep for ep, _ in logged] == [20]
    assert logged[0][1]["loss"] == pytest.approx(out["history"]["loss"][-1])


def test_log_fn_every_25_epochs_and_at_the_end():
    g = graph_from_edge_list(6, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5)])
    feat = np.ones((g.num_nodes_padded, 4), np.float32)
    logged = []
    out = train_node_classifier(
        GcnEncoderNode(input_dim=4, hidden_dim=8, embedding_dim=8, label_dim=2,
                       num_layers=3, device="cpu"),
        g, feat, np.array([0, 1, 0, 1, 0, 1]), TrainConfig(num_epochs=60),
        device="cpu", log_fn=lambda ep, sc: logged.append((ep, sc)))
    assert [ep for ep, _ in logged] == [25, 50, 60]
    for ep, sc in logged:
        assert set(sc) == {"loss", "train_acc", "test_acc"}
        assert sc["loss"] == pytest.approx(out["history"]["loss"][ep - 1])


@pytest.mark.parametrize("node", [NODE, 0, 699])
def test_khop_masks_match(syn1, node):
    nb_j = jax_khop.khop_subgraph(syn1["g_j"], jnp.int32(node), 3)
    nb = khop.khop_subgraph(syn1["g_t"], node, 3)
    np.testing.assert_array_equal(nb.node_mask, np.asarray(nb_j.node_mask))
    np.testing.assert_array_equal(nb.edge_mask, np.asarray(nb_j.edge_mask))
    assert nb.edge_mask.dtype == np.bool_
    assert nb.num_nodes == int(nb_j.num_nodes)
    assert nb.new_index == int(nb_j.new_index)
    np.testing.assert_array_equal(
        khop.khop_reachability(syn1["g_t"], node, 2),
        np.asarray(jax_khop.khop_reachability(syn1["g_j"], jnp.int32(node), 2)))
    cg = preprocess_input_graph(syn1["G_t"], syn1["labels"])
    args = (cg["adj"][0], cg["feat"][0], cg["labels"][0], node, 3)
    ref = jax_khop.extract_dense_subgraph(*args)
    out = khop.extract_dense_subgraph(*args)
    assert out[0] == ref[0]
    for a, b in zip(out[1:], ref[1:]):
        np.testing.assert_array_equal(a, b)


def _explain_case(syn1, mask_bias, log_mask_every=0, spread_bias=False):
    """One query's inputs for both packages, from JAX's init; with
    ``spread_bias`` the bias logits are moved off JAX's init of 0 (which
    run_mask_optimization draws itself), onto both clip bounds and
    between them."""
    node = NODE
    cfg_kw = dict(mask_bias=mask_bias, log_mask_every=log_mask_every)
    cfg_j = jax_module.ExplainConfig(num_epochs=10, **cfg_kw)
    nb = jax_khop.khop_subgraph(syn1["g_j"], jnp.int32(node), 3)
    g_j = syn1["g_j"]
    state0 = jax_module.init_masks(jax.random.PRNGKey(0),
                                   g_j.num_edges_padded, 10, nb.num_nodes,
                                   cfg_j)
    if spread_bias:
        b = np.array(jax.random.uniform(jax.random.PRNGKey(1),
                                        state0.edge_logits.shape,
                                        minval=-0.2, maxval=1.2))
        b[::3] = 0.0
        state0 = state0._replace(bias_logits=jnp.asarray(b))
    init = tuple(None if a is None else np.asarray(a)[None] for a in state0)
    return dict(cfg_j=cfg_j, cfg=ExplainConfig(num_epochs=10, **cfg_kw),
                nb=nb, state0=state0, init=init, node=node,
                gt=int(syn1["labels"][node]), n_sub=int(nb.num_nodes),
                keep=np.asarray(nb.edge_mask)[None])


def _port_state(init, requires_grad=True):
    return module.MaskState(*(None if a is None else
                              torch.tensor(a, requires_grad=requires_grad)
                              for a in init))


@pytest.mark.parametrize("mask_bias", [False, True])
def test_masked_weights_loss_terms_and_mask_grads_match(syn1, mask_bias):
    c = _explain_case(syn1, mask_bias, spread_bias=mask_bias)
    g_j, cfg_j = syn1["g_j"], c["cfg_j"]
    x = syn1["feat"]

    def loss_j(st):
        probs, w = jax_module.explain_forward(
            syn1["model_j"].apply, syn1["params"], g_j, jnp.asarray(x), st,
            cfg_j, jnp.int32(c["node"]), c["nb"].edge_mask)
        total, terms = jax_module.explain_loss(
            probs, w, g_j, 10, st, cfg_j, jnp.int32(c["gt"]),
            jnp.asarray(syn1["pred_vec"]), c["nb"].edge_mask,
            c["nb"].num_nodes)
        return total, (terms, w, probs)

    (_, (terms_j, w_j, probs_j)), grads_j = jax.value_and_grad(
        loss_j, has_aux=True)(c["state0"])

    st = _port_state(c["init"])
    g = syn1["g_t"]
    keep = _t(c["keep"])
    probs, w = module.explain_forward(syn1["model"], g, _t(x), st, c["cfg"],
                                      torch.tensor([c["node"]]), keep)
    np.testing.assert_allclose(
        w.detach().numpy()[0],
        np.asarray(jax_module.masked_edge_weights(g_j, c["state0"], cfg_j,
                                                  c["nb"].edge_mask)),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(w.detach().numpy()[0], np.asarray(w_j),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(probs.detach().numpy()[0], np.asarray(probs_j),
                               rtol=1e-5, atol=1e-6)
    total, terms = module.explain_loss(
        probs, w, g, st, c["cfg"], torch.tensor([c["gt"]]),
        _t(syn1["pred_vec"]), keep, torch.tensor([c["n_sub"]]))
    assert set(terms) == set(terms_j)
    for k, ref in terms_j.items():
        np.testing.assert_allclose(terms[k].detach().numpy()[0],
                                   float(ref), rtol=1e-5, atol=1e-7, err_msg=k)
    dens = module.mask_density(g, st, c["cfg"], keep)
    np.testing.assert_allclose(
        dens.detach().numpy()[0],
        float(jax_module.mask_density(g_j, c["state0"], cfg_j,
                                      c["nb"].edge_mask)), rtol=1e-5)
    total.sum().backward()
    for name in ("edge_logits", "feat_logits", "bias_logits"):
        ref = getattr(grads_j, name)
        if ref is None:
            assert getattr(st, name) is None
            continue
        ref = np.asarray(ref)
        got = getattr(st, name).grad.numpy()[0]
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=name)


@pytest.mark.parametrize("mask_bias,log_mask_every", [(False, 0), (True, 1)])
def test_mask_optimization_matches(syn1, mask_bias, log_mask_every):
    """10 Adam steps from the same init: the logits at 1e-4 and the
    per-epoch history (density after each update, masked_w when logged)
    at rtol 1e-4."""
    c = _explain_case(syn1, mask_bias, log_mask_every=log_mask_every)
    g_j = syn1["g_j"]
    st_j, hist_j = jax_module.run_mask_optimization(
        syn1["model_j"].apply, syn1["params"], g_j, jnp.asarray(syn1["feat"]),
        node_idx=jnp.int32(c["node"]), gt_label=jnp.int32(c["gt"]),
        pred_label_vec=jnp.asarray(syn1["pred_vec"]),
        edge_keep=c["nb"].edge_mask, num_sub_nodes=c["nb"].num_nodes,
        key=jax.random.PRNGKey(0), cfg=c["cfg_j"],
        num_pairs=g_j.num_edges_padded)
    st, hist = module.run_mask_optimization(
        syn1["model"], syn1["g_t"], _t(syn1["feat"]), [c["node"]], [c["gt"]],
        _t(syn1["pred_vec"]), _t(c["keep"]), [c["n_sub"]], c["cfg"],
        init_state=c["init"])
    for name in ("edge_logits", "feat_logits", "bias_logits"):
        ref = getattr(st_j, name)
        if ref is None:
            assert getattr(st, name) is None
            continue
        np.testing.assert_allclose(getattr(st, name).numpy()[0],
                                   np.asarray(ref), atol=1e-4, err_msg=name)
    assert set(hist) == set(hist_j)
    for k, ref in hist_j.items():
        ref = np.asarray(ref)
        assert hist[k].shape == (1,) + ref.shape, k
        np.testing.assert_allclose(hist[k][0], ref, rtol=1e-4,
                                   atol=1e-6 if k == "masked_w" else 0,
                                   err_msg=k)


@pytest.fixture(scope="module")
def explainer_inputs(syn1):
    """The cg bundle of syn1 with random predictions, for the port's
    Explainer on the random-weight model."""
    cg = preprocess_input_graph(syn1["G_t"], syn1["labels"])
    n = cg["adj"].shape[1]
    pred = np.zeros((1, n, 4), np.float32)
    pred[0, np.arange(n), syn1["pred_vec"][:n]] = 1.0
    return dict(adj=cg["adj"], feat=syn1["feat"][None, :n],
                label=cg["labels"], pred=pred)


def _explainer(syn1, inputs, **cfg):
    return Explainer(syn1["model"], None, inputs["adj"], inputs["feat"],
                     inputs["label"], inputs["pred"],
                     cfg=ExplainConfig(num_epochs=10, **cfg), device="cpu")


def test_batched_explain_equals_each_query_alone(syn1, explainer_inputs):
    ex = _explainer(syn1, explainer_inputs)
    batch = ex.explain_nodes_batch(QUERIES)
    for q, node in enumerate(QUERIES):
        alone = ex.explain_nodes_batch([node])[0]
        b = batch[q]
        assert b["node_idx"] == alone["node_idx"] == node
        assert b["node_idx_new"] == alone["node_idx_new"]
        np.testing.assert_array_equal(b["neighbors"], alone["neighbors"])
        np.testing.assert_allclose(b["masked_adj"], alone["masked_adj"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(b["feat_mask"], alone["feat_mask"],
                                   rtol=1e-5, atol=1e-6)
        for k, v in alone["history"].items():
            np.testing.assert_allclose(b["history"][k], v, rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        ma = b["masked_adj"]
        assert ma.shape == (len(b["neighbors"]),) * 2
        np.testing.assert_allclose(ma, ma.T, atol=1e-6)
    # the dense masked sub-adjacency against JAX's extraction contract
    nb_new, sub_adj, _, _, neighbors = ex.extract_neighborhood(QUERIES[0])
    np.testing.assert_array_equal(neighbors, batch[0]["neighbors"])
    assert nb_new == batch[0]["node_idx_new"]
    assert np.all((batch[0]["masked_adj"] != 0) <= (sub_adj != 0))


def test_seed_ensemble_is_the_mean_of_seeded_runs(syn1, explainer_inputs):
    one = _explainer(syn1, explainer_inputs).explain_nodes_batch(QUERIES[:2])
    ex_b = _explainer(syn1, explainer_inputs)
    ex_b.seed = 7919
    other = ex_b.explain_nodes_batch(QUERIES[:2])
    ens = _explainer(syn1, explainer_inputs,
                     seed_ensemble=2).explain_nodes_batch(QUERIES[:2])
    for a, b, e in zip(one, other, ens):
        np.testing.assert_allclose(e["masked_adj"],
                                   (a["masked_adj"].astype(np.float64)
                                    + b["masked_adj"]) / 2, rtol=1e-6,
                                   atol=1e-7)
        assert not np.allclose(a["masked_adj"], b["masked_adj"])
        np.testing.assert_array_equal(e["feat_mask"], a["feat_mask"])


def test_marginalize_noise_statistics(syn1):
    """With marginalize the masked-out share of each feature is replaced by
    z ~ N(-x, 1/2): x + z (1 - m) has mean m x and std (1 - m) / 2."""
    cfg = ExplainConfig(marginalize=True)
    q, n, d = 3, 2048, 10
    rng = np.random.default_rng(8)
    x = _t(rng.standard_normal((n, d)).astype(np.float32))
    feat_logits = _t(rng.standard_normal((q, d)).astype(np.float32))
    st = module.MaskState(torch.zeros((q, 8)), feat_logits)
    seen = {}

    class Probe(torch.nn.Module):
        def forward(self, xx, adj):
            seen["x"] = xx.reshape(q, n, d)
            return torch.zeros((q * n, 4)), []

    g = graph_from_edge_list(n, [(0, 1)])
    gen = torch.Generator().manual_seed(0)
    module.explain_forward(Probe(), g, x, st, cfg, torch.zeros(q).long(),
                           None, generator=gen)
    m = torch.sigmoid(feat_logits)[:, None, :]
    z = (seen["x"] - x) / (1 - m)  # the noise draw, N(-x, 1/2)
    resid = (z + x) / 0.5           # N(0, 1)
    assert abs(float(resid.mean())) < 0.03
    assert abs(float(resid.std()) - 1.0) < 0.03
    # a second call draws afresh; without a generator there is no noise
    first = seen["x"]
    module.explain_forward(Probe(), g, x, st, cfg, torch.zeros(q).long(),
                           None, generator=gen)
    assert not torch.allclose(seen["x"], first)
    module.explain_forward(Probe(), g, x, st, cfg, torch.zeros(q).long(), None)
    torch.testing.assert_close(seen["x"], x * m)


def test_mask_init_shares_one_draw():
    """Each query's init is 1 + std(n_sub) * z with one draw z shared by
    the batch, so a query starts the same in any batch."""
    cfg = ExplainConfig(mask_bias=True)
    n_sub = torch.tensor([1, 8, 50])
    st = module.init_masks(torch.Generator().manual_seed(3), 4000, 10, n_sub,
                           cfg)
    alone = module.init_masks(torch.Generator().manual_seed(3), 4000, 10,
                              n_sub[1:2], cfg)
    torch.testing.assert_close(st.edge_logits[1:2], alone.edge_logits)
    std = np.sqrt(2.0) * np.sqrt(2.0 / (2.0 * n_sub.numpy()))
    z = (st.edge_logits - 1.0) / torch.from_numpy(std).float()[:, None]
    torch.testing.assert_close(z[0], z[2])
    assert abs(float(z[0].std()) - 1.0) < 0.05
    assert torch.all(st.feat_logits == 0) and torch.all(st.bias_logits == 0)


def test_explain_one_node_saves_npy_and_unported_raise(syn1, explainer_inputs,
                                                       tmp_path):
    ex = _explainer(syn1, explainer_inputs)
    ex.logdir = str(tmp_path)
    ma = ex.explain(NODE)
    np.testing.assert_array_equal(ma, ex.explain_nodes_batch([NODE])[0]["masked_adj"])
    np.testing.assert_array_equal(
        np.load(tmp_path / f"masked_adj_node_idx_{NODE}graph_idx_0.npy"), ma)
    # the grad/att baselines (ported in tests/test_torch_baselines.py) save
    # their dense mask under the same name
    for model in ("grad", "att"):
        mb = ex.explain(NODE, model=model)
        assert mb.shape == ma.shape and np.all(np.isfinite(mb))
        np.testing.assert_array_equal(
            np.load(tmp_path / f"masked_adj_node_idx_{NODE}graph_idx_0.npy"), mb)
        stats = ex.explain_nodes_gnn_stats([NODE], model=model)
        np.testing.assert_array_equal(stats["masked_adjs"][0], mb)
    # a 1-rank mesh (tests/test_torch_parallel_explain.py shards over more)
    with single_rank("gloo"):
        sharded = ex.explain_nodes_batch([NODE], mesh=make_mesh())
    np.testing.assert_array_equal(sharded[0]["masked_adj"], ma)
