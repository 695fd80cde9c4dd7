"""The port's graph classifiers against tpugraph's on the CPU, from the same
numpy batches and the same flax weights (``params_from_jax``):
``GcnEncoderGraph`` (base, ``att``, ``bn``; with and without
``node_mask``; on a dense batch and on sparse single and stacked graphs)
and the DiffPool ``SoftPoolingGcnEncoder``; ``margin_loss`` and
``link_prediction_loss``; gradients against ``jax.grad``;
``eval_graph_preds``; and 20-epoch ``train_graph_classifier`` loss and
accuracy trajectories on TOY."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_tasks import write_tu_dataset
from tpugraph.core.graph import graph_from_dense as jax_graph_from_dense
from tpugraph.data.pipeline import prepare_data as jax_prepare_data
from tpugraph.data.readers import read_graphfile as jax_read_graphfile
from tpugraph.nn import GcnEncoderGraph as JaxGcnEncoderGraph
from tpugraph.nn import SoftPoolingGcnEncoder as JaxSoftPooling
from tpugraph.nn import losses as jax_losses
from tpugraph.nn.layers import SparseAdj as JaxSparseAdj
from tpugraph.train import loop as jax_loop
from tpugraph.train.metrics import eval_graph_preds as jax_eval_graph_preds
from tpugraph_torch.core.graph import batch_graphs, graph_from_dense
from tpugraph_torch.data.pipeline import prepare_data
from tpugraph_torch.data.readers import read_graphfile
from tpugraph_torch.nn import (GcnEncoderGraph, SoftPoolingGcnEncoder, SparseAdj,
                                link_prediction_loss, margin_loss, params_from_jax,
                                softmax_cross_entropy)
from tpugraph_torch.train import TrainConfig, train_graph_classifier
from tpugraph_torch.train.metrics import eval_graph_preds

torch.set_num_threads(1)

REL = 1e-5  # forwards and gradients: |port - JAX| <= REL * max|JAX| (f32 reordering)
TRAJ_TOL = 1e-4  # 20-epoch loss trajectories
OPTIONS = {"base": {}, "att": {"att": True}, "bn": {"bn": True}}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), err


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """TOY's graphs in both packages with the same seeded N(0, 1) node
    features (width 4), the seeded split, and one training batch of 8.
    TOY's own node labels (degree parity) make every node of a cycle
    alike, so the max-pool readout ties exactly and f32 rounding picks
    which node gets the gradient: the port's own f32 and f64 gradients
    then differ by up to 8% of a bias's largest entry.  Random features
    give every graph one maximum, where the gradient is defined."""
    root = str(tmp_path_factory.mktemp("tu"))
    write_tu_dataset(root, "TOY")
    jg, tg = jax_read_graphfile(root, "TOY"), read_graphfile(root, "TOY")
    rng = np.random.default_rng(11)
    for G_j, G_t in zip(jg, tg):
        for u in G_j.nodes():
            G_j.nodes[u]["feat"] = rng.standard_normal(4).astype(np.float32)
            G_t.feat[u] = G_j.nodes[u]["feat"].copy()
    jax_split = jax_prepare_data(jg, rng=np.random.default_rng(0))
    split = prepare_data(tg, rng=np.random.default_rng(0))
    batch = split[0].batch(np.arange(8))
    return dict(jax_split=jax_split, split=split, batch=batch)


def _graph_models(toy, **opts):
    b = toy["batch"]
    dims = dict(input_dim=b.feats.shape[-1], hidden_dim=8, embedding_dim=6,
                label_dim=2, num_layers=3, **opts)
    model_j = JaxGcnEncoderGraph(**dims)
    params = model_j.init(jax.random.PRNGKey(0), jnp.asarray(b.feats),
                          jnp.asarray(b.adj), node_mask=jnp.asarray(b.node_mask))
    model = GcnEncoderGraph(**dims, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model_j, params, model


@pytest.mark.parametrize("masked", [True, False], ids=["node_mask", "no_mask"])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_graph_encoder_matches_flax(toy, option, masked):
    b = toy["batch"]
    model_j, params, model = _graph_models(toy, **OPTIONS[option])
    mask = b.node_mask if masked else None
    want, att_j = model_j.apply(params, jnp.asarray(b.feats), jnp.asarray(b.adj),
                                node_mask=None if mask is None else jnp.asarray(mask))
    got, att = model(_t(b.feats), _t(b.adj),
                     node_mask=None if mask is None else _t(mask))
    _close(got, want)
    assert len(att) == len(att_j) == 3
    for a_t, a_j in zip(att, att_j):
        _close(a_t, a_j)


@pytest.mark.parametrize("option", ["base", "att"])
def test_graph_encoder_sparse_single_and_stacked(toy, option):
    """On the COO path of one graph ``x [N, D]`` -> ``[C]`` (JAX's graph-mode
    input), and on Q graphs as disjoint copies of one sparse adjacency
    with ``x [Q, N, D]`` -> ``[Q, C]``, each equal to its graph alone."""
    b = toy["batch"]
    model_j, params, model = _graph_models(toy, **OPTIONS[option])
    for i in range(3):
        g_j = jax_graph_from_dense(b.adj[i])
        want, _ = model_j.apply(params, jnp.asarray(b.feats[i]),
                                JaxSparseAdj(g_j.senders, g_j.receivers,
                                             g_j.edge_weight))
        g = graph_from_dense(b.adj[i])
        got, _ = model(_t(b.feats[i]), SparseAdj(g.senders.long(),
                                                 g.receivers.long(), g.edge_weight))
        assert got.shape == (2,)
        _close(got, want)
    e_pad = max(8, ((max(int((b.adj[i] != 0).sum()) for i in range(3)) + 7) // 8) * 8)
    bg = batch_graphs([graph_from_dense(b.adj[i], num_edges_padded=e_pad)
                       for i in range(3)])
    n = bg.num_nodes_padded
    x = np.zeros((3, n, b.feats.shape[-1]), np.float32)
    x[:, : b.feats.shape[1]] = b.feats[:3]
    off = (torch.arange(3)[:, None] * n)
    adj = SparseAdj((bg.senders + off).reshape(-1).long(),
                    (bg.receivers + off).reshape(-1).long(),
                    bg.edge_weight.reshape(-1))
    got, _ = model(_t(x), adj)
    assert got.shape == (3, 2)
    # padded rows (features 0) join the pool, as in JAX's graph mode; with
    # n_pad > N they add rows equal to an isolated node's
    for i in range(3):
        g_j = jax_graph_from_dense(b.adj[i])
        want, _ = model_j.apply(params, jnp.asarray(x[i][: g_j.num_nodes_padded]),
                                JaxSparseAdj(g_j.senders, g_j.receivers,
                                             g_j.edge_weight))
        _close(got[i], want)


def _diffpool(toy, **kw):
    b, tb = toy["batch"], toy["split"][0]
    dims = dict(max_num_nodes=tb.max_num_nodes, input_dim=tb.feat_dim,
                hidden_dim=8, embedding_dim=6, label_dim=2, num_layers=3,
                assign_hidden_dim=8, assign_ratio=0.3,
                assign_input_dim=tb.assign_feat_dim, **kw)
    model_j = JaxSoftPooling(**dims)
    params = model_j.init(jax.random.PRNGKey(1), jnp.asarray(b.feats),
                          jnp.asarray(b.adj), node_mask=jnp.asarray(b.node_mask),
                          assign_x=jnp.asarray(b.assign_feats))
    model = SoftPoolingGcnEncoder(**dims, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model_j, params, model


@pytest.mark.parametrize("masked", [True, False], ids=["node_mask", "no_mask"])
@pytest.mark.parametrize("option", ["base", "bn"])
def test_soft_pooling_matches_flax(toy, option, masked):
    b = toy["batch"]
    model_j, params, model = _diffpool(toy, **OPTIONS[option])
    mask = b.node_mask if masked else None
    want, s_j = model_j.apply(params, jnp.asarray(b.feats), jnp.asarray(b.adj),
                              node_mask=None if mask is None else jnp.asarray(mask),
                              assign_x=jnp.asarray(b.assign_feats))
    got, s = model(_t(b.feats), _t(b.adj),
                   node_mask=None if mask is None else _t(mask),
                   assign_x=_t(b.assign_feats))
    _close(got, want)
    assert len(s) == len(s_j) == 1
    _close(s[0], s_j[0])


def test_soft_pooling_two_stages_fail_in_both(toy):
    """tpugraph builds the second stage's assign stack for embedding_dim
    inputs and feeds it the concatenated ``S^T Z``; the port keeps the
    widths, so both fail at the first forward."""
    b, tb = toy["batch"], toy["split"][0]
    dims = dict(max_num_nodes=tb.max_num_nodes, input_dim=tb.feat_dim,
                hidden_dim=8, embedding_dim=6, label_dim=2, num_layers=3,
                assign_hidden_dim=8, assign_ratio=0.5, num_pooling=2,
                assign_input_dim=tb.assign_feat_dim)
    with pytest.raises(TypeError, match="dot_general"):
        JaxSoftPooling(**dims).init(
            jax.random.PRNGKey(1), jnp.asarray(b.feats), jnp.asarray(b.adj),
            node_mask=jnp.asarray(b.node_mask), assign_x=jnp.asarray(b.assign_feats))
    model = SoftPoolingGcnEncoder(**dims, device="cpu")
    assert len(model.after_pool_stack) == 2
    with pytest.raises(RuntimeError, match="shapes cannot be multiplied"):
        model(_t(b.feats), _t(b.adj), node_mask=_t(b.node_mask),
              assign_x=_t(b.assign_feats))


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((7, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 7).astype(np.int32)
    _close(margin_loss(_t(logits), _t(labels), 3),
           jax_losses.margin_loss(jnp.asarray(logits), jnp.asarray(labels), 3))
    s = np.abs(rng.standard_normal((4, 9, 3))).astype(np.float32)
    s = s / s.sum(-1, keepdims=True)
    adj = (rng.random((4, 9, 9)) < 0.4).astype(np.float32)
    mask = (np.arange(9)[None] < rng.integers(4, 10, 4)[:, None]).astype(np.float32)
    for m in (mask, None):
        _close(link_prediction_loss(_t(s), _t(adj), None if m is None else _t(m)),
               jax_losses.link_prediction_loss(jnp.asarray(s), jnp.asarray(adj),
                                               None if m is None else jnp.asarray(m)))


def test_eval_graph_preds_matches_jax():
    rng = np.random.default_rng(5)
    preds, labels = rng.integers(0, 3, 50), rng.integers(0, 3, 50)
    a, b = eval_graph_preds(preds, labels), jax_eval_graph_preds(preds, labels)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def _port_grads(model, b, kind, dtype):
    """The port's loss and parameter gradients on batch ``b`` at ``dtype``."""
    model = model.to(dtype)
    model.zero_grad()
    t = lambda a: _t(a).to(dtype)
    kw = dict(node_mask=t(b.node_mask))
    if kind == "diffpool_linkpred":
        kw["assign_x"] = t(b.assign_feats)
    logits, aux = model(t(b.feats), t(b.adj), **kw)
    loss = softmax_cross_entropy(logits, _t(b.label))
    if kind == "diffpool_linkpred":
        loss = loss + link_prediction_loss(aux[0], t(b.adj), t(b.node_mask))
    loss.backward()
    return loss, {k: v.grad.double() for k, v in model.named_parameters()}


@pytest.mark.parametrize("kind", ["base", "att", "diffpool_linkpred"])
def test_gradients_match_jax_grad(toy, kind):
    """Cross-entropy (plus DiffPool's link-prediction term) on one batch:
    every parameter's gradient against ``jax.grad``.  Each entry is held
    within REL of the model's largest gradient plus twice the largest
    error float32 costs the port itself (its float32 gradients against
    its float64 ones, over all parameters).  For the base model that
    extra term is ~1e-7 of the scale.  With attention a node whose first
    layer output is near zero amplifies rounding through the L2
    normalization, and DiffPool's pooled nodes start near-identical, so
    at every init key tried (0-5) their f32 gradients carry errors of
    0.05-100% of the scale in the port alone, and a rounding that flips
    a ReLU or a max in one package moves gradients downstream of it."""
    b = toy["batch"]
    if kind == "diffpool_linkpred":
        model_j, params, model = _diffpool(toy)
        kw_j = dict(node_mask=jnp.asarray(b.node_mask),
                    assign_x=jnp.asarray(b.assign_feats))
    else:
        model_j, params, model = _graph_models(toy, **OPTIONS[kind])
        kw_j = dict(node_mask=jnp.asarray(b.node_mask))

    def loss_j(p):
        logits, aux = model_j.apply(p, jnp.asarray(b.feats), jnp.asarray(b.adj), **kw_j)
        loss = jax_losses.softmax_cross_entropy(logits, jnp.asarray(b.label))
        if kind == "diffpool_linkpred":
            loss = loss + jax_losses.link_prediction_loss(
                aux[0], jnp.asarray(b.adj), jnp.asarray(b.node_mask))
        return loss

    want = params_from_jax(jax.grad(loss_j)(params))
    loss, got = _port_grads(model, b, kind, torch.float32)
    _close(loss, loss_j(params))
    _, exact = _port_grads(model, b, kind, torch.float64)
    assert set(got) == set(want)
    scale = max(float(v.abs().max()) for v in want.values())
    own = max(float((got[k] - exact[k]).abs().max()) for k in got)
    if kind == "base":
        assert own <= 1e-6 * scale, own
    for k in want:
        err = float((got[k] - want[k].double()).abs().max())
        assert err <= REL * scale + 2 * own, (k, err, scale, own)


@pytest.mark.parametrize("method", ["base", "soft-assign"])
def test_train_graph_classifier_trajectory(toy, method):
    """20 epochs on TOY (batches of 8, evaluation every 5 epochs) from
    tpugraph's own initial weights: the loss of every epoch within 1e-4 and
    the train/val/test accuracies at every evaluation, best val and the
    test result equal."""
    cfg_kw = dict(num_epochs=20, batch_size=8)
    jtr, jva, jte = toy["jax_split"]
    tr, va, te = toy["split"]
    first = jtr.batch(np.arange(min(len(jtr), 8)))
    dims = dict(input_dim=jtr.feat_dim, hidden_dim=8, embedding_dim=6,
                label_dim=2, num_layers=3)
    linkpred = method == "soft-assign"
    if linkpred:
        dims.update(max_num_nodes=jtr.max_num_nodes, assign_hidden_dim=8,
                    assign_ratio=0.3, assign_input_dim=jtr.assign_feat_dim)
        model_j, model = JaxSoftPooling(**dims), SoftPoolingGcnEncoder(**dims, device="cpu")
        extra = {"assign_x": jnp.asarray(first.assign_feats)}
    else:
        model_j, model = JaxGcnEncoderGraph(**dims), GcnEncoderGraph(**dims, device="cpu")
        extra = {}
    init = model_j.init(jax.random.PRNGKey(3), jnp.asarray(first.feats),
                        jnp.asarray(first.adj), node_mask=jnp.asarray(first.node_mask),
                        **extra)
    out_j = jax_loop.train_graph_classifier(
        model_j, jtr, jax_loop.TrainConfig(eval_every=5, **cfg_kw), val_batcher=jva,
        test_batcher=jte, linkpred=linkpred, seed=3)
    logged = []
    out = train_graph_classifier(
        model, tr, TrainConfig(eval_every=5, **cfg_kw), val_batcher=va,
        test_batcher=te, linkpred=linkpred, seed=3,
        log_fn=lambda e, s: logged.append(e),
        init_params=params_from_jax(init), device="cpu")
    assert logged == [0, 5, 10, 15, 19]
    err = np.abs(np.subtract(out["history"]["loss"], out_j["history"]["loss"])).max()
    assert err <= TRAJ_TOL, err
    for k in ("train_acc", "val_acc", "test_acc"):
        np.testing.assert_allclose(out["history"][k], out_j["history"][k], atol=1e-12)
    assert out["best_val"]["epoch"] == out_j["best_val"]["epoch"]
    assert out["test_result"] == pytest.approx(out_j["test_result"])
    for k in ("adj", "feat", "label", "num_nodes", "train_idx"):
        np.testing.assert_array_equal(out["cg"][k], out_j["cg"][k])
    np.testing.assert_allclose(out["cg"]["pred"], out_j["cg"]["pred"], atol=TRAJ_TOL)


def test_graph_training_mesh_raises(toy):
    """Data parallelism is ported (tests/test_torch_parallel_dp.py); a mesh
    whose size does not divide the batch raises tpugraph's ValueError
    before anything trains."""
    from tpugraph_torch.parallel.mesh import Mesh

    model = GcnEncoderGraph(input_dim=toy["split"][0].feat_dim, hidden_dim=4,
                            embedding_dim=4, label_dim=2, num_layers=3,
                            device="cpu")
    with pytest.raises(ValueError, match="must divide by the 3-device mesh"):
        train_graph_classifier(model, toy["split"][0], TrainConfig(num_epochs=1),
                               mesh=Mesh(("data",), (3,)), device="cpu")
