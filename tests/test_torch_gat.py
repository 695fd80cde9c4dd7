"""The port's GraphConv options against tpugraph's on the CPU, from the same
numpy inputs and parameters: GAT attention on COO and on BCSR tiles (B2
scores, B1 over the score-scaled tiles, Pallas in interpret mode on the
JAX side), ``add_self`` and ``bn``; the ``sddmm_dw``/``bcsr_matvec_dw``
autograd functions; 20-epoch trajectories; dropout by its statistics; and
an attention model explained on the COO path and in tile space."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugraph.core.graph import graph_from_networkx as jax_graph_from_networkx
from tpugraph.data import featgen as jax_featgen
from tpugraph.data.gengraph import gen_syn1 as jax_gen_syn1
from tpugraph.data.gengraph import preprocess_input_graph as jax_preprocess
from tpugraph.explain import module as jax_module
from tpugraph.explain.explainer import Explainer as JaxExplainer
from tpugraph.core import khop as jax_khop
from tpugraph.nn import GcnEncoderNode as JaxGcnEncoderNode
from tpugraph.nn.layers import BCSRAdj as JaxBCSRAdj
from tpugraph.nn.layers import SparseAdj as JaxSparseAdj
from tpugraph.nn.layers import fresh_batch_norm as jax_fresh_batch_norm
from tpugraph.nn.losses import node_cross_entropy as jax_node_ce
from tpugraph.ops import bcsr as jax_bcsr
from tpugraph.ops.pallas_spmm import bcsr_matvec_dw as jax_bcsr_matvec_dw
from tpugraph.ops.pallas_spmm import sddmm_dw as jax_sddmm_dw
from tpugraph.train import loop as jax_loop
from tpugraph_torch.core.graph import graph_from_edge_list
from tpugraph_torch.data import ConstFeatureGen, gen_syn1
from tpugraph_torch.explain import Explainer, ExplainConfig
from tpugraph_torch.nn import (BCSRAdj, GcnEncoderNode, PacketAdj, SparseAdj,
                                StackedAdj, params_from_jax)
from tpugraph_torch.nn.layers import apply_dropout, fresh_batch_norm
from tpugraph_torch.nn.losses import node_cross_entropy
from tpugraph_torch.ops import bcsr
from tpugraph_torch.ops.bcsr_kernels import bcsr_matvec_dw, sddmm_dw
from tpugraph_torch.train import TrainConfig, train_node_classifier

torch.set_num_threads(1)

OPTIONS = {"att": dict(att=True), "add_self": dict(add_self=True),
           "bn": dict(bn=True)}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def small():
    """The small syn1 of tests/test_train.py:145-159 in both packages
    (seed 3, 8 houses on 40 BA nodes), random features."""
    kw = dict(nb_shapes=8, width_basis=40, seed=3)
    G_j, labels, _ = jax_gen_syn1(
        feature_generator=jax_featgen.ConstFeatureGen(np.ones(10, np.float32)),
        **kw)
    G_t, _, _ = gen_syn1(
        feature_generator=ConstFeatureGen(np.ones(10, np.float32)), **kw)
    g_j = jax_graph_from_networkx(G_j)
    g_t = graph_from_edge_list(G_t.number_of_nodes(), G_t.edges())
    rng = np.random.default_rng(1)
    feat = np.zeros((g_t.num_nodes_padded, 10), np.float32)
    feat[: g_t.n_node] = rng.standard_normal((g_t.n_node, 10))
    dims = dict(input_dim=10, hidden_dim=8, embedding_dim=8,
                label_dim=int(max(labels)) + 1, num_layers=3)
    return dict(G_j=G_j, G_t=G_t, g_j=g_j, g_t=g_t,
                labels=np.asarray(labels), feat=feat, dims=dims)


def _models(small, **opts):
    model_j = JaxGcnEncoderNode(**small["dims"], **opts)
    g = small["g_j"]
    params = model_j.init(jax.random.PRNGKey(0), jnp.asarray(small["feat"]),
                          JaxSparseAdj(g.senders, g.receivers, g.edge_weight))
    model = GcnEncoderNode(**small["dims"], **opts, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model_j, params, model


def _random_bcsr(block, n=256, e=1500, seed=0):
    rng = np.random.default_rng(seed + block)
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n - 3, e).astype(np.int32)
    w = rng.standard_normal(e).astype(np.float32)
    w[rng.random(e) < 0.1] = 0.0
    return s, r, w, n, rng


@pytest.mark.parametrize("block", [8, 128])
def test_sddmm_dw_and_bcsr_matvec_dw_match_jax(block):
    """Forward and both gradients of the two autograd functions against
    JAX's custom-VJP twins, on a graph with zero weights, duplicate
    edges and row blocks no tile covers."""
    s, r, w, n, rng = _random_bcsr(block)
    d = 128  # tpugraph's kernels take lane-padded widths
    m_j = jax_bcsr.bcsr_from_coo(s, r, w, n, block=block)
    tp_j = jax_bcsr.bcsr_transpose_plan(m_j)
    m_h = bcsr.bcsr_from_coo(s, r, w, n, block=block)
    m, tp = m_h.to("cpu"), bcsr.bcsr_transpose_plan(m_h).to("cpu")
    a, b, x = (rng.standard_normal((n, d)).astype(np.float32) for _ in range(3))
    g_sc = rng.standard_normal(m.tiles.shape).astype(np.float32)
    g_y = rng.standard_normal((n, d)).astype(np.float32)
    tiles = (np.asarray(m_j.tiles)
             * rng.uniform(0.5, 1.5, m.tiles.shape)).astype(np.float32)

    sc_j, vjp = jax.vjp(lambda a_, b_: jax_sddmm_dw(m_j, tp_j, a_, b_), a, b)
    da_j, db_j = vjp(jnp.asarray(g_sc))
    y_j, vjp = jax.vjp(lambda t_, x_: jax_bcsr_matvec_dw(
        dataclasses.replace(m_j, tiles=t_), tp_j, x_), jnp.asarray(tiles), x)
    dt_j, dx_j = vjp(jnp.asarray(g_y))

    a_t, b_t, x_t, t_t = (_t(v).requires_grad_() for v in (a, b, x, tiles))
    sc = sddmm_dw(m, tp, a_t, b_t)
    (sc * _t(g_sc)).sum().backward()
    y = bcsr_matvec_dw(dataclasses.replace(m, tiles=t_t), tp, x_t)
    (y * _t(g_y)).sum().backward()
    for got, ref in ((sc, sc_j), (a_t.grad, da_j), (b_t.grad, db_j),
                     (y, y_j), (t_t.grad, dt_j), (x_t.grad, dx_j)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())
    # no gradient reaches the tiles through the scores' support
    t_s = m.tiles.clone().requires_grad_()
    sddmm_dw(dataclasses.replace(m, tiles=t_s), tp, a_t, b_t).sum().backward()
    assert t_s.grad is None


def _adjacencies(small, kind, att):
    """The same edges as tpugraph's and the port's adjacency of ``kind``."""
    g = small["g_t"]
    if kind == "coo":
        g_j = small["g_j"]
        return (JaxSparseAdj(g_j.senders, g_j.receivers, g_j.edge_weight),
                SparseAdj(g.senders.long(), g.receivers.long(), g.edge_weight),
                g.num_nodes_padded)
    block = int(kind[len("tiles"):])
    s, r, w = g.senders.numpy(), g.receivers.numpy(), g.edge_weight.numpy()
    n = g.num_nodes_padded
    m_j = jax_bcsr.bcsr_from_coo(s, r, w, n, block=block)
    m_h = bcsr.bcsr_from_coo(s, r, w, n, block=block)
    if att:
        return (JaxBCSRAdj(m_j, None, jax_bcsr.bcsr_transpose_plan(m_j)),
                BCSRAdj(m_h.to("cpu"), None,
                        bcsr.bcsr_transpose_plan(m_h).to("cpu")),
                m_h.num_nodes)
    return (JaxBCSRAdj(m_j, jax_bcsr.bcsr_transpose_host(s, r, w, n,
                                                         block=block)),
            BCSRAdj(m_h.to("cpu"),
                    bcsr.bcsr_transpose_host(s, r, w, n, block=block).to("cpu")),
            m_h.num_nodes)


@pytest.mark.parametrize("kind", ["coo", "tiles8", "tiles128"])
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_encoder_option_logits_and_grads_match(small, option, kind):
    """GcnEncoderNode with ``att``, ``add_self`` or ``bn`` on COO and on
    tiles of B = 8 and 128: logits, loss and every parameter gradient
    against ``jax.grad`` at 1e-5."""
    opts = OPTIONS[option]
    model_j, params, model = _models(small, **opts)
    adj_j, adj, n = _adjacencies(small, kind, opts.get("att", False))
    x = np.zeros((n, 10), np.float32)
    x[: small["feat"].shape[0]] = small["feat"]
    y = np.zeros((n,), np.int32)
    y[: len(small["labels"])] = small["labels"]
    mask = np.zeros((n,), np.float32)
    mask[: len(small["labels"]): 2] = 1.0

    def loss_j(p):
        logits, _ = model_j.apply(p, jnp.asarray(x), adj_j)
        return jax_node_ce(logits, jnp.asarray(y),
                           node_mask=jnp.asarray(mask)), logits

    (l_ref, logits_ref), grads_ref = jax.value_and_grad(
        loss_j, has_aux=True)(params)
    logits, att_all = model(_t(x), adj)
    loss = node_cross_entropy(logits, _t(y).long(), node_mask=_t(mask))
    loss.backward()
    assert len(att_all) == 3
    logits_ref = np.asarray(logits_ref)
    np.testing.assert_allclose(logits.detach().numpy(), logits_ref, rtol=1e-5,
                               atol=1e-5 * np.abs(logits_ref).max())
    np.testing.assert_allclose(loss.item(), float(l_ref), rtol=1e-5)
    grads = params_from_jax(grads_ref)
    named = dict(model.named_parameters())
    assert set(grads) == set(named)
    assert any(k.endswith(("att_weight", "self_weight")) for k in named) == (
        option != "bn")
    for k, gref in grads.items():
        gref = gref.numpy()
        np.testing.assert_allclose(named[k].grad.numpy(), gref, rtol=1e-5,
                                   atol=1e-5 * np.abs(gref).max(), err_msg=k)


def test_fresh_batch_norm_matches():
    """Biased variance over the features of each node (and over every axis
    but the node axis of a batched input)."""
    rng = np.random.default_rng(4)
    for shape in ((30, 7), (3, 30, 7)):
        x = rng.standard_normal(shape).astype(np.float32) * 3 + 1
        np.testing.assert_allclose(fresh_batch_norm(_t(x)).numpy(),
                                   np.asarray(jax_fresh_batch_norm(x)),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("option,use_bcsr", [
    ("att", False), ("att", True), ("bn", False), ("bn", True),
    ("add_self", False)])
def test_option_training_trajectory_matches(small, option, use_bcsr):
    """20 epochs from JAX's initial parameters: the loss trajectory at
    1e-5 and the final predictions; GAT on ``use_bcsr`` takes the tiles
    with a transpose plan in both packages."""
    opts = OPTIONS[option]
    model_j, params, model = _models(small, **opts)
    epochs = 20
    out_j = jax_loop.train_node_classifier(
        model_j, small["g_j"], small["feat"], small["labels"],
        jax_loop.TrainConfig(num_epochs=epochs, scan_chunk=epochs,
                             use_bcsr=use_bcsr), init_params=params)
    out = train_node_classifier(
        model, small["g_t"], small["feat"], small["labels"],
        TrainConfig(num_epochs=epochs, use_bcsr=use_bcsr),
        init_params=params_from_jax(params), device="cpu")
    np.testing.assert_allclose(out["history"]["loss"], out_j["history"]["loss"],
                               rtol=1e-5, atol=0)
    assert out["history"]["loss"][-1] < out["history"]["loss"][0]
    ypred_j = np.asarray(out_j["ypred"])
    np.testing.assert_allclose(out["ypred"], ypred_j, rtol=1e-5,
                               atol=1e-5 * np.abs(ypred_j).max())
    adj = out["adj"]
    assert isinstance(adj, BCSRAdj if use_bcsr else SparseAdj)
    if use_bcsr:  # GAT: tiles with a transpose plan, no static transpose
        assert (adj.tp is not None, adj.m_t is None) == (option == "att",) * 2


def test_att_raises_on_static_weight_formats(small):
    """Stacked and packet adjacencies carry no score gradient: an attention
    layer raises on them, as in tpugraph."""
    model = GcnEncoderNode(**small["dims"], att=True, device="cpu")
    x = torch.zeros((8, 10))
    for adj in (StackedAdj(None, None), PacketAdj(None, None)):
        with pytest.raises(NotImplementedError, match="GAT"):
            model(x, adj)
    with pytest.raises(NotImplementedError, match="transpose plan"):
        model(x, BCSRAdj(None, None))


def test_dropout_statistics():
    """flax's Dropout: each entry kept with probability 1 - rate and scaled
    by 1 / (1 - rate); the mask follows the generator."""
    x = torch.ones((400, 500))
    for rate in (0.1, 0.5):
        y = apply_dropout(x, rate, torch.Generator().manual_seed(0))
        kept = y != 0
        assert abs(kept.float().mean().item() - (1 - rate)) < 0.005
        np.testing.assert_allclose(y[kept].numpy(), 1 / (1 - rate), rtol=1e-6)
        again = apply_dropout(x, rate, torch.Generator().manual_seed(0))
        assert torch.equal(y, again)


def test_dropout_only_in_conv_block_and_training(small):
    """``dropout`` reaches the conv_block layers only; evaluation and a
    model in eval mode run without it; training is reproducible from the
    seed and differs from a run without dropout."""
    dims = small["dims"]
    model = GcnEncoderNode(**dims, dropout=0.5, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    assert [c.dropout for c in model.stack.conv_block] == [0.5]
    assert model.stack.conv_first.dropout == model.stack.conv_last.dropout == 0
    plain = GcnEncoderNode(**dims, device="cpu")
    plain.load_state_dict(model.state_dict())
    g = small["g_t"]
    adj = SparseAdj(g.senders.long(), g.receivers.long(), g.edge_weight)
    x = _t(small["feat"])
    model.eval()
    assert torch.equal(model(x, adj)[0], plain(x, adj)[0])
    model.train()
    gen = torch.Generator().manual_seed(5)
    dropped = model(x, adj, dropout_gen=gen)[0]
    assert not torch.allclose(dropped, plain(x, adj)[0])
    # the first layer's output is untouched: its input was not dropped
    first = model.stack.conv_first(x, adj, gen)[0]
    assert torch.equal(first, plain.stack.conv_first(x, adj)[0])

    init = model.state_dict()
    runs = [train_node_classifier(
        GcnEncoderNode(**dims, dropout=d, device="cpu"), g, small["feat"],
        small["labels"], TrainConfig(num_epochs=10), init_params=init,
        device="cpu") for d in (0.5, 0.5, 0.0)]
    assert runs[0]["history"]["loss"] == runs[1]["history"]["loss"]
    assert runs[0]["history"]["loss"] != runs[2]["history"]["loss"]
    # the final predictions are an eval-mode forward: no dropout
    final = GcnEncoderNode(**dims, device="cpu")
    final.load_state_dict(runs[0]["params"])
    final.eval()
    with torch.no_grad():
        np.testing.assert_allclose(runs[0]["ypred"][0],
                                   final(x, adj)[0].numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_att_model_explained_like_tpugraph(small):
    """An attention model trained 30 epochs by tpugraph, explained on the
    COO path by both packages from the same mask init (JAX's per-query
    keys): the masked adjacencies and loss histories agree."""
    model_j, params, _ = _models(small, att=True)
    out_j = jax_loop.train_node_classifier(
        model_j, small["g_j"], small["feat"], small["labels"],
        jax_loop.TrainConfig(num_epochs=30, scan_chunk=30), init_params=params)
    cg = jax_preprocess(small["G_j"], small["labels"])
    n = cg["adj"].shape[1]
    pred = np.asarray(out_j["ypred"])[:, :n]
    feat = small["feat"][None, :n]
    queries = [n - 13, n - 7]  # house nodes
    cfg_kw = dict(num_epochs=10)
    ex_j = JaxExplainer(model_j, out_j["params"], cg["adj"], feat,
                        cg["labels"], pred, cfg=jax_module.ExplainConfig(**cfg_kw))
    res_j = ex_j.explain_nodes_batch(queries)

    g_j = ex_j._graph(0)
    keys = jax.random.split(jax.random.PRNGKey(0), len(queries))
    inits = []
    for q, node in enumerate(queries):
        nb = jax_khop.khop_subgraph(g_j, jnp.int32(node), 3)
        inits.append(jax_module.init_masks(keys[q], g_j.num_edges_padded, 10,
                                           nb.num_nodes,
                                           jax_module.ExplainConfig(**cfg_kw)))
    init = (np.stack([np.asarray(s.edge_logits) for s in inits]),
            np.stack([np.asarray(s.feat_logits) for s in inits]), None)
    model = GcnEncoderNode(**small["dims"], att=True, device="cpu")
    ex = Explainer(model, params_from_jax(out_j["params"]), cg["adj"], feat,
                   cg["labels"], pred, cfg=ExplainConfig(**cfg_kw), device="cpu")
    res = ex.explain_nodes_batch(queries, init_state=init)
    for r, r_j in zip(res, res_j):
        np.testing.assert_array_equal(r["neighbors"], r_j["neighbors"])
        np.testing.assert_allclose(r["masked_adj"], r_j["masked_adj"],
                                   rtol=1e-4, atol=1e-6)
        for k, ref in r_j["history"].items():
            np.testing.assert_allclose(r["history"][k], np.asarray(ref),
                                       rtol=1e-4, atol=1e-7, err_msg=k)


def test_att_tile_space_explain_loss_and_grads_match(small):
    """One step of the tile-space explainer on an attention model (the
    masked tiles scored by B2 and aggregated by B1 in every layer): the
    loss and the mask gradients against tpugraph's."""
    from tpugraph.core.graph import graph_from_dense as jax_graph_from_dense
    from tpugraph.explain import bcsr_explain as jax_bx
    from tpugraph_torch.core import graph_from_dense, khop_subgraph
    from tpugraph_torch.explain import bcsr_explain as bx

    cg = jax_preprocess(small["G_j"], small["labels"])
    adj = cg["adj"][0]
    g_j = jax_graph_from_dense(adj)
    s, r, w = (np.asarray(a) for a in (g_j.senders, g_j.receivers,
                                        g_j.edge_weight))
    m_j = jax_bcsr.bcsr_from_coo(s, r, w, g_j.num_nodes_padded)
    tp_j = jax_bcsr.bcsr_transpose_plan(m_j)
    partner = jax_bcsr.bcsr_sym_partner(m_j)
    model_j, params, model = _models(small, att=True)
    model.requires_grad_(False)
    rng = np.random.default_rng(2)
    x = np.zeros((m_j.num_nodes, 10), np.float32)
    x[: adj.shape[0]] = rng.uniform(0.5, 1.5, (adj.shape[0], 10))
    pred_vec = rng.integers(0, 4, m_j.num_nodes).astype(np.int32)
    node = adj.shape[0] - 8  # a house node
    nb = jax_khop.khop_subgraph(g_j, jnp.int32(node), 3)
    keep = np.zeros((m_j.num_nodes,), np.float32)
    keep[: g_j.num_nodes_padded] = np.asarray(nb.node_mask)
    cfg_j = jax_module.ExplainConfig(num_epochs=10)
    state0 = jax_bx.init_tile_masks(jax.random.PRNGKey(0), m_j.num_tiles,
                                    m_j.block, 10, nb.num_nodes, cfg_j)
    label = int(small["labels"][node])

    def loss_j(st):
        w_tiles, gate, kp = jax_bx.masked_tiles(
            m_j, jnp.asarray(partner), st, cfg_j, jnp.asarray(keep))
        xx = jnp.asarray(x) * jax.nn.sigmoid(st.feat_logits)
        masked = jax_bcsr.BCSR(w_tiles, m_j.col_blk, m_j.row_ptr, m_j.row_of,
                               m_j.num_nodes, m_j.block)
        masked_t = jax_bcsr.BCSR(
            jax.lax.stop_gradient(jax_bcsr.transpose_tiles(w_tiles, tp_j)),
            tp_j.col_blk, tp_j.row_ptr, tp_j.row_of, tp_j.num_nodes,
            tp_j.block)
        ypred, _ = model_j.apply(params, xx, JaxBCSRAdj(masked, masked_t, tp_j))
        total, _ = jax_bx.bcsr_explain_loss(
            jax.nn.softmax(ypred[node]), w_tiles, gate, m_j, st, cfg_j, label,
            jnp.asarray(pred_vec), nb.num_nodes, keep=kp)
        return total

    total_j, grads_j = jax.value_and_grad(loss_j)(state0)
    g = graph_from_dense(adj)
    m_h = bcsr.bcsr_from_coo(g.senders.numpy(), g.receivers.numpy(),
                             g.edge_weight.numpy(), g.num_nodes_padded)
    assert khop_subgraph(g, node, 3).num_nodes == int(nb.num_nodes)
    state = bx.BCSRMaskState(*(torch.tensor(np.asarray(a)).requires_grad_(True)
                               for a in state0))
    total, _ = bx.bcsr_mask_loss(
        model, m_h.to("cpu"), bcsr.bcsr_transpose_plan(m_h).to("cpu"),
        torch.from_numpy(bcsr.bcsr_sym_partner(m_h)).long(), _t(x), state,
        ExplainConfig(), node, label, _t(pred_vec), int(nb.num_nodes),
        node_keep=_t(keep))
    total.backward()
    np.testing.assert_allclose(total.item(), float(total_j), rtol=1e-5)
    for got, ref in zip(state, grads_j):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max())
    assert np.abs(state.tile_logits.grad.numpy()).max() > 0
