"""The port's tile-space explainer against tpugraph's (same parameters,
same mask init), and its AUC against sklearn."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import roc_auc_score

from tpugraph.core.graph import graph_from_dense as jax_graph_from_dense
from tpugraph.core.khop import khop_subgraph as jax_khop
from tpugraph.data.gengraph import gen_syn1 as jax_gen_syn1
from tpugraph.data.gengraph import preprocess_input_graph as jax_preprocess
from tpugraph.explain import bcsr_explain as jax_bx
from tpugraph.explain.groundtruth import explanation_auc as jax_explanation_auc
from tpugraph.explain.module import ExplainConfig as JaxExplainConfig
from tpugraph.nn import GcnEncoderNode as JaxGcnEncoderNode
from tpugraph.nn.layers import BCSRAdj as JaxBCSRAdj, SparseAdj
from tpugraph.ops import bcsr as jax_bcsr
from tpugraph_torch.core import graph_from_dense, khop_subgraph
from tpugraph_torch.explain import ExplainConfig, explanation_auc
from tpugraph_torch.explain import bcsr_explain as bx
from tpugraph_torch.explain.groundtruth import roc_auc
from tpugraph_torch.nn import GcnEncoderNode, params_from_jax
from tpugraph_torch.ops import bcsr

torch.set_num_threads(1)

DIMS = dict(input_dim=10, hidden_dim=20, embedding_dim=20, label_dim=4,
            num_layers=3)
NODE = 405  # a house node of syn1


@pytest.fixture(scope="module")
def case():
    """One syn1 query packed by both packages, JAX params, and the JAX
    tile-mask init for it."""
    G, labels, _ = jax_gen_syn1(seed=0)
    cg = jax_preprocess(G, labels)
    adj = cg["adj"][0]
    g_j = jax_graph_from_dense(adj)
    s, r, w = (np.asarray(a) for a in (g_j.senders, g_j.receivers, g_j.edge_weight))
    m_j = jax_bcsr.bcsr_from_coo(s, r, w, g_j.num_nodes_padded)
    tp_j = jax_bcsr.bcsr_transpose_plan(m_j)
    partner = jax_bcsr.bcsr_sym_partner(m_j)
    model_j = JaxGcnEncoderNode(**DIMS)
    rng = np.random.default_rng(1)
    x = np.zeros((m_j.num_nodes, 10), np.float32)
    x[: adj.shape[0]] = rng.uniform(0.5, 1.5, (adj.shape[0], 10))
    params = model_j.init(jax.random.PRNGKey(0), jnp.asarray(x[: g_j.num_nodes_padded]),
                          SparseAdj(g_j.senders, g_j.receivers, g_j.edge_weight))
    pred_vec = rng.integers(0, 4, m_j.num_nodes).astype(np.int32)
    nb = jax_khop(g_j, jnp.int32(NODE), 3)
    keep = np.zeros((m_j.num_nodes,), np.float32)
    keep[: g_j.num_nodes_padded] = np.asarray(nb.node_mask)
    num_sub = int(nb.num_nodes)
    cfg_j = JaxExplainConfig(num_epochs=10)
    state0 = jax_bx.init_tile_masks(jax.random.PRNGKey(0), m_j.num_tiles,
                                    m_j.block, 10, jnp.int32(num_sub), cfg_j)
    return dict(adj=adj, labels=np.asarray(labels), m_j=m_j, tp_j=tp_j,
                partner=partner, model_j=model_j, params=params, x=x,
                pred_vec=pred_vec, keep=keep, num_sub=num_sub, cfg_j=cfg_j,
                state0=state0, nb=nb)


def _port_inputs(case):
    g = graph_from_dense(case["adj"])
    m_host = bcsr.bcsr_from_coo(g.senders.numpy(), g.receivers.numpy(),
                                g.edge_weight.numpy(), g.num_nodes_padded)
    nb = khop_subgraph(g, NODE, 3)
    assert nb.num_nodes == case["num_sub"]
    assert nb.new_index == int(case["nb"].new_index)
    np.testing.assert_array_equal(nb.node_mask,
                                  np.asarray(case["nb"].node_mask))
    model = GcnEncoderNode(**DIMS, device="cpu")
    model.load_state_dict(params_from_jax(case["params"]))
    model.requires_grad_(False)
    return dict(
        model=model, m=m_host.to("cpu"),
        tp=bcsr.bcsr_transpose_plan(m_host).to("cpu"),
        partner=torch.from_numpy(bcsr.bcsr_sym_partner(m_host)).long(),
        x=torch.from_numpy(case["x"]),
        pred_vec=torch.from_numpy(case["pred_vec"]),
        keep=torch.from_numpy(case["keep"]),
    )


def _jax_loss(case, state, spmm_dtype=None):
    """tpugraph's per-step objective (run_bcsr_mask_optimization.loss_fn)."""
    m, tp, cfg = case["m_j"], case["tp_j"], case["cfg_j"]
    w_tiles, gate, keep = jax_bx.masked_tiles(
        m, jnp.asarray(case["partner"]), state, cfg, jnp.asarray(case["keep"]))
    xx = jnp.asarray(case["x"]) * jax.nn.sigmoid(state.feat_logits)
    w_run = w_tiles if spmm_dtype is None else w_tiles.astype(spmm_dtype)
    masked = jax_bcsr.BCSR(w_run, m.col_blk, m.row_ptr, m.row_of,
                           m.num_nodes, m.block)
    masked_t = jax_bcsr.BCSR(
        jax.lax.stop_gradient(jax_bcsr.transpose_tiles(w_run, tp)),
        tp.col_blk, tp.row_ptr, tp.row_of, tp.num_nodes, tp.block)
    ypred, _ = case["model_j"].apply(case["params"], xx,
                                     JaxBCSRAdj(masked, masked_t, tp))
    probs = jax.nn.softmax(ypred[NODE])
    total, _ = jax_bx.bcsr_explain_loss(
        probs, w_tiles, gate, m, state, cfg, case["labels"][NODE],
        jnp.asarray(case["pred_vec"]), jnp.int32(case["num_sub"]), keep=keep)
    return total


@pytest.mark.parametrize("spmm_dtype", [None, torch.bfloat16])
def test_bcsr_explain_loss_and_grad_match(case, spmm_dtype):
    """One step's loss and gradients, f32 and with bf16 kernel tiles.  The
    bf16 roundings (tiles and each layer's x) are the same on both sides,
    so only f32 sums differ; a tile gradient rounded to bf16 (2^-9
    relative) would miss the 1e-4 here."""
    jdt = None if spmm_dtype is None else jnp.bfloat16
    total_j, grads_j = jax.value_and_grad(lambda s: _jax_loss(case, s, jdt))(
        case["state0"])
    p = _port_inputs(case)
    state = bx.BCSRMaskState(
        *(torch.tensor(np.asarray(a)).requires_grad_(True) for a in case["state0"]))
    total, terms = bx.bcsr_mask_loss(
        p["model"], p["m"], p["tp"], p["partner"], p["x"], state,
        ExplainConfig(), NODE, int(case["labels"][NODE]), p["pred_vec"],
        case["num_sub"], node_keep=p["keep"], spmm_dtype=spmm_dtype)
    total.backward()
    np.testing.assert_allclose(total.item(), float(total_j), rtol=1e-5)
    for got, ref in zip(state, grads_j):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max())
    assert np.abs(state.tile_logits.grad.numpy()).max() > 0


def test_bcsr_mask_optimization_matches(case):
    """10 Adam steps from the same init give the same mask logits."""
    st_j, w_j, hist_j = jax_bx.run_bcsr_mask_optimization(
        case["model_j"].apply, case["params"], case["m_j"], case["tp_j"],
        jnp.asarray(case["partner"]), jnp.asarray(case["x"]),
        node_idx=jnp.int32(NODE), gt_label=jnp.int32(case["labels"][NODE]),
        pred_label_vec=jnp.asarray(case["pred_vec"]),
        num_sub_nodes=jnp.int32(case["num_sub"]), key=jax.random.PRNGKey(0),
        cfg=case["cfg_j"], node_keep=jnp.asarray(case["keep"]))
    p = _port_inputs(case)
    st, w, hist = bx.run_bcsr_mask_optimization(
        p["model"], p["m"], p["tp"], p["partner"], p["x"], NODE,
        int(case["labels"][NODE]), p["pred_vec"], case["num_sub"],
        ExplainConfig(num_epochs=10), node_keep=p["keep"],
        init_state=tuple(np.asarray(a) for a in case["state0"]))
    np.testing.assert_allclose(st.tile_logits.numpy(),
                               np.asarray(st_j.tile_logits), atol=1e-4)
    np.testing.assert_allclose(st.feat_logits.numpy(),
                               np.asarray(st_j.feat_logits), atol=1e-4)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=1e-4)
    np.testing.assert_allclose(hist["total"], np.asarray(hist_j["total"]),
                               rtol=1e-4)


def test_bcsr_mask_optimization_bf16_matches(case):
    """``spmm_dtype=bf16``: 10 Adam steps from the same init give JAX's
    loss-term history and mask logits.  Both sides round the same tiles
    and layer inputs to bf16 (RNE); f32 sums in another order may flip one
    such rounding by one bf16 ulp (2^-7 relative), so each loss term holds
    to 2^-7 of its largest magnitude and the logits to 1e-3."""
    st_j, _, hist_j = jax_bx.run_bcsr_mask_optimization(
        case["model_j"].apply, case["params"], case["m_j"], case["tp_j"],
        jnp.asarray(case["partner"]), jnp.asarray(case["x"]),
        node_idx=jnp.int32(NODE), gt_label=jnp.int32(case["labels"][NODE]),
        pred_label_vec=jnp.asarray(case["pred_vec"]),
        num_sub_nodes=jnp.int32(case["num_sub"]), key=jax.random.PRNGKey(0),
        cfg=case["cfg_j"], node_keep=jnp.asarray(case["keep"]),
        spmm_dtype=jnp.bfloat16)
    p = _port_inputs(case)
    st, _, hist = bx.run_bcsr_mask_optimization(
        p["model"], p["m"], p["tp"], p["partner"], p["x"], NODE,
        int(case["labels"][NODE]), p["pred_vec"], case["num_sub"],
        ExplainConfig(num_epochs=10), node_keep=p["keep"],
        init_state=tuple(np.asarray(a) for a in case["state0"]),
        spmm_dtype=torch.bfloat16)
    assert set(hist) == set(hist_j)
    for k, ref in hist_j.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(hist[k], ref, rtol=0,
                                   atol=2.0 ** -7 * np.abs(ref).max(), err_msg=k)
    np.testing.assert_allclose(st.tile_logits.numpy(),
                               np.asarray(st_j.tile_logits), atol=1e-3)


def test_spmm_dtype_tile_gradient_not_rounded():
    """torch rounds a gradient to its input's dtype; the bf16 cast happens
    inside the autograd Function, so the tile gradient is B2's f32 output
    on the bf16 support, as JAX's, and not a bf16 value."""
    from tpugraph_torch.ops import bcsr_kernels

    rng = np.random.default_rng(2)
    n = 256
    s = rng.integers(0, n, 1500).astype(np.int32)
    r = rng.integers(0, n, 1500).astype(np.int32)
    w = rng.standard_normal(1500).astype(np.float32)
    m = bcsr.bcsr_from_coo(s, r, w, n, block=128)
    tp = bcsr.bcsr_transpose_plan(m).to("cpu")
    m = m.to("cpu")
    m_tr = bcsr.BCSR(bcsr.transpose_tiles(m.tiles.bfloat16(), tp), tp.col_blk,
                     tp.row_ptr, tp.row_of, tp.num_nodes, tp.block)
    assert m_tr.tiles.dtype == torch.float32  # f32 keep widens, as in JAX
    x = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
    tiles = m.tiles.clone().requires_grad_(True)
    y = bcsr_kernels.bcsr_matvec_dw_pair(dataclasses.replace(m, tiles=tiles),
                                         m_tr, x, spmm_dtype=torch.bfloat16)
    (dtiles,) = torch.autograd.grad(y, tiles, g)
    ref = bcsr_kernels.sddmm_bcsr_plain(
        dataclasses.replace(m, tiles=m.tiles.bfloat16()), g, x)
    assert dtiles.dtype == torch.float32 and torch.equal(dtiles, ref)
    assert bool((dtiles != dtiles.bfloat16().float()).any())
    np.testing.assert_array_equal(
        y.detach(), bcsr_kernels.spmm_bcsr_plain(
            dataclasses.replace(m, tiles=m.tiles.bfloat16()), x))


def test_explainer_spmm_dtype_hook(case):
    """``Explainer._spmm_dtype`` reaches ``run_bcsr_mask_optimization``'s
    ``spmm_dtype``: ``explain_nodes_bcsr`` with it set to bf16 gives the
    direct call's history exactly, and not the f32 one.  The public
    signatures carry no such option, as tpugraph's do not."""
    import inspect

    from tpugraph_torch.explain import Explainer

    n = case["adj"].shape[0]
    p = _port_inputs(case)
    pred = np.eye(4, dtype=np.float32)[case["pred_vec"][:n]][None]
    ex = Explainer(p["model"], None, case["adj"][None], case["x"][None, :n],
                   case["labels"][None], pred, cfg=ExplainConfig(num_epochs=10),
                   device="cpu")
    hist32 = ex.explain_nodes_bcsr([NODE])[0]["history"]
    ex._spmm_dtype = torch.bfloat16
    hist16 = ex.explain_nodes_bcsr([NODE])[0]["history"]
    g, _, m, tp, partner, x, pred_vec = ex._bcsr_pack(0, 128)
    nb = khop_subgraph(g, NODE, 3)
    keep = torch.zeros((m.num_nodes,))
    keep[: nb.node_mask.shape[0]] = torch.from_numpy(nb.node_mask)
    _, _, ref = bx.run_bcsr_mask_optimization(
        ex.model, m, tp, partner, x, NODE, int(case["labels"][NODE]), pred_vec,
        nb.num_nodes, ex.cfg, generator=torch.Generator().manual_seed(ex.seed),
        node_keep=keep, spmm_dtype=torch.bfloat16)
    for k, v in ref.items():
        np.testing.assert_array_equal(hist16[k], v, err_msg=k)
    assert not np.array_equal(hist16["total"], hist32["total"])
    for fn in (Explainer.__init__, Explainer.explain_nodes_bcsr):
        assert "spmm_dtype" not in inspect.signature(fn).parameters


def test_explanation_auc_matches_sklearn():
    rng = np.random.default_rng(0)
    y = (rng.random(500) < 0.3).astype(np.float64)
    score = np.round(rng.random(500) + 0.5 * y, 1)  # many ties
    assert roc_auc(y, score) == pytest.approx(roc_auc_score(y, score), abs=1e-12)
    with pytest.raises(ValueError):
        roc_auc(np.zeros(4), np.arange(4.0))
    adjs, starts = [], []
    for k in range(4):
        a = np.triu(rng.random((12, 12)) * (rng.random((12, 12)) < 0.5), 1)
        adjs.append((a + a.T).astype(np.float32))
        starts.append(k)
    auc, real, pred = explanation_auc(adjs, starts, "syn1")
    auc_j, real_j, pred_j = jax_explanation_auc(adjs, starts, "syn1")
    np.testing.assert_array_equal(real, real_j)
    np.testing.assert_array_equal(pred, pred_j)
    assert auc == pytest.approx(auc_j, abs=1e-12)
