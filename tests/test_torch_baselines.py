"""The rest of the explainer against ``tpugraph``'s on the CPU, from the same
numpy inputs and parameters: the grad/att baselines (single queries, the
mapped batch with ``bn``, graph mode with its padding), representer
scores, the alignment, ``denoise_graph`` against networkx, and
``explain_nodes`` with its alignment."""

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from tpugraph.core import khop as jax_khop
from tpugraph.core.graph import graph_from_networkx as jax_graph_from_networkx
from tpugraph.data import featgen as jax_featgen
from tpugraph.data.gengraph import gen_syn1 as jax_gen_syn1
from tpugraph.data.gengraph import preprocess_input_graph as jax_preprocess
from tpugraph.explain import align as jax_align
from tpugraph.explain import baselines as jax_baselines
from tpugraph.explain import module as jax_module
from tpugraph.explain.explainer import Explainer as JaxExplainer
from tpugraph.explain import representer as jax_representer_module
from tpugraph.nn import GcnEncoderGraph as JaxGcnEncoderGraph
from tpugraph.nn import GcnEncoderNode as JaxGcnEncoderNode
from tpugraph.nn.layers import SparseAdj as JaxSparseAdj
from tpugraph.viz import graphs as jax_viz
from tpugraph_torch.core import extract_dense_subgraph
from tpugraph_torch.data import ConstFeatureGen, gen_syn1
from tpugraph_torch.data.pipeline import to_numpy_array
from tpugraph_torch.explain import Explainer, ExplainConfig, baselines
from tpugraph_torch.explain.align import Alignment, align_explanations
from tpugraph_torch.explain.representer import representer_scores
from tpugraph_torch.nn import GcnEncoderGraph, GcnEncoderNode, params_from_jax
from tpugraph_torch.viz import denoise_graph

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
OPTIONS = {"base": {}, "bn": dict(bn=True), "att": dict(att=True),
           "att_bn": dict(att=True, bn=True)}


@pytest.fixture(scope="module")
def small():
    """The small syn1 (seed 3, 8 houses on 40 BA nodes) in both packages,
    its cg bundle with random features, and queries whose neighborhoods
    fall in different 32-node buckets."""
    kw = dict(nb_shapes=8, width_basis=40, seed=3)
    G_j, labels, _ = jax_gen_syn1(
        feature_generator=jax_featgen.ConstFeatureGen(np.ones(10, np.float32)),
        **kw)
    G_t, _, _ = gen_syn1(
        feature_generator=ConstFeatureGen(np.ones(10, np.float32)), **kw)
    assert list(G_t.edges()) == list(G_j.edges())
    g_j = jax_graph_from_networkx(G_j)
    cg = jax_preprocess(G_j, labels)
    n = cg["adj"].shape[1]
    rng = np.random.default_rng(1)
    feat = rng.standard_normal((1, n, 10)).astype(np.float32)
    queries = [n - 13, n - 7, 2, 31]
    sizes = [extract_dense_subgraph(cg["adj"][0], feat[0], cg["labels"][0], q,
                                    3)[1].shape[0] for q in queries]
    assert len({(s + 31) // 32 for s in sizes}) > 1, sizes
    dims = dict(input_dim=10, hidden_dim=8, embedding_dim=8,
                label_dim=int(max(labels)) + 1, num_layers=3)
    return dict(g_j=g_j, adj=cg["adj"], label=cg["labels"], feat=feat,
                dims=dims, queries=queries, n=n)


def _models(small, opts, cls_j=JaxGcnEncoderNode, cls=GcnEncoderNode):
    """The same random parameters in both packages.  tpugraph's jit caches
    are keyed by the id of the apply function, which a later model's may
    reuse, so they are emptied first."""
    jax_baselines._GRAD_FN_CACHE.clear()
    jax_representer_module._JIT_CACHE.clear()
    model_j = cls_j(**small["dims"], **opts)
    g = small["g_j"]
    x = jnp.asarray(np.pad(small["feat"][0], ((0, g.num_nodes_padded - small["n"]),
                                               (0, 0))))
    params = model_j.init(jax.random.PRNGKey(0), x,
                          JaxSparseAdj(g.senders, g.receivers, g.edge_weight))
    model = cls(**small["dims"], **opts, device="cpu")
    model.load_state_dict(params_from_jax(params))
    model.eval()
    model.requires_grad_(False)
    return model_j, params, model


def _query(small, q):
    node_new, sub_adj, sub_feat, _, nbrs = extract_dense_subgraph(
        small["adj"][0], small["feat"][0], small["label"][0], q, 3)
    return node_new, sub_adj, sub_feat, int(q % small["dims"]["label_dim"])


def test_pad_stack_matches_tpugraph(small):
    qs = [_query(small, q) for q in small["queries"]]
    adjs, feats, ns = baselines._pad_stack([q[1] for q in qs], [q[2] for q in qs])
    adjs_j, feats_j, ns_j = jax_baselines._pad_stack([q[1] for q in qs],
                                                     [q[2] for q in qs])
    assert ns == ns_j and adjs.shape[1] % 32 == 0
    np.testing.assert_array_equal(adjs, adjs_j)
    np.testing.assert_array_equal(feats, feats_j)
    one = baselines._pad_stack([qs[0][1]], [qs[0][2]])
    a_j, f_j, n_j = jax_baselines._pad_bucket(qs[0][1], qs[0][2])
    np.testing.assert_array_equal(one[0][0], a_j)
    np.testing.assert_array_equal(one[1][0], f_j)
    assert one[2] == [n_j]


@pytest.mark.parametrize("opt", ["base", "bn"])
def test_grad_saliency_matches(small, opt):
    model_j, params, model = _models(small, OPTIONS[opt])
    apply_j = model_j.apply
    for q in small["queries"]:
        node_new, sub_adj, sub_feat, lab = _query(small, q)
        got = baselines.grad_saliency(model, sub_adj, sub_feat, node_new, lab)
        ref = jax_baselines.grad_saliency(apply_j, params, sub_adj, sub_feat,
                                          node_new, lab)
        assert got.shape == sub_adj.shape
        np.testing.assert_allclose(got, ref, **TOL, err_msg=str(q))
        assert np.all((got == 0) == (sub_adj == 0))
        got = baselines.grad_feat_saliency(model, sub_adj, sub_feat, node_new, lab)
        ref = jax_baselines.grad_feat_saliency(apply_j, params, sub_adj,
                                               sub_feat, node_new, lab)
        assert got.shape == sub_feat.shape
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=str(q))


def test_grad_saliency_batch_keeps_queries_apart(small):
    """With bn, a query's batch statistics are its own: the mapped batch
    equals tpugraph's vmapped one and each query alone, and running the
    model once over all queries (batch norm across them) would not."""
    model_j, params, model = _models(small, OPTIONS["bn"])
    apply_j = model_j.apply
    qs = [_query(small, q) for q in small["queries"]]
    args = ([q[1] for q in qs], [q[2] for q in qs], [q[0] for q in qs],
            [q[3] for q in qs])
    got = baselines.grad_saliency_batch(model, *args)
    ref = jax_baselines.grad_saliency_batch(apply_j, params, *args)
    for q, g, r in zip(qs, got, ref):
        np.testing.assert_allclose(g, r, **TOL)
        np.testing.assert_allclose(
            g, baselines.grad_saliency(model, q[1], q[2], q[0], q[3]),
            rtol=1e-6, atol=1e-6)

    adjs, feats, _ = baselines._pad_stack(args[0], args[1])
    a = torch.from_numpy(adjs).requires_grad_(True)
    ypred, _ = model(torch.from_numpy(feats), a)  # one forward, bn mixed
    loss = sum(-torch.log(torch.softmax(ypred[i, q[0]], -1)[q[3]] + 1e-12)
               for i, q in enumerate(qs))
    da, = torch.autograd.grad(loss, a)
    mixed = torch.sigmoid(da.abs() + da.abs().transpose(-1, -2)).numpy()
    n0 = qs[0][1].shape[0]
    assert not np.allclose(mixed[0, :n0, :n0] * qs[0][1], got[0], rtol=1e-3,
                           atol=1e-4)


@pytest.mark.parametrize("opt", ["att", "att_bn", "base"])
def test_attention_saliency_matches(small, opt):
    model_j, params, model = _models(small, OPTIONS[opt])
    apply_j = model_j.apply
    qs = [_query(small, q) for q in small["queries"]]
    for node_new, sub_adj, sub_feat, _ in qs[:2]:
        np.testing.assert_allclose(
            baselines.attention_saliency(model, sub_adj, sub_feat),
            jax_baselines.attention_saliency(apply_j, params, sub_adj, sub_feat),
            **TOL)
    got = baselines.attention_saliency_batch(model, [q[1] for q in qs],
                                             [q[2] for q in qs])
    ref = jax_baselines.attention_saliency_batch(apply_j, params,
                                                 [q[1] for q in qs],
                                                 [q[2] for q in qs])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, **TOL)


def test_graph_mode_grad_matches_with_its_padding(small):
    """A graph classifier's grad baseline on a 20-node graph: the padding to
    32 nodes enters the max-pool readout (no node_mask), so the result
    differs from an unpadded run, and it equals tpugraph's, directly and
    through the graph-mode Explainer."""
    rng = np.random.default_rng(4)
    n, b = 20, 3
    adj = np.zeros((b, n, n), np.float32)
    for i, k in enumerate((20, 14, 17)):
        up = np.triu((rng.random((k, k)) < 0.25).astype(np.float32), 1)
        adj[i, :k, :k] = up + up.T
    feat = rng.standard_normal((b, n, 10)).astype(np.float32)
    model_j = JaxGcnEncoderGraph(**small["dims"])
    params = model_j.init(jax.random.PRNGKey(2), jnp.asarray(feat),
                          jnp.asarray(adj))
    # nonzero biases, so padded nodes embed to nonzero rows in the readout
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (jnp.asarray(rng.standard_normal(v.shape), jnp.float32)
                         if path[-1].key == "bias" else v), params)
    model = GcnEncoderGraph(**small["dims"], device="cpu")
    model.load_state_dict(params_from_jax(params))
    model.eval()
    model.requires_grad_(False)
    jax_baselines._GRAD_FN_CACHE.clear()
    apply_j = model_j.apply
    for gi in range(b):
        got = baselines.grad_saliency(model, adj[gi], feat[gi], 0, 1,
                                      graph_mode=True)
        ref = jax_baselines.grad_saliency(apply_j, params, adj[gi], feat[gi], 0,
                                          1, graph_mode=True)
        np.testing.assert_allclose(got, ref, **TOL, err_msg=str(gi))

    a = torch.from_numpy(adj[0][None]).requires_grad_(True)
    ypred, _ = model(torch.from_numpy(feat[0][None]), a)
    da, = torch.autograd.grad(-torch.log(torch.softmax(ypred[0], -1)[1] + 1e-12), a)
    padded, _ = baselines._query_grads(model, [adj[0]], [feat[0]], [0], [1],
                                       graph_mode=True, argnum=0)
    assert not np.allclose(da[0].numpy(), padded[0, :n, :n].numpy(), rtol=1e-3,
                           atol=1e-3 * float(da.abs().max()))

    pred = rng.standard_normal((1, b, small["dims"]["label_dim"])).astype(np.float32)
    label = np.arange(b) % 2
    ex_j = JaxExplainer(model_j, params, adj, feat, label, pred, graph_mode=True)
    ex = Explainer(model, None, adj, feat, label, pred, graph_mode=True,
                   device="cpu")
    for gi in range(b):
        np.testing.assert_allclose(
            ex.explain(0, graph_idx=gi, graph_mode=True, model="grad"),
            ex_j.explain(0, graph_idx=gi, graph_mode=True, model="grad"), **TOL)


def test_representer_scores_match(small):
    model_j, params, model = _models(small, {})
    got = representer_scores(model, small["adj"], small["feat"], small["label"])
    ref = jax_representer_module.representer_scores(model_j.apply, params, small["adj"], small["feat"],
                          small["label"])
    np.testing.assert_allclose(got["pred"], ref["pred"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["alpha"], ref["alpha"], rtol=1e-6,
                               atol=1e-6 * np.abs(ref["alpha"]).max())


def _denoised_pair(seed):
    """Two denoised explanations' features and weighted adjacencies (7 and
    9 nodes, weights in [0.1, 1) as a 0.1 threshold leaves them)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (7, 9):
        up = np.triu(rng.uniform(0.1, 1.0, (n, n)) * (rng.random((n, n)) < 0.5), 1)
        out += [rng.standard_normal((n, 4)).astype(np.float32),
                (up + up.T).astype(np.float32)]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_align_explanations_matches(seed):
    """300 Adam steps at lr 1e-3 from the same inputs: P and the aligned
    adjacency and features within 1e-5 of tpugraph's."""
    ref_feat, ref_adj, cur_feat, cur_adj = _denoised_pair(seed)
    got = align_explanations(ref_feat, ref_adj, 2, cur_feat, cur_adj, 5,
                             num_steps=300, lr=1e-3, device="cpu")
    want = jax_align.align_explanations(ref_feat, ref_adj, 2, cur_feat, cur_adj,
                                        5, num_steps=300, lr=1e-3)
    for g, w, name in zip(got, want, ("P", "aligned_adj", "aligned_feat")):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)
    assert np.abs(got[0] - np.full_like(got[0], 1 / 7)).max() > 0.1


@pytest.mark.parametrize("const_feat", [False, True])
def test_align_explanations_default_rate_first_steps(const_feat):
    """At the default lr of 0.01 the optimization amplifies float32
    rounding: tpugraph's own run parts from a float64 one far beyond it
    within 300 steps, and the port's as far, so the two are held where
    the run is still conditioned: 10 steps within 1e-4
    (constant features, as syn1's, are the worse case: torch's Adam and
    optax's part by 6.4e-6 of an update in the first steps, and these
    inputs grow that to ~1.4e-5 in P)."""
    ref_feat, ref_adj, cur_feat, cur_adj = _denoised_pair(1)
    if const_feat:
        ref_feat, cur_feat = np.ones_like(ref_feat), np.ones_like(cur_feat)
    got = align_explanations(ref_feat, ref_adj, 2, cur_feat, cur_adj, 5,
                             num_steps=10, device="cpu")
    want = jax_align.align_explanations(ref_feat, ref_adj, 2, cur_feat, cur_adj,
                                        5, num_steps=10)
    for g, w, name in zip(got, want, ("P", "aligned_adj", "aligned_feat")):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=name)



@pytest.mark.parametrize("lr", [1e-3, 0.01])
def test_alignment_state_moves_exactly(lr):
    """A 300-step run cut into segments, each continued by a fresh
    Alignment from the last one's state, is align_explanations' run bit
    for bit."""
    ref_feat, ref_adj, cur_feat, cur_adj = _denoised_pair(2)
    args = (ref_feat, ref_adj, 2, cur_feat, cur_adj, 5)
    run = Alignment(*args, lr=lr, device="cpu")
    for _ in range(3):
        state = run.state()
        run = Alignment(*args, lr=lr, device="cpu")
        run.load(state)
        run.step(100)
    for g, w in zip(run.result(), align_explanations(*args, num_steps=300, lr=lr,
                                                     device="cpu")):
        np.testing.assert_array_equal(g, w)


class _Float64Gradient(Alignment):
    """The same Adam step with the loss and its gradient in float64: a
    rounding other than float32's, as another device's."""

    def step(self, num_steps):
        for _ in range(num_steps):
            P = self.P.detach().double().requires_grad_(True)
            loss = (torch.linalg.norm(P @ self.cf.double() - self.rf.double())
                    + torch.linalg.norm(P @ self.ca.double() @ P.T
                                        - self.ra.double()))
            self.opt.zero_grad()
            self.P.grad = torch.autograd.grad(loss, P)[0].float()
            self.opt.step()


@pytest.mark.parametrize("const_feat", [False, True])
def test_alignment_segments_are_conditioned(const_feat):
    """At the default lr the 1000-step P is chaotic, but 10 steps from any
    of its states are conditioned: another rounding of the gradient lands
    within 1e-4 of float32's from every 100th step (the bound the card's
    run is held to against the CPU's)."""
    ref_feat, ref_adj, cur_feat, cur_adj = _denoised_pair(1)
    if const_feat:
        ref_feat, cur_feat = np.ones_like(ref_feat), np.ones_like(cur_feat)
    args = (ref_feat, ref_adj, 2, cur_feat, cur_adj, 5)
    run, worst = Alignment(*args, device="cpu"), 0.0
    for _ in range(10):
        state = run.state()
        run.step(10)
        other = _Float64Gradient(*args, device="cpu")
        other.load(state)
        other.step(10)
        worst = max(worst, np.abs(other.result()[0] - run.result()[0]).max())
        run.step(90)
    print(f"10-step segments: max |float64 gradient - float32| {worst:.3g} "
          f"(limit 1e-4)")
    assert worst <= 1e-4

def _mask(seed, n=40):
    """A symmetric mask with weights on both sides of 0.1 and several
    components, the query (node 9) in the largest: {3, 9, 20, 30, 35}."""
    rng = np.random.default_rng(seed)
    m = np.zeros((n, n), np.float32)
    for u, v in ((3, 9), (9, 20), (20, 30), (30, 35), (3, 35), (1, 2), (2, 5),
                 (11, 12), (14, 14), (16, 17)):
        m[u, v] = m[v, u] = rng.uniform(0.15, 1.0)
    m[0, 1] = m[1, 0] = 0.05  # below 0.1
    m[22, 23] = 0.7           # one side only: a later write wins
    m[23, 22] = 0.4
    return m


DENOISE = {"threshold": dict(threshold=0.1), "top3": dict(threshold_num=3),
           "default": {}, "no_max_component": dict(threshold=0.1,
                                                   max_component=False),
           "nothing_kept": dict(threshold=2.0)}


@pytest.mark.parametrize("case", list(DENOISE))
def test_denoise_graph_matches_networkx(case):
    """Node and edge sets, weights, features, labels and the query marker
    equal networkx's; the port orders the nodes by id, so the dense
    matrices agree after that permutation."""
    m = _mask(0)
    n = m.shape[0]
    feat = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    label = np.arange(n) % 3
    G_j = jax_viz.denoise_graph(m, 9, feat=feat, label=label, **DENOISE[case])
    G = denoise_graph(m, 9, feat=feat, label=label, **DENOISE[case])
    order_j = list(G_j.nodes())
    assert G.nodes() == sorted(order_j)
    assert ({frozenset(e) for e in G.edges()}
            == {frozenset(e) for e in G_j.edges()})
    for u, v in G_j.edges():
        assert G.weight(u, v) == G_j[u][v]["weight"]
    for u in order_j:
        np.testing.assert_array_equal(G.feat[u], G_j.nodes[u]["feat"])
        assert G.attrs[u].get("label") == G_j.nodes[u]["label"]
        assert G.attrs[u].get("self") == G_j.nodes[u].get("self")
    perm = np.argsort(order_j)
    np.testing.assert_array_equal(to_numpy_array(G),
                                  nx.to_numpy_array(G_j)[np.ix_(perm, perm)])
    if case == "threshold":
        # networkx 3.6.1 lists this component by its set's internals
        assert order_j == [35, 3, 9, 20, 30] and G.nodes() == [3, 9, 20, 30, 35]
    if case == "no_max_component":
        assert G.weight(22, 23) == np.float32(0.4)


def test_explain_nodes_aligns_like_tpugraph(small):
    """explain_nodes from JAX's mask init: the masks, and the alignment of
    the first two denoised explanations after the permutation by node id,
    within 1e-4 (20 alignment steps: see the default-rate test above)."""
    model_j, params, model = _models(small, {})
    adj, feat, label = small["adj"], small["feat"], small["label"]
    pred = np.asarray(model_j.apply(params, jnp.asarray(feat), jnp.asarray(adj))[0])
    queries = small["queries"][:3]
    cfg_kw = dict(num_epochs=10)
    ex_j = JaxExplainer(model_j, params, adj, feat, label, pred,
                        cfg=jax_module.ExplainConfig(**cfg_kw))
    ex_j.align_steps = 20
    masks_j = ex_j.explain_nodes(queries)
    g_j = ex_j._graph(0)
    keys = jax.random.split(jax.random.PRNGKey(0), len(queries))
    inits = [jax_module.init_masks(
        keys[q], g_j.num_edges_padded, 10,
        jax_khop.khop_subgraph(g_j, jnp.int32(node), 3).num_nodes,
        jax_module.ExplainConfig(**cfg_kw)) for q, node in enumerate(queries)]
    init = (np.stack([np.asarray(s.edge_logits) for s in inits]),
            np.stack([np.asarray(s.feat_logits) for s in inits]), None)

    ex = Explainer(model, None, adj, feat, label, pred,
                   cfg=ExplainConfig(**cfg_kw), device="cpu")
    ex.align_steps = 20
    masks = ex.explain_nodes(queries, init_state=init)
    for m, m_j in zip(masks, masks_j):
        np.testing.assert_allclose(m, m_j, rtol=1e-4, atol=1e-6)
    assert ex.last_alignment is not None and ex_j.last_alignment is not None

    res_j = ex_j.explain_nodes_batch(queries[:2])
    perms = []
    for r in res_j:
        G_j = jax_viz.denoise_graph(r["masked_adj"], r["node_idx_new"],
                                    threshold=0.1)
        perms.append(np.argsort(list(G_j.nodes())))
    p_ref, p_cur = perms
    got, want = ex.last_alignment, ex_j.last_alignment
    np.testing.assert_allclose(got["P"], want["P"][np.ix_(p_ref, p_cur)],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["aligned_adj"],
                               want["aligned_adj"][np.ix_(p_ref, p_ref)],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["aligned_feat"],
                               np.asarray(want["aligned_feat"])[p_ref],
                               rtol=1e-4, atol=1e-4)


def test_explain_nodes_skips_alignment_off_the_largest_component(small,
                                                                 tmp_path):
    """When a query's own edges fall under the 0.1 threshold but others do
    not, the query is not in its largest component: the masks are saved
    and no alignment is made (tpugraph reaches this through list.index
    raising ValueError)."""
    _, _, model = _models(small, {})
    ex = Explainer(model, None, small["adj"], small["feat"], small["label"],
                   np.zeros((1, small["n"], 4), np.float32), logdir=str(tmp_path),
                   cfg=ExplainConfig(num_epochs=1), device="cpu")
    real = ex.explain_nodes_batch(small["queries"][:2])
    crafted = []
    for r in real:
        m = r["masked_adj"].copy()
        m[r["node_idx_new"], :] = m[:, r["node_idx_new"]] = 0.05
        crafted.append({**r, "masked_adj": m})
    ex.explain_nodes_batch = lambda *a, **k: crafted
    masks = ex.explain_nodes([r["node_idx"] for r in real])
    assert ex.last_alignment is None and len(masks) == 2
    assert not (tmp_path / "aligned_adj.npy").exists()
    assert len(list(tmp_path.glob("masked_adj_*.npy"))) == 2

