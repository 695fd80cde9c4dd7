"""The port's DeeperGCN (``nn.GENConv``, ``nn.DeeperGcnEncoderNode``, the
softmax aggregation's plain versions in ``ops/gen_kernels.py``,
``train.loop``'s self-looped adjacency and ``cli.train --method
deepergcn``) held on the CPU to the plain reference
``reference/deepergcn.py`` on seeded inputs.  The JAX package has no such
model, so nothing here runs ``tpugraph``; the kernels themselves run on
the card only (``tests/test_torch_cuda.py``).

Tolerances: the port and the reference compute the same float32 sums in
other orders (the port chunks each row's edges along the CSR work list;
the reference's literal form sums by ``index_add``, its card form by
torch's sparse products), so results are compared relative to the
largest entry at a few float32 ulps of accumulated rounding: 2e-6 for the
aggregation alone, 2e-5 for one layer, 5e-5 for the encoder and its
gradients, 1e-4 for three Adam steps.  A GENConv's bias has no gradient in
exact arithmetic (every path from it to the loss passes a batch norm,
which removes a per-channel shift), so gradients are held to the largest
reference gradient of the model, and Adam's steps, which move such a leaf
by about lr on rounding noise alone, are compared on the other leaves."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from reference import deepergcn as ref
from tpugraph_torch.core.graph import graph_from_edges
from tpugraph_torch.nn import DeeperGcnEncoderNode, GatEncoderNode, GENConv
from tpugraph_torch.ops import csr as row_csr
from tpugraph_torch.ops import gen_kernels as gk
from tpugraph_torch.train import TrainConfig, loop, train_node_classifier

REPO = Path(__file__).resolve().parents[1]
STATS = ("running_mean", "running_var", "num_batches_tracked")


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _graph(seed=0, n=300, e=2000):
    """A 300-node random graph with both edge directions; node 7 sends and
    receives 400 more edges, so with chunks of 64 its rows are split."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    s[:400] = 7
    return graph_from_edges(np.concatenate([s, r]), np.concatenate([r, s]), n), rng


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(row_csr, "CHUNK_EDGES", 64)
    g, rng = _graph()
    adj, n = loop.self_loop_adjacency(g, torch.device("cpu"))
    assert adj.csr.a.splits.shape[0] >= 1 and adj.csr.a_t.splits.shape[0] >= 1
    return adj, n, rng


def _rel(a, b, scale=None):
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    top = float(b.abs().max()) if scale is None else scale
    return float((a - b).abs().max()) / max(top, 1e-30)


def _split(state):
    params = {k: v.detach().clone().requires_grad_(True) for k, v in state.items()
              if not k.endswith(STATS)}
    bufs = {k: v.detach().clone() for k, v in state.items() if k.endswith(STATS)}
    return params, bufs


def _x(rng, n, d, scale=1.0):
    return torch.from_numpy((rng.standard_normal((n, d)) * scale).astype(np.float32))


def _model(seed=0, layers=5):
    return DeeperGcnEncoderNode(10, 16, 4, num_layers=layers,
                                generator=torch.Generator().manual_seed(seed), device="cpu")


def test_parameter_count_is_the_leaderboard_entry():
    """At the published sizes (128 -> 128, 28 layers, 40 classes) the model
    holds the OGB leaderboard entry's 491,176 parameters."""
    m = DeeperGcnEncoderNode(128, 128, 40, num_layers=28, device="cpu")
    assert sum(p.numel() for p in m.parameters()) == 491_176
    assert m.self_loops and GatEncoderNode.self_loops


@pytest.mark.parametrize("t,eps", [(0.1, 1e-7), (1.0, 0.5), (8.0, 1e-7), (-2.0, 1e-3)],
                         ids=["published", "t1_eps_half", "t8", "negative_t"])
def test_genconv_forward_and_gradients_match_reference(small, t, eps):
    """One layer, ``(x + m) W + b`` with the literal aggregation, at the
    published ``t`` and ``eps`` and at others (a sharp softmax, a large
    offset, a negative temperature)."""
    adj, n, rng = small
    conv = GENConv(12, 9, t=t, eps=eps, generator=torch.Generator().manual_seed(3))
    x = _x(rng, n, 12, 3.0).requires_grad_(True)
    g_out = _x(rng, n, 9)
    y = conv(x, adj)
    (y * g_out).sum().backward()
    st = ref.structure(adj.senders, adj.receivers, n)
    xr = x.detach().clone().requires_grad_(True)
    w, b = (p.detach().clone().requires_grad_(True) for p in (conv.weight, conv.bias))
    y_ref = (xr + ref.aggregate_literal(xr, st, t, eps)) @ w + b
    dx, dw, db = torch.autograd.grad((y_ref * g_out).sum(), (xr, w, b))
    assert _rel(y.detach(), y_ref.detach()) < 2e-5
    assert _rel(x.grad, dx) < 2e-5
    assert _rel(conv.weight.grad, dw) < 2e-5 and _rel(conv.bias.grad, db) < 2e-5


@pytest.mark.parametrize("scale,t,tol", [(1.0, 0.1, 2e-6), (80.0, 1.0, 2e-5)],
                         ids=["unit", "scores_80"])
def test_plain_versions_walk_split_rows_like_the_literal_form(small, scale, t, tol):
    """The forward and backward twins over work lists with split rows (node
    7's 400+ edges in chunks of 64) against the literal aggregation and its
    autograd, with ``t mu`` up to 80 (exp overflows without each row's
    maximum; an exponent near 80 carries some 80 float32 ulps of 1, hence
    the wider tolerance there); the autograd wrapper takes the same twins on
    the CPU."""
    adj, n, rng = small
    x = _x(rng, n, 6, scale)
    g = _x(rng, n, 6)
    m, lse = gk.softmax_aggr_plain(adj.csr.a, x, t, 1e-7)
    assert torch.isfinite(m).all() and torch.isfinite(lse).all()
    st = ref.structure(adj.senders, adj.receivers, n)
    xr = x.clone().requires_grad_(True)
    m_ref = ref.aggregate_literal(xr, st, t, 1e-7)
    (dx_ref,) = torch.autograd.grad((m_ref * g).sum(), xr)
    assert _rel(m, m_ref.detach()) < tol
    dx = gk.softmax_aggr_backward_plain(adj.csr.a_t, x, g, lse, t, 1e-7)
    assert _rel(dx, dx_ref) < tol
    xa = x.clone().requires_grad_(True)
    ma = gk.softmax_aggr(adj.csr, xa, t, 1e-7)
    assert torch.equal(ma.detach(), m)
    (ma * g).sum().backward()
    assert torch.equal(xa.grad, dx)


def test_lse_is_each_row_and_channel_log_sum_exp(small):
    """``lse`` against float64 math over the same edges, and ``m`` of a
    node whose only in-edge is its self-loop is its own message."""
    adj, n, rng = small
    x = _x(rng, n, 5, 4.0)
    _, lse = gk.softmax_aggr_plain(adj.csr.a, x, 0.7, 1e-7)
    s, r = adj.senders, adj.receivers
    sc = 0.7 * (torch.relu(x.double()) + 1e-7)[s]
    want = torch.zeros(n, 5, dtype=torch.float64).index_add(0, r, torch.exp(sc)).log()
    assert _rel(lse, want) < 1e-6
    g = graph_from_edges(np.array([0, 1], np.int32), np.array([1, 0], np.int32), 3)
    a3, _ = loop.self_loop_adjacency(g, torch.device("cpu"))
    x3 = torch.tensor([[1.0, -2.0], [0.5, 3.0], [-1.0, 4.0]])
    m3, lse3 = gk.softmax_aggr_plain(a3.csr.a, x3, 0.1, 1e-7)
    assert torch.equal(m3[2], torch.relu(x3[2]) + 1e-7)
    assert torch.equal(lse3[2], 0.1 * (torch.relu(x3[2]) + 1e-7))


def test_empty_row_writes_zero_and_infinite_lse():
    """A row with no in-edge (not in a self-looped adjacency, but the
    twins take any CSR) gives ``m = 0`` and ``lse = +inf``."""
    from tpugraph_torch.ops.coo_kernels import edge_csr

    csr = edge_csr(torch.tensor([0, 1]), torch.tensor([1, 0]), 3)
    m, lse = gk.softmax_aggr_plain(csr.a, torch.ones(3, 2), 0.1, 1e-7)
    assert torch.equal(m[2], torch.zeros(2)) and torch.isinf(lse[2]).all()


def test_split_rows_agree_with_unsplit_rows(monkeypatch):
    """The chunked merge (maxima, sums and partials added in chunk order)
    gives the unchunked rows' numbers within rounding."""
    g, rng = _graph(3)
    out = []
    for chunk in (16, 100000):
        monkeypatch.setattr(row_csr, "CHUNK_EDGES", chunk)
        adj, n = loop.self_loop_adjacency(g, torch.device("cpu"))
        if not out:
            x, gr = _x(rng, n, 7, 5.0), _x(rng, n, 7)
        m, lse = gk.softmax_aggr_plain(adj.csr.a, x, 1.0, 1e-7)
        out.append((m, lse, gk.softmax_aggr_backward_plain(adj.csr.a_t, x, gr, lse, 1.0,
                                                           1e-7)))
    for a, b in zip(*out):  # some 30 ulps: exp(max_i - max) rescales each chunk
        assert _rel(a, b) < 1e-5


def test_gradient_stops_at_the_softmax_weights(small):
    """``softmax_sg``: the gradient is ``[x > 0] sum_v w_uv g_v`` with the
    weights held fixed, which differs from the gradient through the
    weights as well."""
    adj, n, rng = small
    x = _x(rng, n, 4, 2.0)
    g = _x(rng, n, 4)
    xa = x.clone().requires_grad_(True)
    (gk.softmax_aggr(adj.csr, xa, 1.0, 1e-7) * g).sum().backward()
    s, r = adj.senders, adj.receivers
    xd = x.double().clone().requires_grad_(True)
    mu = (torch.relu(xd) + 1e-7)[s]
    lse = torch.zeros(n, 4, dtype=torch.float64).index_add(0, r, torch.exp(mu)).log()
    w = torch.exp(mu - lse[r])
    full = torch.zeros(n, 4, dtype=torch.float64).index_add(0, r, w * mu)
    (through_w,) = torch.autograd.grad((full * g.double()).sum(), xd, retain_graph=True)
    fixed = torch.zeros(n, 4, dtype=torch.float64).index_add(0, r, w.detach() * mu)
    (stopped,) = torch.autograd.grad((fixed * g.double()).sum(), xd)
    assert _rel(xa.grad, stopped) < 2e-6
    assert _rel(through_w, stopped) > 1e-2
    assert torch.equal(xa.grad[x <= 0], torch.zeros_like(xa.grad[x <= 0]))


def test_literal_and_card_forms_agree_and_the_card_form_raises(small):
    """The reference's two aggregations, values and gradients, and the
    card form's check: a channel whose ``t mu`` spans 600 or more raises."""
    adj, n, rng = small
    st = ref.structure(adj.senders, adj.receivers, n)
    x = _x(rng, n, 8, 3.0)
    g = _x(rng, n, 8)
    outs = []
    for fn in (ref.aggregate_literal, ref.aggregate):
        xr = x.clone().requires_grad_(True)
        m = fn(xr, st, 0.5, 1e-7)
        outs.append((m.detach(), torch.autograd.grad((m * g).sum(), xr)[0]))
    assert _rel(outs[1][0], outs[0][0]) < 2e-6 and _rel(outs[1][1], outs[0][1]) < 2e-6
    with pytest.raises(RuntimeError, match="underflow"):
        ref.aggregate(x * 1000.0, st, 0.5, 1e-7)


def test_encoder_logits_and_gradients_match_reference(small):
    adj, n, rng = small
    model = _model()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    x = _x(rng, n, 10)
    logits, att = model(x, adj)
    assert att == [] and logits.shape == (n, 4)
    w = _x(rng, n, 4)
    (logits * w).sum().backward()
    params, bufs = _split(state)
    st = ref.structure(adj.senders, adj.receivers, n)
    want = ref.forward(params, bufs, x, st, num_layers=5, t=0.1, eps=1e-7, training=True,
                       literal=True)
    assert _rel(logits.detach(), want.detach()) < 5e-5
    grads = torch.autograd.grad((want * w).sum(), list(params.values()))
    named = dict(model.named_parameters())
    assert set(named) == set(params)
    top = max(float(gr.abs().max()) for gr in grads)
    for k, gr in zip(params, grads):
        assert _rel(named[k].grad, gr, max(float(gr.abs().max()), 1e-2 * top)) < 5e-5, k
    for k, v in bufs.items():
        assert _rel(model.state_dict()[k], v) < 1e-6, k
    model.eval()
    with torch.no_grad():
        ev = model(x, adj)[0]
    assert _rel(ev, ref.forward(params, bufs, x, st, num_layers=5, t=0.1, eps=1e-7,
                                training=False, literal=True).detach()) < 5e-5


def test_three_training_steps_match_the_reference_job():
    """``train_node_classifier`` on a DeeperGCN model for 3 epochs (its
    adjacency from a padded graph) against the reference's job with the
    literal aggregation: each loss and the parameters (GENConv biases
    aside); the closing evaluation's logits against the reference's
    evaluation of the trained state."""
    g, rng = _graph(5)
    n = g.n_node
    feat = rng.standard_normal((g.num_nodes_padded, 10)).astype(np.float32)
    labels = rng.integers(0, 4, n)
    model = _model(1)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = TrainConfig(num_epochs=3, lr=0.01, clip=0.0, weight_decay=0.0)
    out = train_node_classifier(model, g, feat, labels, cfg, seed=4, init_params=state,
                                device="cpu")
    assert out["ypred"].shape == (1, n, 4)
    adj = out["adj"]
    train_idx, _ = ref.split_nodes(n, cfg.train_ratio, 4)
    assert np.array_equal(np.sort(out["train_idx"]), np.sort(train_idx))
    job = ref.train_job(state, torch.from_numpy(feat[:n]),
                        ref.structure(adj.senders, adj.receivers, n),
                        torch.from_numpy(labels), torch.from_numpy(train_idx),
                        num_layers=5, t=0.1, eps=1e-7, lr=0.01, weight_decay=0.0,
                        clip=None, epochs=3, snapshot=3, literal=True)
    np.testing.assert_allclose(out["history"]["loss"], job["losses"], rtol=1e-5)
    for k, v in job["params"].items():
        if not (k.startswith("gcns.") and k.endswith(".bias")):
            assert _rel(out["params"][k], v) < 1e-4, k
    adam = out["opt_state"]["adam"]["state"]
    assert all(torch.isfinite(v["exp_avg"]).all() for v in adam.values())
    # the closing evaluation (running statistics) reads the GENConv biases,
    # so it is held to the reference's evaluation of the program's own state
    params, bufs = _split(out["params"])
    want = ref.forward(params, bufs, torch.from_numpy(feat[:n]),
                       ref.structure(adj.senders, adj.receivers, n), num_layers=5, t=0.1,
                       eps=1e-7, training=False, literal=True)
    assert _rel(out["ypred"][0], want.detach()) < 5e-5


def test_cli_train_method_deepergcn_end_to_end(tmp_path):
    """``cli.train --method deepergcn`` on syn1 trains, checkpoints the model
    and its meta at ``--num-gc-layers`` and ``--hidden-dim``;
    ``cli.explain`` on it raises before it loads anything."""
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
           "HOME": str(tmp_path)}
    args = ["--dataset", "syn1", "--method", "deepergcn", "--platform", "cpu",
            "--num-gc-layers", "4", "--hidden-dim", "12",
            "--ckptdir", str(tmp_path / "ck"), "--logdir", str(tmp_path / "lg")]
    out = subprocess.run([sys.executable, "-m", "tpugraph_torch.cli.train", *args,
                          "--epochs", "10"], capture_output=True, text=True, env=env,
                         cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout[out.stdout.index("{\n"):])
    assert summary["method"] == "deepergcn" and summary["result_test"]["acc"] > 0
    prefix = tmp_path / "ck" / "syn1_deepergcn_h12_o20"
    meta = json.loads((prefix / "meta.json").read_text())
    assert meta["model_type"] == "deepergcn" and meta["num_gc_layers"] == 4
    params = torch.load(prefix / "params.pt")
    assert params["gcns.3.weight"].shape == (12, 12)
    assert "gcns.4.weight" not in params and params["norms.3.weight"].shape == (12,)
    bad = subprocess.run([sys.executable, "-m", "tpugraph_torch.cli.explain", *args],
                         capture_output=True, text=True, env=env, cwd=tmp_path, timeout=600)
    assert bad.returncode != 0 and "NotImplementedError" in bad.stderr
    assert "deepergcn checkpoint" in bad.stderr


@pytest.mark.parametrize("flags", [["--bcsr"], ["--halo", "2"], ["--bmname", "X"]])
def test_cli_deepergcn_raises_off_its_path(flags):
    from tpugraph_torch.cli.config import check_ported, parse_train_args

    with pytest.raises(NotImplementedError, match="--method deepergcn"):
        check_ported(parse_train_args(["--method", "deepergcn", *flags]))


def test_self_looped_adjacency_raises_with_bcsr():
    g, _ = _graph()
    with pytest.raises(ValueError, match="use_bcsr"):
        loop.build_adjacency(g, TrainConfig(use_bcsr=True), torch.device("cpu"),
                             self_loops=True)


def test_benchmark_copy_of_the_reference_is_this_reference(small):
    """``gnnbench/reference/deepergcn.py`` is this file, and computes the same."""
    import importlib.util

    path = REPO / "gnnbench" / "reference" / "deepergcn.py"
    assert path.read_text() == (REPO / "reference" / "deepergcn.py").read_text()
    spec = importlib.util.spec_from_file_location("bench_deepergcn_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    adj, n, rng = small
    state = _model(2).state_dict()
    x = _x(rng, n, 10)
    outs = []
    for m in (ref, mod):
        params, bufs = _split(state)
        outs.append(m.forward(params, bufs, x, m.structure(adj.senders, adj.receivers, n),
                              num_layers=5, t=0.1, eps=1e-7, training=True))
    assert torch.equal(outs[0], outs[1])


def test_reference_imports_no_jax_and_no_port():
    import ast

    for path in (REPO / "reference" / "deepergcn.py",
                 REPO / "gnnbench" / "reference" / "deepergcn.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) and node.module
                     else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "tpugraph",
                                                  "tpugraph_torch"), (path, name)
