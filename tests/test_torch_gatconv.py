"""The port's multi-head GAT (``nn.GATConv``, ``nn.GatEncoderNode``, the
attention's plain versions in ``ops/coo_kernels.py``, ``train.loop``'s GAT
adjacency and ``cli.train --method gat``) held on the CPU to the plain
reference ``reference/gat.py`` on seeded numpy inputs.  The JAX package has
no such model, so nothing here runs ``tpugraph``; the kernels themselves
run on the card only (``tests/test_torch_cuda.py``).

Tolerances: the port and the reference compute the same float32 sums in
other orders (the port chunks each row's edges along the CSR work list and
runs an online softmax; the reference sums by ``index_add`` and torch's
sparse products), so results are compared relative to the largest entry at
a few float32 ulps of accumulated rounding: 2e-5 for a forward of one
layer, 5e-5 for three layers and their gradients, 1e-4 for three Adam
steps (Adam's first steps move each entry by about lr whatever its
gradient's size, so a tiny gradient's rounding shows in full)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from reference import gat as ref
from tpugraph_torch.core.graph import graph_from_edges
from tpugraph_torch.nn import GATConv, GatEncoderNode, SparseAdj
from tpugraph_torch.ops import coo_kernels as ck
from tpugraph_torch.ops import csr as row_csr
from tpugraph_torch.train import TrainConfig, train_node_classifier
from tpugraph_torch.train import loop

REPO = Path(__file__).resolve().parents[1]
STATS = ("running_mean", "running_var", "num_batches_tracked")


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _graph(seed=0, n=300, e=2000, hub=True):
    """A 300-node random graph with both edge directions; node 7 sends and
    receives 400 more edges, so with chunks of 64 its rows are split."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    if hub:
        s[:400] = 7
    return graph_from_edges(np.concatenate([s, r]), np.concatenate([r, s]), n), rng


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(row_csr, "CHUNK_EDGES", 64)
    g, rng = _graph()
    adj, n = loop.self_loop_adjacency(g, torch.device("cpu"))
    return g, adj, n, rng


def _rel(a, b):
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _split(state):
    params = {k: v.detach().clone().requires_grad_(True) for k, v in state.items()
              if not k.endswith(STATS)}
    bufs = {k: v.detach().clone() for k, v in state.items() if k.endswith(STATS)}
    return params, bufs


def test_gat_adjacency_drops_padding_and_self_loops_and_adds_one_a_node():
    s = np.array([0, 1, 2, 2, 3], np.int32)
    r = np.array([1, 0, 2, 3, 2], np.int32)  # 2 -> 2 is a self-loop
    g = graph_from_edges(s, r, 4, pad_multiple=16)
    assert g.senders.shape[0] == 16 and g.num_nodes_padded == 16
    adj, n = loop.self_loop_adjacency(g, torch.device("cpu"))
    assert n == 4
    assert adj.senders.tolist() == [0, 1, 2, 3, 0, 1, 2, 3]
    assert adj.receivers.tolist() == [1, 0, 3, 2, 0, 1, 2, 3]
    assert torch.equal(adj.weight, torch.ones(8))
    assert adj.csr is not None and adj.csr.a.num_nodes == 4


def test_gat_adjacency_raises_with_bcsr():
    g, _ = _graph()
    with pytest.raises(ValueError, match="use_bcsr"):
        loop.build_adjacency(g, TrainConfig(use_bcsr=True), torch.device("cpu"),
                             self_loops=True)


@pytest.mark.parametrize("heads", [1, 3])
def test_gatconv_forward_and_gradients_match_reference(small, heads):
    _, adj, n, rng = small
    conv = GATConv(12, 5, heads, generator=torch.Generator().manual_seed(heads))
    x = torch.from_numpy(rng.standard_normal((n, 12)).astype(np.float32))
    g_out = torch.from_numpy(rng.standard_normal((n, heads * 5)).astype(np.float32))
    y = conv(x, adj)
    (y * g_out).sum().backward()
    st = ref.structure(adj.senders, adj.receivers, n)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in conv.named_parameters()}
    z = x @ p["weight"]
    zh = z.view(n, heads, 5)
    y_ref = ref.attention(z, (zh * p["attn_l"]).sum(-1), (zh * p["attn_r"]).sum(-1), st,
                          heads, 0.2) + x @ p["res_weight"]
    grads = torch.autograd.grad((y_ref * g_out).sum(), list(p.values()))
    assert _rel(y.detach(), y_ref.detach()) < 2e-5
    for (name, param), want in zip(conv.named_parameters(), grads):
        assert _rel(param.grad, want) < 2e-5, name


def _scores(n, heads, rng, scale):
    return (torch.from_numpy((rng.standard_normal((n, heads)) * scale).astype(np.float32)),
            torch.from_numpy((rng.standard_normal((n, heads)) * scale).astype(np.float32)))


@pytest.mark.parametrize("scale", [1.0, 80.0], ids=["unit", "logits_80"])
def test_attention_plain_versions_walk_split_rows_like_the_reference(small, scale):
    """The forward, backward and row-sum twins over work lists with split
    rows (node 7's 400+ edges in chunks of 64) against the reference's
    attention and its autograd, with scores up to +-80 (exp would overflow
    without the maxima)."""
    _, adj, n, rng = small
    heads, f = 3, 4
    csr = adj.csr
    assert csr.a.splits.shape[0] >= 1 and csr.a_t.splits.shape[0] >= 1
    z = torch.from_numpy(rng.standard_normal((n, heads * f)).astype(np.float32))
    el, er = _scores(n, heads, rng, scale)
    g = torch.from_numpy(rng.standard_normal((n, heads * f)).astype(np.float32))
    y, lse = ck.gat_attention_plain(csr.a, z, el, er, heads, 0.2)
    assert torch.isfinite(y).all() and torch.isfinite(lse).all()
    st = ref.structure(adj.senders, adj.receivers, n)
    zr, elr, err = (t.clone().requires_grad_(True) for t in (z, el, er))
    y_ref = ref.attention(zr, elr, err, st, heads, 0.2)
    dz_ref, del_ref, der_ref = torch.autograd.grad((y_ref * g).sum(), (zr, elr, err))
    assert _rel(y, y_ref.detach()) < 2e-5
    t = (g * y).view(n, heads, f).sum(-1)
    dz, d_el, de = ck.gat_attention_backward_plain(csr.a_t, z, g, el, er, lse, t, heads, 0.2)
    der = ck.gat_dst_sum_plain(csr.a, de)
    assert _rel(dz, dz_ref) < 2e-5
    assert _rel(d_el, del_ref) < 5e-5 and _rel(der, der_ref) < 5e-5
    # the autograd wrapper takes the same plain versions on the CPU
    za, ela, era = (v.clone().requires_grad_(True) for v in (z, el, er))
    ya = ck.gat_attention(csr, za, ela, era, heads, 0.2)
    assert torch.equal(ya.detach(), y)
    (ya * g).sum().backward()
    assert torch.equal(za.grad, dz) and torch.equal(ela.grad, d_el)
    assert torch.equal(era.grad, der)


def test_split_rows_agree_with_unsplit_rows(monkeypatch):
    """The chunked merge (maxima, sums and partials added in chunk order)
    gives the unchunked rows' numbers within rounding."""
    g, rng = _graph(3)
    out = []
    for chunk in (16, 100000):
        monkeypatch.setattr(row_csr, "CHUNK_EDGES", chunk)
        adj, n = loop.self_loop_adjacency(g, torch.device("cpu"))
        if not out:
            z = torch.from_numpy(rng.standard_normal((n, 6)).astype(np.float32))
            el, er = _scores(n, 2, rng, 3.0)
        out.append(ck.gat_attention_plain(adj.csr.a, z, el, er, 2, 0.2))
    assert _rel(out[0][0], out[1][0]) < 1e-6 and _rel(out[0][1], out[1][1]) < 1e-6


def test_self_loop_only_node_keeps_its_own_row(small):
    """A node whose only in-edge is its self-loop attends to itself alone:
    alpha = 1, so y is its own z row exactly, and lse its own score."""
    g = graph_from_edges(np.array([0, 1], np.int32), np.array([1, 0], np.int32), 3)
    adj, n = loop.self_loop_adjacency(g, torch.device("cpu"))
    z = torch.arange(12, dtype=torch.float32).view(3, 4)
    el = torch.tensor([[0.5, -1.0], [2.0, 0.1], [-3.0, 4.0]])
    er = torch.tensor([[1.0, 1.0], [-2.0, 0.3], [1.0, -7.0]])
    y, lse = ck.gat_attention_plain(adj.csr.a, z, el, er, 2, 0.2)
    assert torch.equal(y[2], z[2])
    sc = el[2] + er[2]
    assert torch.equal(lse[2], torch.where(sc > 0, sc, sc * 0.2))


def test_leaky_relu_negative_branch(small):
    """Every score negative: the softmax runs on slope * score, and its
    backward scales the scores' gradients by the slope, as float64 math
    over the same edges says."""
    _, adj, n, rng = small
    heads, f = 2, 3
    z = torch.from_numpy(rng.standard_normal((n, heads * f)).astype(np.float32))
    el = -torch.rand(n, heads) - 0.1
    er = -torch.rand(n, heads) - 0.1
    y, _ = ck.gat_attention_plain(adj.csr.a, z, el, er, heads, 0.2)
    s, r = adj.senders, adj.receivers
    e = (el[s] + er[r]).double() * 0.2
    w = torch.exp(e - e.max())
    den = torch.zeros(n, heads, dtype=torch.float64).index_add(0, r, w)
    alpha = w / den[r]
    want = torch.zeros(n, heads * f, dtype=torch.float64).index_add(
        0, r, alpha.repeat_interleave(f, 1) * z.double()[s])
    assert _rel(y, want) < 2e-6
    g = torch.ones(n, heads * f)
    ela = el.clone().requires_grad_(True)
    ya = ck.gat_attention(adj.csr, z, ela, er, heads, 0.2)
    (ya * g).sum().backward()
    elr = el.double().clone().requires_grad_(True)
    e2 = (elr[s] + er.double()[r]) * 0.2
    a2 = torch.exp(e2 - torch.full((n, heads), -torch.inf, dtype=torch.float64).scatter_reduce(
        0, r[:, None].expand(-1, heads), e2.detach(), "amax", include_self=True)[r])
    a2 = a2 / torch.zeros(n, heads, dtype=torch.float64).index_add(0, r, a2)[r]
    y2 = torch.zeros(n, heads * f, dtype=torch.float64).index_add(
        0, r, a2.repeat_interleave(f, 1) * z.double()[s])
    (want_grad,) = torch.autograd.grad((y2 * g.double()).sum(), elr)
    assert _rel(ela.grad, want_grad) < 5e-5


def _model(seed=0, **kw):
    return GatEncoderNode(10, 6, 4, num_layers=3, num_heads=3,
                          generator=torch.Generator().manual_seed(seed), device="cpu", **kw)


def test_encoder_logits_and_gradients_match_reference(small):
    _, adj, n, rng = small
    model = _model()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    x = torch.from_numpy(rng.standard_normal((n, 10)).astype(np.float32))
    logits, att = model(x, adj)
    assert att == [] and logits.shape == (n, 4)
    w = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32))
    (logits * w).sum().backward()
    params, bufs = _split(state)
    st = ref.structure(adj.senders, adj.receivers, n)
    want = ref.forward(params, bufs, x, st, num_layers=3, num_heads=3, slope=0.2,
                       training=True)
    assert _rel(logits.detach(), want.detach()) < 5e-5
    grads = torch.autograd.grad((want * w).sum(), list(params.values()))
    named = dict(model.named_parameters())
    assert set(named) == set(params)
    for k, gr in zip(params, grads):
        assert _rel(named[k].grad, gr) < 5e-5, k
    for k, v in bufs.items():
        assert _rel(model.state_dict()[k], v) < 1e-6, k
    model.eval()
    with torch.no_grad():
        ev = model(x, adj)[0]
    assert _rel(ev, ref.forward(params, bufs, x, st, num_layers=3, num_heads=3,
                                slope=0.2, training=False).detach()) < 5e-5


def test_three_training_steps_match_the_reference_job():
    """``train_node_classifier`` on a GAT model for 3 epochs (its adjacency
    from a padded graph) against the reference's job: each loss, Adam's
    moments, the parameters and the closing evaluation's logits."""
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
    assert adj.senders.shape[0] == int((g.edge_weight != 0).sum()) - int(
        ((g.senders == g.receivers) & (g.edge_weight != 0)).sum()) + n
    train_idx, _ = ref.split_nodes(n, cfg.train_ratio, 4)
    assert np.array_equal(np.sort(out["train_idx"]), np.sort(train_idx))
    job = ref.train_job(state, torch.from_numpy(feat[:n]),
                        ref.structure(adj.senders, adj.receivers, n),
                        torch.from_numpy(labels), torch.from_numpy(train_idx),
                        num_layers=3, num_heads=3, slope=0.2, lr=0.01, weight_decay=0.0,
                        clip=None, epochs=3, snapshot=3)
    np.testing.assert_allclose(out["history"]["loss"], job["losses"], rtol=1e-5)
    for k, v in job["params"].items():
        assert _rel(out["params"][k], v) < 1e-4, k
    adam = out["opt_state"]["adam"]["state"]
    names = [k for k, _ in model.named_parameters()]
    first = {k: adam[i]["exp_avg"] for i, k in enumerate(names)}
    assert all(torch.isfinite(v).all() for v in first.values())
    assert _rel(out["ypred"][0], job["logits"]) < 1e-4


def test_cli_train_method_gat_end_to_end(tmp_path):
    """``cli.train --method gat`` on syn1 trains, checkpoints a GAT model and
    its meta; ``cli.explain`` on it raises before it loads anything."""
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
           "HOME": str(tmp_path)}
    args = ["--dataset", "syn1", "--method", "gat", "--platform", "cpu", "--num-heads", "2",
            "--ckptdir", str(tmp_path / "ck"), "--logdir", str(tmp_path / "lg")]
    out = subprocess.run([sys.executable, "-m", "tpugraph_torch.cli.train", *args,
                          "--epochs", "20"], capture_output=True, text=True, env=env,
                         cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout[out.stdout.index("{\n"):])
    assert summary["method"] == "gat" and summary["result_test"]["acc"] > 0
    meta = json.loads((tmp_path / "ck" / "syn1_gat_h20_o20" / "meta.json").read_text())
    assert meta["model_type"] == "gat" and meta["num_heads"] == 2
    params = torch.load(tmp_path / "ck" / "syn1_gat_h20_o20" / "params.pt")
    assert params["convs.0.attn_l"].shape == (2, 20)
    assert params["convs.2.weight"].shape == (40, 8)
    bad = subprocess.run([sys.executable, "-m", "tpugraph_torch.cli.explain", *args],
                         capture_output=True, text=True, env=env, cwd=tmp_path, timeout=600)
    assert bad.returncode != 0 and "NotImplementedError" in bad.stderr


@pytest.mark.parametrize("flags", [["--bcsr"], ["--halo", "2"], ["--bmname", "X"]])
def test_cli_gat_raises_off_its_path(flags):
    from tpugraph_torch.cli.config import check_ported, parse_train_args

    with pytest.raises(NotImplementedError, match="--method gat"):
        check_ported(parse_train_args(["--method", "gat", *flags]))


def test_benchmark_copy_of_the_reference_is_this_reference(small):
    """``gnnbench/reference/gat.py`` is this file, and computes the same."""
    import importlib.util

    path = REPO / "gnnbench" / "reference" / "gat.py"
    assert path.read_text() == (REPO / "reference" / "gat.py").read_text()
    spec = importlib.util.spec_from_file_location("bench_gat_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _, adj, n, rng = small
    state = _model(2).state_dict()
    x = torch.from_numpy(rng.standard_normal((n, 10)).astype(np.float32))
    outs = []
    for m in (ref, mod):
        params, bufs = _split(state)
        outs.append(m.forward(params, bufs, x, m.structure(adj.senders, adj.receivers, n),
                              num_layers=3, num_heads=3, slope=0.2, training=True))
    assert torch.equal(outs[0], outs[1])


def test_reference_imports_no_jax_and_no_port():
    import ast

    for path in (REPO / "reference" / "gat.py", REPO / "gnnbench" / "reference" / "gat.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) and node.module
                     else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "tpugraph",
                                                  "tpugraph_torch"), (path, name)
