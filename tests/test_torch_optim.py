"""The port's optimizer chain, learning rate schedules, optimizer state and
``--resume``, and its flax checkpoint reader, against ``tpugraph``'s
(optax and flax) on the CPU, from the same numpy inputs."""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from tpugraph.core.graph import graph_from_networkx as jax_graph_from_networkx
from tpugraph.data.gengraph import gen_syn1 as jax_gen_syn1
from tpugraph.nn import GcnEncoderNode as JaxGcnEncoderNode
from tpugraph.nn.layers import SparseAdj as JaxSparseAdj
from tpugraph.train import checkpoint as jax_checkpoint
from tpugraph.train import loop as jax_loop
from tpugraph.train import optim as jax_optim
from tpugraph_torch.core.graph import graph_from_edge_list
from tpugraph_torch.data import gen_syn1
from tpugraph_torch.nn import GcnEncoderNode, SparseAdj, params_from_jax
from tpugraph_torch.train import TrainConfig, load_checkpoint, train_node_classifier
from tpugraph_torch.train import optim
from tpugraph_torch.train.checkpoint import read_flax_msgpack
from tpugraph_torch.train.optim import OptimizerConfig, build_optimizer

torch.set_num_threads(1)

SHAPES = {"w1": (10, 20), "b1": (20,), "w2": (20, 4)}
# torch.optim.Adam keeps its bias corrections 1 - b^k in float64 where
# optax rounds them to float32 (1.3e-5 apart in nu_hat at the first step),
# so its updates part from optax's by up to 6.4e-6 of themselves and Adam
# is held at ten times the other optimizers' tolerance.  The tests print
# each gap (_gap) beside its limit: Adam's one clipped step 7.0e-6 and
# 8.1e-6 against 1e-5, its 300-update chains 0.8e-6 to 1.4e-6, its
# 20-epoch trajectory 8.6e-7 in the losses and 1.2e-5 in the logits
# against 1e-4 (the other optimizers 1.3e-6 at most against 1e-5)
ADAM_FACTOR = 10
STEPS = 300
# decays at updates 100 and 200; the cosine reaches 0 at update 200
SCHED = dict(decay_step=100, decay_rate=0.5, restart=200)


def _stream(seed, steps=STEPS):
    """Parameters and a gradient stream whose global norms spread over
    0.2-20, so a clip of 2.0 acts on some updates and not on others."""
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    scales = 10.0 ** rng.uniform(-2, 0, steps)
    grads = [{k: (sc * rng.standard_normal(s)).astype(np.float32)
              for k, s in SHAPES.items()} for sc in scales]
    return params, grads


def _run_port(params, grads, cfg, state=None):
    ps = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in SHAPES]
    opt = build_optimizer(ps, cfg)
    if state is not None:
        opt.load_state_dict(state)
    for g in grads:
        for p, k in zip(ps, SHAPES):
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    return {k: p.detach().numpy() for p, k in zip(ps, SHAPES)}, opt


def _gap(got, ref, scale=None):
    """The largest ``|got - ref| / (|ref| + scale)`` over the arrays (scale
    ``max |ref|`` of each unless given): the least ``rtol = atol / scale``
    that ``assert_allclose`` would pass."""
    out = 0.0
    for a, b in zip(got, ref):
        b = np.asarray(b, np.float64)
        s = np.abs(b).max() if scale is None else scale
        out = max(out, float(np.max(np.abs(a - b) / (np.abs(b) + s))))
    return out


def _run_optax(params, grads, tx):
    step = jax.jit(lambda p, s, g: (lambda u, s2: (optax.apply_updates(p, u), s2))(
        *tx.update(g, s, p)))
    p = {k: jnp.asarray(v) for k, v in params.items()}
    s = tx.init(p)
    for g in grads:
        p, s = step(p, s, {k: jnp.asarray(v) for k, v in g.items()})
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("norm", [2e-6, 5e-7])
def test_clipped_step_matches_optax_at_a_tiny_norm(norm):
    """optax's clip leaves a gradient under the clip alone and scales one
    over it by exactly clip / norm (torch's clip_grad_norm_ scales by
    clip / (norm + 1e-6) whenever that is under 1: 1/3 instead of 1/2 at
    norm 2e-6, 2/3 instead of 1 at 5e-7); then one Adam step, whose update
    at gradients near its eps shows the scale (held to 1e-5 of itself,
    Adam's float64 bias corrections)."""
    clip = 1e-6
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    g = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    total = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in g.values()))
    g = {k: (v * (norm / total)).astype(np.float32) for k, v in g.items()}

    ref = _run_optax(params, [g], optax.chain(optax.clip_by_global_norm(clip),
                                              optax.adam(0.1)))
    got, _ = _run_port(params, [g], OptimizerConfig(opt="adam", lr=0.1, clip=clip))
    gap = _gap([got[k] - params[k] for k in SHAPES],
               [ref[k] - params[k] for k in SHAPES], scale=0.0)
    print(f"adam gap {gap:.3g} (limit {1e-6 * ADAM_FACTOR})")
    assert gap <= 1e-6 * ADAM_FACTOR

    clipped_j, _ = optax.clip_by_global_norm(clip).update(
        {k: jnp.asarray(v) for k, v in g.items()}, optax.EmptyState())
    clipped = [torch.from_numpy(g[k].copy()) for k in SHAPES]
    optim.clip_by_global_norm_(clipped, clip)
    for k, c in zip(SHAPES, clipped):
        np.testing.assert_allclose(c.numpy(), np.asarray(clipped_j[k]),
                                   rtol=1e-6, atol=0, err_msg=k)


@pytest.mark.parametrize("sched", ["none", "step", "cos"])
@pytest.mark.parametrize("opt", ["adam", "sgd", "rmsprop", "adagrad"])
def test_optimizer_matches_optax(opt, sched):
    """300 updates of tpugraph's chain (clip 2.0, weight decay 0.005, the
    core optimizer) on one gradient stream: the step schedule crosses two
    decays and the cosine runs 100 updates past its restart."""
    kw = dict(opt=opt, lr=0.01, scheduler=sched, weight_decay=0.005, clip=2.0,
              **SCHED)
    params, grads = _stream(1)
    ref = _run_optax(params, grads,
                     jax_optim.build_optimizer(jax_optim.OptimizerConfig(**kw)))
    got, opt_t = _run_port(params, grads, OptimizerConfig(**kw))
    assert opt_t.count == STEPS
    tol = 1e-6 * (ADAM_FACTOR if opt == "adam" else 1)
    gap = _gap([got[k] for k in SHAPES], [ref[k] for k in SHAPES])
    print(f"{opt} {sched} gap {gap:.3g} (limit {tol})")
    assert gap <= tol
    for k in SHAPES:
        assert not np.allclose(got[k], params[k])


@pytest.mark.parametrize("sched", ["step", "cos"])
def test_schedules_match_optax(sched):
    """The rate at each update count 0..699 against the optax schedule
    tpugraph builds, past a cosine restart and across several decays."""
    ref = (optax.exponential_decay(0.01, transition_steps=100, decay_rate=0.5,
                                   staircase=True) if sched == "step"
           else optax.cosine_decay_schedule(0.01, decay_steps=200))
    lr_at = optim.build_schedule(OptimizerConfig(lr=0.01, scheduler=sched, **SCHED))
    ks = np.arange(700)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(ks)))
    got = np.array([lr_at(int(k)) for k in ks], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12, err_msg=sched)
    assert optim.build_schedule(OptimizerConfig(lr=0.01, scheduler="cos", restart=10))(10) == 0.0
    with pytest.raises(ValueError, match="scheduler"):
        optim.build_schedule(OptimizerConfig(scheduler="poly"))


@pytest.mark.parametrize("opt", ["adam", "sgd", "rmsprop", "adagrad"])
def test_state_dict_resumes_the_same_updates(opt):
    """150 updates, the optimizer state saved and loaded into a new
    optimizer, then 150 more equal 300 straight: the count carries the
    step schedule across its decay at update 150."""
    cfg = OptimizerConfig(opt=opt, lr=0.01, scheduler="step", decay_step=150,
                          decay_rate=0.5, weight_decay=0.005, clip=2.0)
    params, grads = _stream(2)
    straight, _ = _run_port(params, grads, cfg)
    half, opt_t = _run_port(params, grads[:150], cfg)
    buf = io.BytesIO()
    torch.save(opt_t.state_dict(), buf)
    buf.seek(0)
    state = torch.load(buf, weights_only=True)
    assert state["count"] == 150
    resumed, opt_r = _run_port(half, grads[150:], cfg, state=state)
    assert opt_r.count == 300
    for k in SHAPES:
        np.testing.assert_array_equal(resumed[k], straight[k], err_msg=k)
    with pytest.raises(ValueError, match="cannot resume"):
        other = "sgd" if opt != "sgd" else "adam"
        _run_port(params, [], OptimizerConfig(opt=other), state=state)


DIMS = dict(input_dim=10, hidden_dim=20, embedding_dim=20, label_dim=4,
            num_layers=3)


@pytest.fixture(scope="module")
def syn1():
    """syn1 (seed 0) in both packages, random features, JAX params."""
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
    return dict(g_j=g_j, g_t=g_t, feat=feat, labels=np.asarray(labels),
                model_j=model_j, params=params)


TRAIN_CASES = [("sgd", "none"), ("rmsprop", "none"), ("adagrad", "step"),
               ("adam", "cos")]


@pytest.mark.parametrize("opt,sched", TRAIN_CASES)
def test_training_trajectory_matches_tpugraph(syn1, opt, sched):
    """20 COO epochs of train_node_classifier from the same parameters with
    each optimizer (one update an epoch; a step decay every 5, a cosine
    restart at 10): losses and final predictions at 1e-5 (Adam at 1e-4)."""
    kw = dict(num_epochs=20, lr=0.01, opt=opt, opt_scheduler=sched,
              opt_decay_step=5, opt_decay_rate=0.5, opt_restart=10)
    out_j = jax_loop.train_node_classifier(
        syn1["model_j"], syn1["g_j"], syn1["feat"], syn1["labels"],
        jax_loop.TrainConfig(**kw), init_params=syn1["params"])
    out = train_node_classifier(
        GcnEncoderNode(**DIMS, device="cpu"), syn1["g_t"], syn1["feat"],
        syn1["labels"], TrainConfig(**kw),
        init_params=params_from_jax(syn1["params"]), device="cpu")
    tol = 1e-5 * (ADAM_FACTOR if opt == "adam" else 1)
    loss_gap = _gap([np.asarray(out["history"]["loss"])],
                    [out_j["history"]["loss"]], scale=0.0)
    pred_gap = _gap([out["ypred"]], [out_j["ypred"]])
    print(f"{opt} {sched} loss gap {loss_gap:.3g}, ypred gap {pred_gap:.3g} "
          f"(limit {tol})")
    assert loss_gap <= tol and pred_gap <= tol
    assert out["history"]["loss"][-1] != out["history"]["loss"][0]
    assert out["opt_state"]["count"] == 20


def test_resumed_training_equals_a_straight_run(syn1):
    """12 epochs, then 8 resumed from the returned parameters and
    optimizer state, equal 20 straight, with the step decay at the resume
    point (update 12); a resume that loses the count does not."""
    kw = dict(lr=0.01, opt="sgd", opt_scheduler="step", opt_decay_step=12,
              opt_decay_rate=0.1)

    def run(epochs, params, opt_state=None):
        return train_node_classifier(
            GcnEncoderNode(**DIMS, device="cpu"), syn1["g_t"], syn1["feat"],
            syn1["labels"], TrainConfig(num_epochs=epochs, **kw),
            init_params=params, init_opt_state=opt_state, device="cpu")

    init = params_from_jax(syn1["params"])
    straight = run(20, init)
    first = run(12, init)
    resumed = run(8, first["params"], first["opt_state"])
    np.testing.assert_allclose(resumed["history"]["loss"],
                               straight["history"]["loss"][12:], rtol=1e-6, atol=0)
    np.testing.assert_allclose(resumed["ypred"], straight["ypred"], rtol=1e-6,
                               atol=1e-6)
    fresh = run(8, first["params"])
    assert not np.allclose(fresh["history"]["loss"][1:],
                           straight["history"]["loss"][13:], rtol=1e-6, atol=0)


def test_tpugraph_checkpoint_reads_byte_for_byte(syn1, tmp_path):
    """A checkpoint written by tpugraph's save_checkpoint: read_flax_msgpack
    returns flax's arrays byte for byte, and load_checkpoint maps them onto
    the port's model, whose logits equal JAX's."""
    cg = {"adj": np.zeros((1, 3, 3), np.float32), "label": np.zeros((1, 3)),
          "train_idx": np.arange(3)}
    path = jax_checkpoint.save_checkpoint(str(tmp_path), "syn1_base_h20_o20",
                                          syn1["params"], cg_dict=cg,
                                          meta={"model_type": "base"})
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        blob = f.read()
    ref = serialization.msgpack_restore(blob)
    got = read_flax_msgpack(blob)

    def same(a, b, where):
        if isinstance(b, dict):
            assert isinstance(a, dict) and set(a) == set(b), where
            for k in b:
                same(a[k], b[k], f"{where}/{k}")
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, where
            assert a.tobytes() == b.tobytes(), where

    same(got, ref, "")
    ck = load_checkpoint(str(tmp_path), "syn1_base_h20_o20")
    assert ck["opt_state"] is None and ck["meta"]["model_type"] == "base"
    np.testing.assert_array_equal(ck["train_idx"], np.arange(3))
    model = GcnEncoderNode(**DIMS, device="cpu")
    model.load_state_dict(ck["params"])
    g, g_j = syn1["g_t"], syn1["g_j"]
    logits_j, _ = syn1["model_j"].apply(
        syn1["params"], jnp.asarray(syn1["feat"]),
        JaxSparseAdj(g_j.senders, g_j.receivers, g_j.edge_weight))
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(syn1["feat"]),
                          SparseAdj(g.senders, g.receivers, g.edge_weight))
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), rtol=1e-5,
                               atol=1e-5)


def test_read_flax_msgpack_covers_the_format():
    """The subset a parameter tree is written in (maps, str, int, float,
    empty and multi-dimensional arrays of several dtypes) reads as flax
    reads it; anything else raises: nil, bool, flax's numpy-scalar
    extension and its chunked leaves."""
    tree = {"a": {"k": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
                  "i": np.array([-1, 2**40], np.int64), "e": np.zeros((0, 3)),
                  "h": np.ones((3,), np.float16)},
            "small": 7, "neg": -33, "u16": 300, "i64": -2**40, "f": 0.25,
            "txt": "x" * 40, "m": {str(i): i for i in range(20)}}
    got = read_flax_msgpack(serialization.msgpack_serialize(tree))
    ref = serialization.msgpack_restore(serialization.msgpack_serialize(tree))
    for k in ("small", "neg", "u16", "i64", "f", "txt", "m"):
        assert got[k] == ref[k] and type(got[k]) is type(ref[k]), k
    for k in ("k", "i", "e", "h"):
        assert got["a"][k].dtype == ref["a"][k].dtype
        np.testing.assert_array_equal(got["a"][k], ref["a"][k])
    chunked = serialization._chunk(np.arange(10, dtype=np.float32).reshape(2, 5))
    for bad in ({"yes": True}, {"nothing": None}, {"s": np.float32(2.5)},
                {"w": chunked}):
        with pytest.raises(ValueError, match="unsupported"):
            read_flax_msgpack(serialization.msgpack_serialize(bad))
    with pytest.raises(ValueError, match="trailing"):
        read_flax_msgpack(serialization.msgpack_serialize(tree) + b"\x00")
