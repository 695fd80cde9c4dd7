"""The port's halo training steps across 4 gloo ranks against tpugraph's
on a 4-device virtual CPU mesh, from the same numpy inputs and the same
flax weights: 5 Adam steps of a 3-layer encoder on every plan type
(``make_halo_train_step`` dispatching on ``HaloPlan``,
``HaloOverlapPlan``, ``HaloBCSRPlan``, ``HaloBCSROverlapPlan``), one step
on the 2-D ``("dcn", "data")`` mesh with the hierarchical exchange, and
the unified entry point (``build_halo``) on an attention model over both
overlap routes.  Mirrors ``tests/test_parallel.py:166, 270, 337, 390,
759, 824, 935``.  Tolerances: trajectories 2e-4 relative plus 2e-5
(tpugraph's), logits after training 5e-4, first losses 1e-5.  One group
of 4 ranks runs every case."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tpugraph.core.graph import graph_from_dense as jax_graph_from_dense
from tpugraph.nn import GcnEncoderNode as JaxGcnEncoderNode
from tpugraph.nn.layers import SparseAdj as JaxSparseAdj
from tpugraph.nn.losses import node_cross_entropy as jax_node_ce
from tpugraph.parallel import spmd as jax_spmd
from tpugraph.parallel.mesh import make_mesh as jax_make_mesh
from tpugraph_torch.core.graph import graph_from_dense
from tpugraph_torch.nn import GcnEncoderNode, params_from_jax
from tpugraph_torch.parallel import spmd
from tpugraph_torch.parallel.launch import call_each, run_ranks
from tpugraph_torch.train.optim import OptimizerConfig

torch.set_num_threads(1)

N_DEV = 4
ADAM = OptimizerConfig(opt="adam", lr=1e-2, weight_decay=0.0)
TRAJ = dict(rtol=2e-4, atol=2e-5)
KINDS = ("coo", "split", "bcsr", "bcsr_overlap")


def _sym(seed, n, p):
    a = (np.random.default_rng(seed).random((n, n)) < p).astype(np.float32)
    a = np.triu(a, 1)
    return a + a.T


def _plans(g, gj, att=False):
    """Each plan kind in both packages, block 8."""
    plan, plan_j = spmd.build_halo_plan(g, N_DEV), jax_spmd.build_halo_plan(gj, N_DEV)
    return {
        "coo": (plan, plan_j),
        "split": (spmd.split_halo_plan(plan, N_DEV),
                  jax_spmd.split_halo_plan(plan_j, N_DEV)),
        "bcsr": (spmd.build_halo_bcsr(plan, N_DEV, block=8, att=att),
                 jax_spmd.build_halo_bcsr(plan_j, N_DEV, block=8, att=att)),
        "bcsr_overlap": (spmd.build_halo_bcsr_overlap(plan, N_DEV, block=8, att=att),
                         jax_spmd.build_halo_bcsr_overlap(plan_j, N_DEV, block=8,
                                                          att=att)),
    }


@pytest.fixture(scope="module")
def runs():
    mesh = jax_make_mesh(N_DEV)
    rng = np.random.default_rng(0)
    wants, calls, extra = {}, [], {}

    def add(name, want, fn, *args):
        wants[name] = want
        calls.append((fn, args, {}))

    a96 = _sym(2, 96, 0.1)
    g96, gj96 = graph_from_dense(a96), jax_graph_from_dense(a96)
    plan96 = spmd.build_halo_plan(g96, N_DEV)
    g64, gj64 = graph_from_dense(_sym(3, 64, 0.1)), jax_graph_from_dense(_sym(3, 64, 0.1))
    x64 = rng.standard_normal((64, 6)).astype(np.float32)

    # 5 Adam steps of a 3-layer encoder on every plan kind (:166, 270, 337, 390)
    n_total = plan96.shard_size * N_DEV
    xt = rng.standard_normal((n_total, 6)).astype(np.float32)
    yt = rng.integers(0, 3, n_total).astype(np.int64)
    mt = (np.arange(n_total) < 96).astype(np.float32)
    model_j = JaxGcnEncoderNode(input_dim=6, hidden_dim=8, embedding_dim=8,
                                label_dim=3, num_layers=3)
    sp96 = JaxSparseAdj(gj96.senders, gj96.receivers, gj96.edge_weight)
    params0 = model_j.init(jax.random.PRNGKey(0), jnp.asarray(xt), sp96)
    model = GcnEncoderNode(6, 8, 8, 3, 3, device="cpu")
    model.load_state_dict(params_from_jax(params0))
    tx = optax.adam(1e-2)

    @jax.jit
    def ref_step(p, o):
        loss, gr = jax.value_and_grad(lambda q: jax_node_ce(
            model_j.apply(q, jnp.asarray(xt), sp96)[0], jnp.asarray(yt.astype(np.int32)),
            node_mask=jnp.asarray(mt)))(p)
        u, o = tx.update(gr, o, p)
        return optax.apply_updates(p, u), o, loss

    p, o, ref_losses = params0, tx.init(params0), []
    for _ in range(5):
        p, o, loss = ref_step(p, o)
        ref_losses.append(float(loss))
    extra["single_losses"] = ref_losses
    extra["single_logits"] = np.asarray(model_j.apply(p, jnp.asarray(xt), sp96)[0])
    for kind, (pl, pl_j) in _plans(g96, gj96).items():
        step = jax_spmd.make_halo_train_step(model_j, tx, mesh, pl_j)
        pj, oj, losses = params0, tx.init(params0), []
        for _ in range(5):
            pj, oj, loss = step(pj, oj, pl_j, jnp.asarray(xt),
                                jnp.asarray(yt.astype(np.int32)), jnp.asarray(mt))
            losses.append(float(loss))
        add(f"fit_{kind}", losses, spmd.halo_fit, None, model, pl, xt, yt, mt, 5, ADAM)
    # the 2-D mesh and its hierarchical exchange (:824), COO and tiles
    add("fit_coo_2d", None, spmd.halo_fit, None, model, plan96, xt, yt, mt, 1, ADAM,
        None, ("dcn", "data"))
    add("fit_bcsr_2d", None, spmd.halo_fit, None, model,
        spmd.build_halo_bcsr(plan96, N_DEV, block=8), xt, yt, mt, 1, ADAM, None,
        ("dcn", "data"))

    # the unified entry point on an attention model, both overlap routes (:935)
    model_att_j = JaxGcnEncoderNode(input_dim=6, hidden_dim=8, embedding_dim=8,
                                    label_dim=3, num_layers=2, att=True)
    sp64 = JaxSparseAdj(gj64.senders, gj64.receivers, gj64.edge_weight)
    pa = model_att_j.init(jax.random.PRNGKey(0), jnp.asarray(x64), sp64)
    model_att = GcnEncoderNode(6, 8, 8, 3, 2, att=True, device="cpu")
    model_att.load_state_dict(params_from_jax(pa))
    y64 = rng.integers(0, 3, 64).astype(np.int64)
    m64 = np.ones(64, np.float32)
    fake = spmd.Mesh(("data",), (N_DEV,))
    for tag, kw in (("bcsr_plain", dict(bcsr=True, block=8, overlap="off")),
                    ("bcsr_overlap", dict(bcsr=True, block=8, overlap="on")),
                    ("coo_overlap", dict(bcsr=False, overlap="on"))):
        pl_j = jax_spmd.build_halo(gj64, mesh, att=True, **kw)
        step = jax_spmd.make_halo_train_step(model_att_j, tx, mesh, pl_j)
        _, _, loss = step(pa, tx.init(pa), pl_j, jnp.asarray(x64),
                          jnp.asarray(y64.astype(np.int32)), jnp.asarray(m64))
        add(f"unified_att_{tag}", float(loss), spmd.halo_fit, None, model_att,
            spmd.build_halo(g64, fake, att=True, **kw), x64, y64, m64, 1, ADAM)

    got = run_ranks(call_each, N_DEV, "gloo", calls, timeout_s=300)
    return {name: (want, res) for (name, want), res in zip(wants.items(), got)}, extra


def _run(runs, name):
    return runs[0][name]


@pytest.mark.parametrize("kind", KINDS)
def test_halo_training_matches(runs, kind):
    """5 Adam steps on each plan kind: the loss trajectory equals
    tpugraph's same kind and one device's (Adam hides the halo gradient's
    factor), and the logits after training one device's (5e-4)."""
    want, got = _run(runs, f"fit_{kind}")
    np.testing.assert_allclose(got["losses"], want, **TRAJ)
    np.testing.assert_allclose(got["losses"], runs[1]["single_losses"], **TRAJ)
    np.testing.assert_allclose(got["logits"][:96], runs[1]["single_logits"][:96],
                               rtol=0, atol=5e-4)


def test_halo_training_2d_mesh_hierarchical(runs):
    """One step on the 2-D (2, 2) mesh: the hierarchical exchange gives the
    1-D loss, on COO and on tiles."""
    _, flat = _run(runs, "fit_coo")
    for name in ("fit_coo_2d", "fit_bcsr_2d"):
        _, got = _run(runs, name)
        np.testing.assert_allclose(got["losses"][0], flat["losses"][0], rtol=1e-5)


@pytest.mark.parametrize("tag", ["bcsr_plain", "bcsr_overlap", "coo_overlap"])
def test_unified_entry_attention(runs, tag):
    """build_halo + make_halo_train_step on an attention model: each route's
    first loss equals tpugraph's same route (1e-5) and the plain route's."""
    want, got = _run(runs, f"unified_att_{tag}")
    np.testing.assert_allclose(got["losses"][0], want, rtol=1e-5)
    _, plain = _run(runs, "unified_att_bcsr_plain")
    np.testing.assert_allclose(got["losses"][0], plain["losses"][0], rtol=1e-4)
