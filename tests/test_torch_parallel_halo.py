"""The port's edge-sharded and halo message passing across 4 gloo ranks
against tpugraph on a 4-device virtual CPU mesh, from the same numpy
inputs and the same flax weights (``params_from_jax``).  Mirrors
``tests/test_parallel.py:22, 40, 57, 105, 127, 144, 231, 453, 493, 579,
696``; the halo training steps are in ``test_torch_parallel_halo_train.py``.

One group of 4 ranks is spawned for the whole file: its rank 0 returns
every case's result (``launch.call_each``), and each test checks its
cases against tpugraph at the tolerance the JAX test states, or tighter:
forwards 1e-4, gradients 2e-3 absolute plus 1e-3 relative, and the 2-D
hierarchical exchange equal to the flat one, rank for rank."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tpugraph.core.graph import graph_from_dense as jax_graph_from_dense
from tpugraph.core.graph import graph_from_edges as jax_graph_from_edges
from tpugraph.nn import GcnEncoderNode as JaxGcnEncoderNode
from tpugraph.nn.layers import GraphConv as JaxGraphConv
from tpugraph.nn.layers import SparseAdj as JaxSparseAdj
from tpugraph.ops.message import spmm as jax_spmm
from tpugraph.parallel import spmd as jax_spmd
from tpugraph.parallel.mesh import make_mesh as jax_make_mesh
from tpugraph_torch.core.graph import graph_from_dense, graph_from_edges
from tpugraph_torch.nn import GcnEncoderNode, params_from_jax
from tpugraph_torch.nn.layers import GraphConv
from tpugraph_torch.parallel import spmd
from tpugraph_torch.parallel.launch import call_each, run_ranks
from tpugraph_torch.train.optim import OptimizerConfig

torch.set_num_threads(1)

N_DEV = 4
ADAM = OptimizerConfig(opt="adam", lr=1e-2, weight_decay=0.0)
FWD_TOL = 1e-4
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


def _jax_layer_fn(layer, kind, plan_j, mesh):
    """tpugraph's shard_map of one layer on a plan kind (its tests' way)."""
    from tpugraph.nn.layers import HaloBCSRAdj, HaloOverlapAdj

    if kind == "coo":
        arrs = (plan_j.send_idx, plan_j.sender_slot, plan_j.receivers_local,
                plan_j.weights)
        build = lambda a: jax_spmd._halo_adj_from_slices(*a, "data")
    elif kind == "split":
        arrs = (plan_j.send_idx, plan_j.s_loc, plan_j.r_loc, plan_j.w_loc,
                plan_j.h_slot, plan_j.r_halo, plan_j.w_halo)
        build = lambda a: HaloOverlapAdj(*(x[0] for x in a), "data")
    elif kind == "bcsr":
        arrs = (plan_j.send_idx, plan_j.m, plan_j.m_t, plan_j.tp)
        build = lambda a: HaloBCSRAdj(a[0][0], jax_spmd._bcsr_slice0(a[1]),
                                      jax_spmd._bcsr_slice0(a[2]),
                                      jax_spmd._tp_slice0(a[3]), "data")
    else:
        arrs = jax_spmd._overlap_plan_arrs(plan_j)
        build = lambda a: jax_spmd._overlap_adj_from_arrs(a, "data")

    def local(p, a, xl):
        return layer.apply(p, xl, build(a))[0]

    f = shard_map(local, mesh=mesh, in_specs=(P(), P("data"), P("data")),
                  out_specs=P("data"), check_vma=False)
    return lambda p, x: f(p, arrs, x)


@pytest.fixture(scope="module")
def runs():
    """Every case: the inputs, tpugraph's results, and the port's (one
    4-rank gloo group)."""
    mesh = jax_make_mesh(N_DEV)
    rng = np.random.default_rng(0)
    wants, calls, extra = {}, [], {}

    def add(name, want, fn, *args):
        wants[name] = want
        calls.append((fn, args, {}))

    # edge shards (test_parallel.py:22) and the padding of the edge list (:40)
    a64 = _sym(1, 64, 0.15)
    g, gj = graph_from_dense(a64, num_edges_padded=1020), jax_graph_from_dense(
        a64, num_edges_padded=1020)
    x = rng.standard_normal((g.num_nodes_padded, 6)).astype(np.float32)
    gs = jax_spmd.shard_graph_edges(gj, mesh)
    add("edge", np.asarray(jax_spmd.sharded_spmm(mesh)(
        gs.senders, gs.receivers, gs.edge_weight, jnp.asarray(x))),
        spmd.apply_sharded_spmm, None, g, x)
    # receiver shards (:105), the halo (:127), a ring (:144)
    a96 = _sym(2, 96, 0.1)
    g96, gj96 = graph_from_dense(a96), jax_graph_from_dense(a96)
    gp, ns = spmd.partition_edges_by_receiver(g96, N_DEV)
    gp_j, _ = jax_spmd.partition_edges_by_receiver(gj96, N_DEV)
    x96 = rng.standard_normal((ns * N_DEV, 6)).astype(np.float32)
    add("node_part", np.asarray(jax_spmd.sharded_spmm_node_partitioned(mesh)(
        gp_j.senders, gp_j.receivers, gp_j.edge_weight, jnp.asarray(x96))),
        spmd.apply_node_partitioned_spmm, None, gp, x96)
    extra["node_part_ref"] = np.asarray(jax_spmm(
        gj96.senders, gj96.receivers, gj96.edge_weight, jnp.asarray(x96)))
    plan96 = spmd.build_halo_plan(g96, N_DEV)
    add("halo", np.asarray(jax_spmd.apply_halo_spmm(
        mesh, jax_spmd.build_halo_plan(gj96, N_DEV), jnp.asarray(x96))),
        spmd.apply_halo_spmm, None, plan96, x96)
    add("halo_2d", None, spmd.apply_halo_spmm, None, plan96, x96, ("dcn", "data"))
    src = np.arange(256, dtype=np.int32)
    ring_s = np.concatenate([src, (src + 1) % 256])
    ring_r = np.concatenate([(src + 1) % 256, src])
    ring, ring_j = (graph_from_edges(ring_s, ring_r, 256),
                    jax_graph_from_edges(ring_s, ring_r, 256))
    ring_plan = spmd.build_halo_plan(ring, N_DEV)
    xr = rng.standard_normal((256, 4)).astype(np.float32)
    add("ring", np.asarray(jax_spmm(ring_j.senders, ring_j.receivers,
                                    ring_j.edge_weight, jnp.asarray(xr))),
        spmd.apply_halo_spmm, None, ring_plan, xr)
    extra["ring_halo"] = ring_plan.halo_size

    # GAT layers on every plan kind, forward and gradients (:231, 453, 493, 696)
    g64, gj64 = graph_from_dense(_sym(3, 64, 0.1)), jax_graph_from_dense(_sym(3, 64, 0.1))
    x64 = rng.standard_normal((64, 6)).astype(np.float32)
    layer_j = JaxGraphConv(input_dim=6, output_dim=5, att=True)
    sp_j = JaxSparseAdj(gj64.senders, gj64.receivers, gj64.edge_weight)
    lp = layer_j.init(jax.random.PRNGKey(0), jnp.asarray(x64), sp_j)
    layer = GraphConv(6, 5, att=True)
    layer.load_state_dict(params_from_jax(lp))
    y_sp = np.asarray(layer_j.apply(lp, jnp.asarray(x64), sp_j)[0])
    g_sp = jax.grad(lambda p: jnp.sum(layer_j.apply(p, jnp.asarray(x64), sp_j)[0] ** 2))(lp)
    for kind, (pl, pl_j) in _plans(g64, gj64, att=True).items():
        f = _jax_layer_fn(layer_j, kind, pl_j, mesh)
        add(f"gat_{kind}", {
            "y": np.asarray(f(lp, jnp.asarray(x64))), "y_sparse": y_sp,
            "grads_sparse": {k: np.asarray(v) for k, v in g_sp["params"].items()}},
            spmd.halo_apply, None, layer, pl, x64, True)

    # edge-sharded training (:57)
    gsm, gjm = graph_from_dense(_sym(4, 48, 0.12)), jax_graph_from_dense(_sym(4, 48, 0.12))
    xs = rng.standard_normal((48, 6)).astype(np.float32)
    ys = rng.integers(0, 3, 48).astype(np.int64)
    ms = np.ones(48, np.float32)
    spm = JaxSparseAdj(gjm.senders, gjm.receivers, gjm.edge_weight)
    model_j2 = JaxGcnEncoderNode(input_dim=6, hidden_dim=8, embedding_dim=8,
                                 label_dim=3, num_layers=3, att=True)
    ps = model_j2.init(jax.random.PRNGKey(1), jnp.asarray(xs), spm)
    tx = optax.adam(1e-2)
    gsh = jax_spmd.shard_graph_edges(gjm, mesh)
    step = jax_spmd.make_sharded_node_train_step(model_j2, tx, mesh)
    pj, oj, losses = ps, tx.init(ps), []
    for _ in range(10):
        pj, oj, loss = step(pj, oj, gsh, jnp.asarray(xs),
                            jnp.asarray(ys.astype(np.int32)), jnp.asarray(ms))
        losses.append(float(loss))
    model_s = GcnEncoderNode(6, 8, 8, 3, 3, att=True, device="cpu")
    model_s.load_state_dict(params_from_jax(ps))
    add("sharded_fit", losses, spmd.sharded_node_fit, None, model_s, gsm, xs, ys, ms,
        10, ADAM)

    got = run_ranks(call_each, N_DEV, "gloo", calls, timeout_s=300)
    return {name: (want, res) for (name, want), res in zip(wants.items(), got)}, extra


def _run(runs, name):
    return runs[0][name]


def test_edge_sharded_spmm(runs):
    want, got = _run(runs, "edge")
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)


def test_node_partitioned_spmm(runs):
    want, got = _run(runs, "node_part")
    ref = runs[1]["node_part_ref"]
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(got[:96], ref[:96], rtol=0, atol=FWD_TOL)


def test_halo_exchange_spmm_flat_and_hierarchical(runs):
    want, got = _run(runs, "halo")
    _, got_2d = _run(runs, "halo_2d")
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)
    np.testing.assert_array_equal(got_2d, got)  # rank for rank


def test_halo_exchange_locality(runs):
    want, got = _run(runs, "ring")
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)
    assert runs[1]["ring_halo"] <= 8


@pytest.mark.parametrize("kind", KINDS)
def test_halo_gat_forward_and_grads(runs, kind):
    """GAT on each plan kind: the forward equals tpugraph's same kind and
    its sparse layer (1e-4), and the gradients of sum(y^2) the sparse
    layer's (2e-3 + 1e-3 relative), as tpugraph's tests hold its own."""
    want, got = _run(runs, f"gat_{kind}")
    np.testing.assert_allclose(got["y"], want["y"], rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(got["y"], want["y_sparse"], rtol=0, atol=FWD_TOL)
    for k in ("att_weight", "weight", "bias"):
        np.testing.assert_allclose(got["grads"][k], want["grads_sparse"][k],
                                   atol=2e-3, rtol=1e-3)
        assert float(np.abs(got["grads"][k]).max()) > 0


def test_edge_sharded_training(runs):
    """10 Adam steps of an attention encoder on edge shards: tpugraph's
    trajectory (its sharded jit is the single-device gradient; the first
    loss at 1e-5, the rest at the 2e-3 of its halo trainer's test) and a
    falling loss (all that tpugraph's own test asks)."""
    want, got = _run(runs, "sharded_fit")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=2e-3)
    assert got[-1] < got[0]
