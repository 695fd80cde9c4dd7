"""Host-side pieces of the port's multi-device paths against tpugraph's,
with no process group spawned: the halo plans in every form
(``HaloPlan``, the split ``HaloOverlapPlan``, ``HaloBCSRPlan`` and
``HaloBCSROverlapPlan`` with and without attention) byte for byte against
tpugraph's stacked arrays, slice by slice, at 2, 4 and 8 shards on both
engine paths; the partitioners, ``partition_edges_by_receiver`` and
``pad_graph``; the edge shards' padding; ``make_mesh``'s errors,
``init_distributed`` without torchrun and the overlap policy; the
launcher's faults (a rank that raises, dies or hangs fails the call
within its timeout; NCCL with fewer cards than ranks raises before any
spawn); and the halo trainer's own checks at one rank."""

import operator
import os
import time

import numpy as np
import pytest
import torch

from tpugraph import native as jax_native
from tpugraph.core.graph import graph_from_dense as jax_graph_from_dense
from tpugraph.core.graph import pad_graph as jax_pad_graph
from tpugraph.parallel import spmd as jax_spmd
from tpugraph.parallel.mesh import make_mesh as jax_make_mesh
from tpugraph_torch import native
from tpugraph_torch.core.graph import graph_from_dense, pad_graph
from tpugraph_torch.nn import GcnEncoderNode
from tpugraph_torch.parallel import spmd
from tpugraph_torch.parallel.launch import call_each, run_ranks, single_rank
from tpugraph_torch.parallel.mesh import Mesh, init_distributed, make_mesh
from tpugraph_torch.train import TrainConfig
from tpugraph_torch.train import loop

torch.set_num_threads(1)


def same(a, b):
    """Byte equality (tolerance 0) of a port array and a tpugraph one."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


def graphs(seed=0, n=96, p=0.08):
    a = (np.random.default_rng(seed).random((n, n)) < p).astype(np.float32)
    a = np.triu(a, 1)
    a = a + a.T
    return graph_from_dense(a), jax_graph_from_dense(a)


@pytest.fixture(params=["native", "numpy"])
def engine(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(jax_native, "_get_lib", lambda: None)
        monkeypatch.setattr(native, "_get_lib", lambda: None)
    return request.param


def _same_bcsr_slice(got, want, d):
    for f in ("tiles", "col_blk", "row_ptr", "row_of"):
        same(getattr(got, f), np.asarray(getattr(want, f))[d])
    assert (got.num_nodes, got.block) == (want.num_nodes, want.block)


def _same_tp_slice(got, want, d):
    for f in ("col_blk", "row_ptr", "row_of", "perm", "keep"):
        same(getattr(got, f), np.asarray(getattr(want, f))[d])


@pytest.mark.parametrize("att", [False, True], ids=["plain", "att"])
@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_halo_plans_byte_identical(engine, n_dev, att):
    """Every plan form, shard by shard: the port's list entry ``d`` equals
    tpugraph's stacked slice ``d`` (tiles, col_blk, row_ptr, row_of; the
    transpose plans' perm and keep), dead tiles included."""
    g, gj = graphs()
    plan, plan_j = spmd.build_halo_plan(g, n_dev), jax_spmd.build_halo_plan(gj, n_dev)
    for f in ("send_idx", "sender_slot", "receivers_local", "weights"):
        same(getattr(plan, f), getattr(plan_j, f))
    sp, sp_j = spmd.split_halo_plan(plan, n_dev), jax_spmd.split_halo_plan(plan_j, n_dev)
    for f in ("send_idx", "s_loc", "r_loc", "w_loc", "h_slot", "r_halo", "w_halo"):
        same(getattr(sp, f), getattr(sp_j, f))
    bp = spmd.build_halo_bcsr(plan, n_dev, block=8, att=att)
    bp_j = jax_spmd.build_halo_bcsr(plan_j, n_dev, block=8, att=att)
    op = spmd.build_halo_bcsr_overlap(plan, n_dev, block=8, att=att)
    op_j = jax_spmd.build_halo_bcsr_overlap(plan_j, n_dev, block=8, att=att)
    for d in range(n_dev):
        _same_bcsr_slice(bp.m[d], bp_j.m, d)
        _same_bcsr_slice(bp.m_t[d], bp_j.m_t, d)
        for f in ("m_loc", "m_loc_t", "m_halo", "m_halo_t"):
            _same_bcsr_slice(getattr(op, f)[d], getattr(op_j, f), d)
        if att:
            _same_tp_slice(bp.tp[d], bp_j.tp, d)
            _same_tp_slice(op.tp_loc[d], op_j.tp_loc, d)
            _same_tp_slice(op.tp_halo[d], op_j.tp_halo, d)
    assert (bp.tp is None) == (bp_j.tp is None) == (not att)
    counts = {m.num_tiles for m in bp.m}
    assert len(counts) == 1  # every shard padded to the largest's count


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_partitioners_and_receiver_shards_match(n_dev):
    g, gj = graphs(1)
    r = g.receivers.numpy()
    w = g.edge_weight.numpy()
    for got, want in zip(spmd.balance_partition(r, 96, n_dev, weights=w),
                         jax_spmd.balance_partition(r, 96, n_dev, weights=w)):
        same(got, want)
    (gp, ns), (gp_j, ns_j) = (spmd.partition_edges_by_receiver(g, n_dev),
                              jax_spmd.partition_edges_by_receiver(gj, n_dev))
    assert ns == ns_j
    for f in ("senders", "receivers", "edge_weight", "node_mask", "edge_pair"):
        same(getattr(gp, f), getattr(gp_j, f))


def test_pad_graph_matches():
    g, gj = graphs(2, n=20, p=0.2)
    got, want = pad_graph(g, 32, 200), jax_pad_graph(gj, 32, 200)
    for f in ("senders", "receivers", "edge_weight", "node_mask", "edge_pair"):
        same(getattr(got, f), getattr(want, f))
    assert (got.n_node, got.n_edge) == (want.n_node, want.n_edge)
    with pytest.raises(ValueError, match="cannot shrink"):
        pad_graph(g, 32, 8)


class _RankMesh(Mesh):
    """A mesh seen from one rank, without a process group (host-side
    tests of the per-rank slicing)."""

    def __init__(self, size, rank):
        super().__init__(("data",), (size,))
        self._rank = rank

    @property
    def rank(self):
        return self._rank


def test_shard_graph_pads_edges_to_mesh_multiple():
    """``tests/test_parallel.py:40``: 4 directed edges over an 8-rank mesh
    pad to 8; each rank takes one, and the ranks' slices in order are
    tpugraph's padded edge arrays."""
    a = np.zeros((16, 16), np.float32)
    a[0, 1] = a[1, 0] = a[2, 3] = a[3, 2] = 1
    g, gj = graph_from_dense(a, num_edges_padded=4), jax_graph_from_dense(a)
    gsj = jax_spmd.shard_graph_edges(gj, jax_make_mesh(8))
    shards = [spmd.shard_graph_edges(g, _RankMesh(8, r)) for r in range(8)]
    assert {s.num_edges_padded for s in shards} == {1}
    for f in ("senders", "receivers", "edge_weight", "edge_pair"):
        same(torch.cat([getattr(s, f) for s in shards]), getattr(gsj, f))
    same(shards[5].node_mask, gj.node_mask)


def test_init_distributed_without_torchrun(monkeypatch):
    """With no torchrun environment and no arguments there is no group to
    join: False, and nothing initialized (``tpugraph``'s single-process
    answer)."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False
    assert not torch.distributed.is_initialized()


def test_make_mesh_validation():
    """tpugraph's ValueError texts (``tests/test_parallel.py:600``), with no
    group active (one device)."""
    with pytest.raises(ValueError, match="explicit shape"):
        make_mesh(axis_names=("dcn", "data"))
    with pytest.raises(ValueError, match="needs"):
        make_mesh(axis_names=("a", "b"), shape=(4, 4))
    with pytest.raises(ValueError, match="vs axis_names"):
        make_mesh(axis_names=("a", "b"), shape=(1,))
    with pytest.raises(RuntimeError, match="initialized process group"):
        make_mesh()


def test_overlap_policy_and_plan_types():
    """resolve_halo_overlap: on/off force, a bad value raises, auto is off
    for gloo ranks and for one rank (tpugraph: off on the CPU proxy); and
    build_halo's plan type follows the policy."""
    g, _ = graphs()
    four = Mesh(("data",), (4,))
    assert spmd.resolve_halo_overlap("on", four) is True
    assert spmd.resolve_halo_overlap("off", four) is False
    with pytest.raises(ValueError, match="overlap must be"):
        spmd.resolve_halo_overlap("sometimes", four)
    with single_rank("gloo"):
        assert spmd.resolve_halo_overlap("auto", make_mesh()) is False
    kinds = {(True, "on"): spmd.HaloBCSROverlapPlan, (True, "off"): spmd.HaloBCSRPlan,
             (False, "on"): spmd.HaloOverlapPlan, (False, "off"): spmd.HaloPlan}
    for (bcsr, ov), kind in kinds.items():
        assert type(spmd.build_halo(g, four, bcsr=bcsr, block=8, overlap=ov)) is kind
    with pytest.raises(TypeError, match="not a halo plan"):
        spmd.make_halo_train_step(None, None, four, object())


def test_launcher_faults_fail_fast():
    """A rank that raises, a rank that exits without a result and ranks that
    outlive the timeout each make run_ranks raise, within seconds."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        run_ranks(call_each, 2, "gloo", [(operator.truediv, (1, 0), {})])
    with pytest.raises(RuntimeError, match="exited with code 3"):
        run_ranks(call_each, 2, "gloo", [(os._exit, (3,), {})])
    with pytest.raises(RuntimeError, match="did not finish within 3 s"):
        run_ranks(call_each, 2, "gloo", [(time.sleep, (60,), {})], timeout_s=3)
    assert time.monotonic() - t0 < 90


def test_nccl_needs_a_card_a_rank():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=f"{have + 1} ranks on NCCL need "
                       f"{have + 1} CUDA devices.*has {have}"):
        run_ranks(call_each, have + 1, "nccl", [])


def test_halo_trainer_checks_at_one_rank(monkeypatch):
    """At one gloo rank: dropout raises (tpugraph's NotImplementedError), a
    mesh of another size raises, and a plan that does not cover the
    locality partition's nodes exactly fails the new shard-size check."""
    g, _ = graphs(3, n=40, p=0.15)
    feat = np.ones((g.num_nodes_padded, 3), np.float32)
    labels = np.zeros(40, np.int64)
    cfg = TrainConfig(num_epochs=1)
    make = lambda **kw: GcnEncoderNode(3, 4, 4, 2, 2, device="cpu", **kw)
    with single_rank("gloo"):
        with pytest.raises(NotImplementedError, match="dropout"):
            loop.train_node_classifier_halo(make(dropout=0.1), g, feat, labels, cfg, 1)
        with pytest.raises(ValueError, match="n_dev=2"):
            loop.train_node_classifier_halo(make(), g, feat, labels, cfg, 2)
        real = spmd.build_halo
        monkeypatch.setattr(spmd, "build_halo", lambda *a, **k: real(
            *a, **k)._replace(shard_size=real(*a, **k).shard_size + 8))
        with pytest.raises(AssertionError, match="locality partition"):
            loop.train_node_classifier_halo(make(), g, feat, labels, cfg, 1)
