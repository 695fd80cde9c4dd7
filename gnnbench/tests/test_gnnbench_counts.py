"""The operation and byte counts behind ``step_mfu.*`` and
``aggregate_roofline.*``, against hand-worked tiny shapes, and each
metric file's reader."""

import importlib.util
from pathlib import Path

import pytest

from gnnbench import peaks, readers
from gnnbench.trace import Trace

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def _load(name):
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"),
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_epoch_flops_by_hand():
    # N=2, nnz=3, one layer 4->5 then 5->6, head (5+6)=11 -> 7 classes
    n, nnz = 2, 3
    fwd = (2 * 3 * 4 + 2 * 2 * 4 * 5) + (2 * 3 * 5 + 2 * 2 * 5 * 6) + 2 * 2 * 11 * 7
    assert readers.forward_flops(n, nnz, [4, 5], [5, 6], 11, 7) == fwd
    bwd = (2 * 2 * 4 * 5 + 2 * 2 * 5 * 6)            # weight gradients
    bwd += 2 * 2 * 5 * 6 + 2 * 3 * 5                 # layer 2's input gradient
    bwd += 4 * 2 * 11 * 7                            # head
    assert readers.epoch_flops(n, nnz, [4, 5], [5, 6], 11, 7) == fwd + bwd


@pytest.mark.parametrize("name", ["step_mfu.bcsr", "step_mfu.coo"])
def test_step_mfu_reads_jobs(name):
    mfu = _load(name)
    ctx = {"jobs": [{"epochs": 10, "wall_s": 2.0}],
           "model": {"layer_inputs": [4, 5], "layer_outputs": [5, 6],
                     "head_input": 11, "classes": 7},
           "num_nodes": 2, "nnz": 3}
    flops = 10 * readers.epoch_flops(2, 3, [4, 5], [5, 6], 11, 7) + readers.forward_flops(
        2, 3, [4, 5], [5, 6], 11, 7)
    assert mfu.read(ctx) == pytest.approx(100 * flops / 2.0 / peaks.F32_FLOPS)
    assert mfu.read({"jobs": []}) is None


def test_aggregate_counts_by_hand():
    # layers read widths 4, 5, 6: two epochs and one evaluation
    assert readers.product_widths([4, 5, 6], 2) == [4, 5, 6, 5, 6] * 2 + [4, 5, 6]
    n, nnz, d = 1000, 10_000, 8
    nbytes = 12 * nnz + 2 * 4 * n * d
    assert readers.least_seconds(n, nnz, [d]) == pytest.approx(
        max(nbytes / peaks.HBM_BYTES, 2 * nnz * d / peaks.F32_FLOPS))
    # a wide product turns compute-bound
    assert readers.least_seconds(1, 10**9, [4096]) == pytest.approx(
        2 * 10**9 * 4096 / peaks.F32_FLOPS)


@pytest.mark.parametrize("name", ["aggregate_roofline.bcsr", "aggregate_roofline.coo"])
def test_aggregate_reads_matched_kernels_only(name):
    agg = _load(name)
    tr = Trace(1.0, 0.5, [("void elementwise_kernel", 0.0, 0.5)], [], [])
    assert agg.read({"trace": tr}) is None
    assert agg.read({}) is None
    tr = Trace(1.0, 0.5, [("indexFuncLargeIndex<float>", 0.0, 0.25),
                          ("void elementwise_kernel", 0.25, 0.5)], [], [])
    ctx = {"trace": tr, "traced_epochs": 2, "num_nodes": 10, "nnz": 40,
           "model": {"layer_inputs": [4, 5]}}
    want = readers.least_seconds(10, 40, readers.product_widths([4, 5], 2)) / 0.25
    assert agg.read(ctx) == pytest.approx(100 * want)


@pytest.mark.parametrize("fam", ["bcsr", "coo"])
def test_idle_share_and_pack_s(fam):
    idle, pack = _load(f"device_idle_share.{fam}"), _load(f"pack_s.{fam}")
    assert idle.read({"trace": Trace(4.0, 1.0, [], [], [])}) == pytest.approx(75.0)
    assert idle.read({}) is None
    assert pack.read({"jobs": [{"pack_s": 3.0}, {"pack_s": 1.0}, {"pack_s": 2.0}]}) == 2.0
    assert pack.read({"jobs": []}) is None
