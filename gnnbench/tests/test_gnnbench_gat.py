"""The GAT cell (``gat-arxiv-train``) at a size the CPU holds: a tiny copy of
its configuration and workload file (limits included) added to a copied
benchmark as new files, run whole on the CPU (the chip check skipped) and
correct; the TF32 control, a reference frozen after step 3 or half-way,
a timed job cut short and planted program faults not correct; the
per-layer counts and readers; and the benchmark's copy of the reference
the same as the repository's."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from gnnbench import compare, gat_counts, gat_readers
from gnnbench import run as bench
from gnnbench.drivers import train_gat
from gnnbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]
CELL = "t-gat-train"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    dest = tmp_path_factory.mktemp("gatcheckout")
    shutil.copytree(REPO / "gnnbench", dest / "gnnbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "gnnbench/configs/gat-arxiv.json").read_text())
    cfg["graph"].update(num_nodes=300, num_edges=1500, feat_dim=16, num_classes=5)
    cfg["model"].update(input_dim=16, head_dim=8, label_dim=5)
    cfg["train"]["epochs"] = 10
    (dest / "gnnbench/configs/t-gat.json").write_text(json.dumps(cfg))
    man["configs"].append({"name": "t-gat", "source": "https://arxiv.org/abs/1710.10903",
                           "file": "gnnbench/configs/t-gat.json", "reduced": [],
                           "why": "a CPU test's size"})
    wl = json.loads((REPO / "gnnbench/workloads/gat-arxiv-train.json").read_text())
    wl["config"] = "t-gat"
    (dest / "gnnbench/workloads" / f"{CELL}.json").write_text(json.dumps(wl))
    man["workloads"].append({"name": CELL, "config": "t-gat", "traffic": CELL, "chips": 1,
                             "why": "a CPU test's size"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "gat-arxiv-train" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (dest / "BENCHMARK.json").write_text(json.dumps(man))
    return dest


@pytest.mark.parametrize("trace", [0, 1])
def test_gat_cell_is_correct_on_the_cpu(root, trace):
    res = tiny.run_cell(root, CELL, trace=trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    man = json.loads((root / "BENCHMARK.json").read_text())
    if trace == 0:
        assert set(res["metrics"]) == {"train_epochs_per_s.coo", "setup_s"}
    else:
        # no device trace on the CPU: only the host-clock reader answers
        assert set(res["metrics"]) == {"step_mfu.gat"}
        assert {m["name"] for m in man["per_layer"] if CELL in m.get("workloads", ())} == {
            "step_mfu.gat", "attention_ms_per_epoch.gat", "attention_roofline.gat",
            "attention_backward_roofline.gat", "dense_ms_per_epoch.gat"}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_gat_planted_fault_is_not_correct(root, monkeypatch, fault):
    import tpugraph_torch.train.loop as loop
    from tpugraph_torch.train.optim import ClippedOptimizer

    if fault == "state_unchanged":
        monkeypatch.setattr(ClippedOptimizer, "step", lambda self: None)
    else:
        ce = loop.node_cross_entropy

        def altered(logits, y, class_weight=None, node_mask=None):
            if fault == "answer_altered":
                return ce(logits, y, class_weight=class_weight, node_mask=node_mask) * 1.01
            keep = torch.nonzero(node_mask).flatten()
            mask = torch.zeros_like(node_mask)
            mask[keep[: len(keep) // 2]] = 1.0
            return ce(logits, y, class_weight=class_weight, node_mask=mask)

        monkeypatch.setattr(loop, "node_cross_entropy", altered)
    assert not tiny.run_cell(root, CELL)["correct"]


@pytest.mark.parametrize("planted", [dict(precision="tf32"), dict(freeze_after=3),
                                     dict(freeze_after="half"), dict(cut_short=True)],
                         ids=["tf32_control", "reference_frozen_after_step_3",
                              "reference_frozen_half_way", "program_job_cut_short"])
def test_gat_control_and_reference_faults_fail(root, planted):
    torch.set_num_threads(2)
    man = bench.load_manifest(root)
    _, wl, cfg = bench.load_cell(man, CELL, root)
    run = bench.Run(2**31 + 5, wl, cfg, torch.device("cpu"))
    st = train_gat.setup(run)
    f32 = train_gat.reference_outputs(st, run)
    if planted.get("cut_short"):
        # a timed job that stops half-way: only job_loss_gap sees it
        short = dict(f32, jobs=[dict(j, losses=j["losses"][: len(j["losses"]) // 2])
                                for j in f32["jobs"]])
        readings = compare.train_readings(short, f32)
        assert readings["job_loss_gap"] == float("inf")
    else:
        if planted.get("freeze_after") == "half":
            planted = dict(freeze_after=cfg["train"]["epochs"] // 2)
        readings = compare.train_readings(
            train_gat.reference_outputs(st, run, **planted), f32)
    ok, _ = compare.judge(readings, wl["limits"])
    assert not ok


def test_gat_counts_at_the_configuration():
    """The layers of ``gat-arxiv`` and its forward's operations: 507 GFLOP
    of GEMMs, the scores and the weighted sums over 2,501,829 edges."""
    cfg = json.loads((REPO / "gnnbench/configs/gat-arxiv.json").read_text())
    dims = gat_counts.layers(cfg)
    assert dims == [(128, 3, 250), (750, 3, 250), (750, 3, 40)]
    n, e = 169343, 2501829
    gemm = sum(4 * n * a * h * f for a, h, f in dims)
    assert abs(gemm / 1e9 - 507.0) < 1.0
    assert gat_counts.forward_flops(n, e, dims) == gemm + sum(
        4 * n * h * f + 2 * e * h * f for _, h, f in dims)
    assert gat_counts.epoch_flops(n, e, dims) > 2 * gat_counts.forward_flops(n, e, dims)
    # D = 750: bytes bound both passes
    for backward in (False, True):
        b = gat_counts.attention_bytes(n, e, 3, 250, backward)
        assert b / 3.35e12 > gat_counts.attention_flops(e, 3, 250, backward) / 67e12


def test_gat_readers_over_spans():
    """The span readers on a made-up attribution: two epochs, each with an
    attention forward, its backward, a GEMM and Adam; and the roofline
    share from the counts."""
    from gnnbench.trace import Trace

    ops = []
    for ep in range(2):
        t = 10.0 * ep
        ops += [(("k_att", t, t + 1.0), ("train_epoch", "train.forward", "nn.attention")),
                (("gemm", t + 1.0, t + 3.0), ("train_epoch", "train.forward")),
                (("k_bwd", t + 3.0, t + 5.0), ("train_epoch", "train.backward",
                                                "nn.attention.backward")),
                (("adam", t + 5.0, t + 5.5), ("train_epoch", "train.optimizer"))]
    ops.append((("k_att", 20.0, 20.5), ("train.eval", "nn.attention")))
    ctx = {"trace": Trace(30.0, 13.0, [], [], []), "traced_epochs": 2, "span_paths": ops,
           "gat_layers": [(4, 2, 3)], "num_nodes": 10, "attended_edges": 30,
           "jobs": [{"epochs": 2, "wall_s": 1.0}]}
    assert gat_readers.attention_ms_per_epoch(ctx) == pytest.approx(3000.0)
    assert gat_readers.dense_ms_per_epoch(ctx) == pytest.approx(2000.0)
    least = gat_counts.attention_least_seconds(10, 30, [(4, 2, 3)], 3, False)
    assert gat_readers.attention_roofline(ctx) == pytest.approx(100 * least / 2.5)
    least_b = gat_counts.attention_least_seconds(10, 30, [(4, 2, 3)], 2, True)
    assert gat_readers.attention_backward_roofline(ctx) == pytest.approx(100 * least_b / 4.0)
    flops = 2 * gat_counts.epoch_flops(10, 30, [(4, 2, 3)]) + gat_counts.forward_flops(
        10, 30, [(4, 2, 3)])
    assert gat_readers.step_mfu(ctx) == pytest.approx(100 * flops / 67e12)
    assert gat_readers.attention_ms_per_epoch({"trace": None}) is None


def test_benchmark_reference_is_the_repository_reference():
    assert (REPO / "gnnbench/reference/gat.py").read_text() == \
        (REPO / "reference/gat.py").read_text()
