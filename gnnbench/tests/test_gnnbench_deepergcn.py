"""The DeeperGCN cell (``deepergcn-arxiv-train``) at a size the CPU holds: a
tiny copy of its configuration and workload file (limits included) added to
a copied benchmark as new files, run whole on the CPU (the chip check
skipped) and correct; the TF32 control, a reference frozen after step 3 or
half-way and planted program faults not correct; the
per-layer counts and readers; the configuration against the published
model; and the benchmark's copy of the reference the same as the
repository's."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from gnnbench import compare, deepergcn_counts, deepergcn_readers
from gnnbench import run as bench
from gnnbench.drivers import train_deepergcn
from gnnbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]
CELL = "t-deepergcn-train"
CFG = json.loads((REPO / "gnnbench/configs/deepergcn-arxiv.json").read_text())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    dest = tmp_path_factory.mktemp("deepergcncheckout")
    shutil.copytree(REPO / "gnnbench", dest / "gnnbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads(json.dumps(CFG))
    cfg["graph"].update(num_nodes=300, num_edges=1500, feat_dim=16, num_classes=5)
    cfg["model"].update(input_dim=16, hidden_dim=12, label_dim=5, num_layers=4)
    cfg["train"]["epochs"] = 10
    (dest / "gnnbench/configs/t-deepergcn.json").write_text(json.dumps(cfg))
    man["configs"].append({"name": "t-deepergcn", "source": "https://arxiv.org/abs/2006.07739",
                           "file": "gnnbench/configs/t-deepergcn.json", "reduced": [],
                           "why": "a CPU test's size"})
    wl = json.loads((REPO / "gnnbench/workloads/deepergcn-arxiv-train.json").read_text())
    wl["config"] = "t-deepergcn"
    (dest / "gnnbench/workloads" / f"{CELL}.json").write_text(json.dumps(wl))
    man["workloads"].append({"name": CELL, "config": "t-deepergcn", "traffic": CELL,
                             "chips": 1, "why": "a CPU test's size"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "deepergcn-arxiv-train" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (dest / "BENCHMARK.json").write_text(json.dumps(man))
    return dest


@pytest.mark.parametrize("trace", [0, 1])
def test_deepergcn_cell_is_correct_on_the_cpu(root, trace):
    res = tiny.run_cell(root, CELL, trace=trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    man = json.loads((root / "BENCHMARK.json").read_text())
    if trace == 0:
        assert set(res["metrics"]) == {"train_epochs_per_s.coo", "setup_s"}
    else:
        # no device trace on the CPU: only the host-clock reader answers
        assert set(res["metrics"]) == {"step_mfu.deepergcn"}
        assert {m["name"] for m in man["per_layer"] if CELL in m.get("workloads", ())} == {
            "step_mfu.deepergcn", "softmax_aggr_ms_per_epoch.deepergcn",
            "softmax_aggr_roofline.deepergcn", "softmax_aggr_backward_roofline.deepergcn",
            "dense_ms_per_epoch.deepergcn"}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_deepergcn_planted_fault_is_not_correct(root, monkeypatch, fault):
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
                                     dict(freeze_after="half")],
                         ids=["tf32_control", "reference_frozen_after_step_3",
                              "reference_frozen_half_way"])
def test_deepergcn_control_and_reference_faults_fail(root, planted):
    """The control and the frozen states fail; a job that stops half-way
    ends where the half-way freeze does, which ``job_change_gap_median``
    fails (the cell compares no ``job_loss_gap``: the program's own jobs
    read up to 1.07 there, PERF.md)."""
    torch.set_num_threads(2)
    man = bench.load_manifest(root)
    _, wl, cfg = bench.load_cell(man, CELL, root)
    assert "job_loss_gap" not in wl["limits"]
    run = bench.Run(2**31 + 5, wl, cfg, torch.device("cpu"))
    st = train_deepergcn.setup(run)
    f32 = train_deepergcn.reference_outputs(st, run)
    if planted.get("freeze_after") == "half":
        planted = dict(freeze_after=cfg["train"]["epochs"] // 2)
    readings = compare.train_readings(
        train_deepergcn.reference_outputs(st, run, **planted), f32)
    ok, _ = compare.judge(readings, wl["limits"])
    assert not ok


def test_configuration_is_the_published_model():
    """The configuration's widths build the 491,176-parameter model of the
    OGB leaderboard entry, and the driver's initial weights are that
    model's ``state_dict``, shape for shape."""
    from tpugraph_torch.nn import DeeperGcnEncoderNode

    m, pub = CFG["model"], CFG["published"]
    assert (m["num_layers"], m["hidden_dim"], m["t"], m["eps"], m["label_dim"]) == (
        pub["num_layers"], pub["hidden_channels"], pub["t"], 1e-7, 40)
    assert CFG["reduced"] == ["dropout"] and m["dropout"] == 0.0 and pub["dropout"] == 0.5
    model = train_deepergcn.build_model(CFG, torch.device("cpu"))
    assert isinstance(model, DeeperGcnEncoderNode)
    assert sum(p.numel() for p in model.parameters()) == pub["parameters"] == 491_176
    init = train_deepergcn.init_params(CFG, 2**31 + 3, torch.device("cpu"))
    state = model.state_dict()
    assert set(init) == set(state)
    assert all(init[k].shape == state[k].shape for k in state)


def test_deepergcn_counts_at_the_configuration():
    """The forward's operations (the linears' 2 N H (D_in + 28 H + C) and
    28 aggregations of 4 E H) and each kernel's bytes bound at the arxiv
    shape: about 0.081 ms forward and 0.107 ms backward."""
    d = deepergcn_counts.dims(CFG)
    assert d == (128, 128, 40, 28)
    n, e = 169343, 2501829
    lin = 2 * n * 128 * (128 + 28 * 128 + 40)
    assert deepergcn_counts.forward_flops(n, e, d) == lin + 28 * 4 * e * 128
    assert deepergcn_counts.epoch_flops(n, e, d) > 2 * deepergcn_counts.forward_flops(n, e, d)
    for backward, ms in ((False, 0.081), (True, 0.107)):
        b = deepergcn_counts.aggregation_bytes(n, e, 128, backward)
        assert b / 3.35e12 > deepergcn_counts.aggregation_flops(e, 128, backward) / 67e12
        assert abs(1e3 * b / 3.35e12 - ms) < 0.002
        least = deepergcn_counts.aggregation_least_seconds(n, e, d, 2, backward)
        assert least == pytest.approx(2 * 28 * b / 3.35e12)


def test_deepergcn_readers_over_spans():
    """The span readers on a made-up attribution: two epochs, each with an
    aggregation forward, its backward, a GEMM and Adam; and the roofline
    share from the counts."""
    from gnnbench.trace import Trace

    ops = []
    for ep in range(2):
        t = 10.0 * ep
        ops += [(("k_fwd", t, t + 1.0), ("train_epoch", "train.forward", "nn.softmax_aggr")),
                (("gemm", t + 1.0, t + 3.0), ("train_epoch", "train.forward")),
                (("k_bwd", t + 3.0, t + 5.0), ("train_epoch", "train.backward",
                                                "nn.softmax_aggr.backward")),
                (("adam", t + 5.0, t + 5.5), ("train_epoch", "train.optimizer"))]
    ops.append((("k_fwd", 20.0, 20.5), ("train.eval", "nn.softmax_aggr")))
    d = deepergcn_counts.Dims(4, 6, 3, 2)
    ctx = {"trace": Trace(30.0, 13.0, [], [], []), "traced_epochs": 2, "span_paths": ops,
           "deepergcn_dims": d, "num_nodes": 10, "attended_edges": 30,
           "jobs": [{"epochs": 2, "wall_s": 1.0}]}
    assert deepergcn_readers.softmax_aggr_ms_per_epoch(ctx) == pytest.approx(3000.0)
    assert deepergcn_readers.dense_ms_per_epoch(ctx) == pytest.approx(2000.0)
    least = deepergcn_counts.aggregation_least_seconds(10, 30, d, 3, False)
    assert deepergcn_readers.softmax_aggr_roofline(ctx) == pytest.approx(100 * least / 2.5)
    least_b = deepergcn_counts.aggregation_least_seconds(10, 30, d, 2, True)
    assert deepergcn_readers.softmax_aggr_backward_roofline(ctx) == pytest.approx(
        100 * least_b / 4.0)
    flops = 2 * deepergcn_counts.epoch_flops(10, 30, d) + deepergcn_counts.forward_flops(
        10, 30, d)
    assert deepergcn_readers.step_mfu(ctx) == pytest.approx(100 * flops / 67e12)
    assert deepergcn_readers.softmax_aggr_ms_per_epoch({"trace": None}) is None
    # the parent's program carries no nn.softmax_aggr span: the readers fall silent
    plain = dict(ctx, span_paths=[(op, tuple(p for p in path if "softmax" not in p))
                                  for op, path in ops])
    assert deepergcn_readers.softmax_aggr_ms_per_epoch(plain) is None
    assert deepergcn_readers.softmax_aggr_roofline(plain) is None
    assert deepergcn_readers.dense_ms_per_epoch(plain) is None


def test_benchmark_reference_is_the_repository_reference():
    assert (REPO / "gnnbench/reference/deepergcn.py").read_text() == \
        (REPO / "reference/deepergcn.py").read_text()
