"""Whole runs of tiny copies of the cells on the CPU (the chip check
skipped): the program agrees with the plain reference within the cells'
limits, the control and each planted fault come out not correct, and a
cell, configuration and metric added as files alone are found."""

import json

import pytest
import torch

from gnnbench import compare
from gnnbench.drivers import train_node
from gnnbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_checkout(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("cell", [c for c, _, _ in tiny.CELLS])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_is_correct_on_the_cpu(root, cell, trace):
    res = tiny.run_cell(root, cell, trace=trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    assert any(name.startswith("job_") for name in res["checks"])
    man = json.loads((root / "BENCHMARK.json").read_text())
    section = "end_to_end" if trace == 0 else "per_layer"
    names = {m["name"] for m in man[section] if cell in m.get("workloads", [cell])}
    if trace == 0:
        assert set(res["metrics"]) == names
    else:
        # a CPU run has no device trace: only the host-side readers answer
        assert set(res["metrics"]) <= names
        assert "breakdown" in res


def _faulty(monkeypatch, fault):
    import tpugraph_torch.train.loop as loop
    from tpugraph_torch.train.optim import ClippedOptimizer

    step = ClippedOptimizer.step
    if fault == "state_unchanged":
        monkeypatch.setattr(ClippedOptimizer, "step", lambda self: None)
    elif fault == "frozen_after_step_3":
        # every job's first three updates happen (set-up's three steps too),
        # then its state stops moving
        monkeypatch.setattr(ClippedOptimizer, "step",
                            lambda self: step(self) if self.count < 3 else None)
    elif fault == "half_batch":
        ce = loop.node_cross_entropy

        def half(logits, y, class_weight=None, node_mask=None):
            keep = torch.nonzero(node_mask).flatten()
            mask = torch.zeros_like(node_mask)
            mask[keep[: len(keep) // 2]] = 1.0
            return ce(logits, y, class_weight=class_weight, node_mask=mask)

        monkeypatch.setattr(loop, "node_cross_entropy", half)
    elif fault == "answer_altered":
        ce = loop.node_cross_entropy
        monkeypatch.setattr(loop, "node_cross_entropy",
                            lambda *a, **k: ce(*a, **k) * 1.01)


@pytest.mark.parametrize("cell", [c for c, _, _ in tiny.CELLS])
@pytest.mark.parametrize("fault", ["state_unchanged", "frozen_after_step_3", "half_batch",
                                   "answer_altered"])
def test_planted_fault_is_not_correct(root, monkeypatch, cell, fault):
    _faulty(monkeypatch, fault)
    res = tiny.run_cell(root, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", [c for c, _, _ in tiny.CELLS])
def test_freeze_after_step_3_passes_the_first_steps_and_fails_the_job(root, monkeypatch,
                                                                     cell):
    """The first steps' numbers cannot see a state that stops moving at step
    4; the whole-job numbers do."""
    _faulty(monkeypatch, "frozen_after_step_3")
    checks = tiny.run_cell(root, cell)["checks"]
    assert all(c["value"] <= c["limit"] for name, c in checks.items()
               if not name.startswith("job_")), checks
    assert any(c["value"] > c["limit"] for name, c in checks.items()
               if name.startswith("job_")), checks


def _run(root, cell, seed=2**31 + 5):
    from gnnbench import run as bench

    man = bench.load_manifest(root)
    _, wl, cfg = bench.load_cell(man, cell, root)
    return bench.Run(seed, wl, cfg, torch.device("cpu")), wl


@pytest.mark.parametrize("cell", [c for c, _, _ in tiny.CELLS])
@pytest.mark.parametrize("planted", [dict(precision="tf32"), dict(freeze_after=3)],
                         ids=["tf32_control", "reference_frozen_after_step_3"])
def test_control_and_reference_faults_fail(root, cell, planted):
    """The TF32 reference, and the reference whose state stops after step 3,
    put in the program's place, fail the cell's limits."""
    torch.set_num_threads(2)
    run, wl = _run(root, cell)
    st = train_node.setup(run)
    f32 = train_node.reference_outputs(st, run)
    fault = train_node.reference_outputs(st, run, **planted)
    ok, _ = compare.judge(compare.train_readings(fault, f32), wl["limits"])
    assert not ok


def test_new_cell_config_and_metric_are_files_alone(root, tmp_path):
    """A cell, its configuration and a per-layer metric added as new files and
    new manifest entries run without an edit to any file there."""
    import shutil

    new = tmp_path / "co"
    shutil.copytree(root, new)
    before = {p: p.read_bytes() for p in (new / "gnnbench").rglob("*") if p.is_file()}
    cfg = json.loads((new / "gnnbench/configs/t-arxiv.json").read_text())
    cfg["model"]["hidden_dim"] = 12
    (new / "gnnbench/configs/t-new.json").write_text(json.dumps(cfg))
    wl = json.loads((new / "gnnbench/workloads/t-arxiv-coo.json").read_text())
    wl["config"] = "t-new"
    (new / "gnnbench/workloads/t-new-train.json").write_text(json.dumps(wl))
    (new / "gnnbench/metrics/jobs_done.py").write_text(
        "def read(ctx):\n    return float(len(ctx.get('jobs') or [])) or None\n")
    man = json.loads((new / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "t-new", "source": "https://arxiv.org/abs/1903.03894",
                           "file": "gnnbench/configs/t-new.json", "reduced": [], "why": "t"})
    man["workloads"].append({"name": "t-new-train", "config": "t-new",
                             "traffic": "t-new-train", "chips": 1, "why": "t"})
    for m in man["end_to_end"]:
        if "t-arxiv-coo" in m.get("workloads", []):
            m["workloads"].append("t-new-train")
    man["per_layer"].append({"name": "jobs_done", "unit": "jobs", "better": "higher",
                             "source": "host_clock", "layer": "entry",
                             "moves": "train_epochs_per_s.coo",
                             "workloads": ["t-new-train"]})
    (new / "BENCHMARK.json").write_text(json.dumps(man))
    res = tiny.run_cell(new, "t-new-train", trace=1)
    assert res["correct"]
    assert res["metrics"]["jobs_done"]["value"] >= 1
    for p, data in before.items():
        assert p.read_bytes() == data
