"""A copy of the benchmark at a size the CPU tests hold: the cells'
workload files (limits included) on a shrunken copy of their
configuration, as new cells of a copied ``BENCHMARK.json``."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

from gnnbench import run as bench

REPO = Path(__file__).resolve().parents[2]
# (tiny cell, its configuration, the real cell whose workload file it copies)
CELLS = (("t-arxiv-auto", "t-arxiv", "arxiv-train-auto"),
         ("t-arxiv-coo", "t-arxiv", "arxiv-train-coo"))


def _shrink(cfg: dict) -> dict:
    cfg = json.loads(json.dumps(cfg))
    cfg["graph"].update(num_nodes=300, num_edges=1500, feat_dim=16, num_classes=5)
    cfg["model"].update(input_dim=16, hidden_dim=32, embedding_dim=32, label_dim=5)
    cfg["train"]["epochs"] = 10
    return cfg


def make_checkout(dest: Path) -> Path:
    """The benchmark's files under ``dest`` with the tiny cells added to its
    manifest by new entries and new files only; returns ``dest``."""
    shutil.copytree(REPO / "gnnbench", dest / "gnnbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((dest / "gnnbench" / "configs" / "gcn-arxiv.json").read_text())
    (dest / "gnnbench" / "configs" / "t-arxiv.json").write_text(json.dumps(_shrink(cfg)))
    man["configs"].append({"name": "t-arxiv", "source": "https://arxiv.org/abs/1903.03894",
                           "file": "gnnbench/configs/t-arxiv.json", "reduced": [],
                           "why": "a CPU test's size"})
    for cell, cfg_name, real in CELLS:
        wl = json.loads((dest / "gnnbench" / "workloads" / f"{real}.json").read_text())
        wl["config"] = cfg_name
        (dest / "gnnbench" / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
        man["workloads"].append({"name": cell, "config": cfg_name, "traffic": cell,
                                 "chips": 1, "why": "a CPU test's size"})
        for m in man["end_to_end"] + man["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(man))
    return dest


def run_cell(root: Path, cell: str, seed: int = 2**31 + 11, trace: int = 0,
             seconds: float = 0.3) -> dict:
    """One run of ``cell`` on the CPU, the chip check skipped."""
    torch.set_num_threads(2)
    args = bench.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                        str(seconds), "--trace", str(trace)])
    return bench.execute(args, torch.device("cpu"), root)
