"""On the card only (marked ``cuda``, skipped here from inside a fixture):
one short run of each cell through ``gnnbench/run.py``, as the benchmark
runs it, comes out correct.  Run on the chip with

    python -m pytest -p no:cacheprovider gnnbench/tests/test_gnnbench_card.py -q
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_card(card, cell):
    out = subprocess.run([sys.executable, "gnnbench/run.py", "--workload", cell,
                          "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
