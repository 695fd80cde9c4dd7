"""The readings that the limits of a cell's check are set from, on the
chip at the cell's own size (not run by the benchmark's own runs).

    python3 gnnbench/calibrate.py --workload <cell> --seeds 1,2,3 [--faults 1]

For each seed it builds the cell as a run does, runs one timed job, and
prints one JSON line:

* ``program`` — the program's numbers against the float32 reference (the
  sound runs: the lower reading), and each leaf's change gap;
* with ``--faults 1``, each of these in the program's place:
  ``control`` — the reference computed in TF32 (its dense products'
  operands rounded to 10 mantissa bits, the precision below the
  configuration's float32); ``fault_half`` — the reference with half of
  the training nodes left out of the loss (the mean taken over the
  rest); ``fault_frozen_3`` and ``fault_frozen_half`` — the reference
  whose state stops moving after step 3, or after half of the job's
  steps.  A state left unchanged from the first step reads 1 on
  ``change_gap`` by construction and needs no run.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from gnnbench import compare, run as bench  # noqa: E402


def readings(driver, st, run, faults: bool) -> dict:
    f32 = driver.reference_outputs(st, run)
    prog = driver.program_outputs(st)
    out = {"program": compare.train_readings(prog, f32),
           "program_change_by_leaf": compare.leaf_norm_gaps(
               prog["change"], f32["change"], compare.moving_leaves(f32["grad"])),
           "program_job_change_by_leaf": compare.leaf_norm_gaps(
               prog["jobs"][0]["change"], f32["jobs"][0]["change"],
               compare.moving_leaves(f32["grad"]))}
    if not faults:
        return out
    epochs = run.config["train"]["epochs"]
    half = lambda idx: np.sort(idx)[: len(idx) // 2]  # noqa: E731
    planted = {"control": dict(precision="tf32"), "fault_half": dict(loss_rows=half),
               "fault_frozen_3": dict(freeze_after=3),
               "fault_frozen_half": dict(freeze_after=epochs // 2)}
    for name, kw in planted.items():
        out[name] = compare.train_readings(driver.reference_outputs(st, run, **kw), f32)
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", type=int, choices=(0, 1), default=1)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    manifest = bench.load_manifest()
    _, workload, config = bench.load_cell(manifest, args.workload)
    driver = importlib.import_module(f"gnnbench.drivers.{workload['driver']}")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = bench.Run(seed, workload, config, torch.device("cuda"))
        st = driver.setup(run)
        driver.window(st, 0.0, run)
        driver.release(st)
        torch.cuda.empty_cache()
        out = readings(driver, st, run, bool(args.faults))
        del st
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
