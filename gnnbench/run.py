"""Run one benchmark cell of the PyTorch port (``tpugraph_torch``) once.

    python3 gnnbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``'s
``workloads``; its file ``gnnbench/workloads/<cell>.json`` names the
driver (``gnnbench/drivers/<driver>.py``), the traffic's parameters and
the limits of the correctness check, and its configuration is the file
the manifest gives.  A per-layer metric is read by
``gnnbench/metrics/<metric>.py``.  Set-up (imports, inputs and weights
from the seed, kernel builds, warm-up) is timed as ``setup_s``; then the
driver measures for ``--seconds``, and the result holds the cell's
end-to-end metrics.  With ``--trace 1`` a traced span of the driver's
(one whole job) takes the window's place, and the result holds the
cell's per-layer metrics, read from it.  After the window the check runs
the plain reference and holds the program's outputs to the limits.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its
limit); the numbers compared are also the last lines of standard error.
Everything else the run prints goes to standard error.  Exit codes: 2
without enough CUDA cards, 3 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every build and kernel cache inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda_cache")
os.environ["USE_FLAX"] = "0"
os.environ.setdefault("OMP_NUM_THREADS", "4")

from gnnbench import guard  # noqa: E402


class Run:
    """One run's settings, handed to the cell's driver module."""

    def __init__(self, seed, workload, config, device):
        self.seed, self.workload, self.config, self.device = seed, workload, config, device

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(manifest: dict, name: str, root: Path = ROOT):
    """``(cell entry, workload file, configuration file)`` of cell ``name``
    (``root``: the checkout)."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r} (have {sorted(cells)})")
    cell = cells[name]
    with open(root / "gnnbench" / "workloads" / f"{name}.json") as f:
        workload = json.load(f)
    cfg = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    with open(root / cfg["file"]) as f:
        config = json.load(f)
    return cell, workload, config


def cell_metrics(manifest: dict, section: str, name: str):
    """The metrics of ``section`` that cell ``name`` reports."""
    return [m for m in manifest[section]
            if "workloads" not in m or name in m["workloads"]]


def load_reader(metric: str, root: Path = ROOT):
    """``gnnbench/metrics/<metric>.py``'s ``read``."""
    path = root / "gnnbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "gnnbench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def fail_if_forbidden(when: str) -> None:
    found = guard.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded {when}: {found}", file=sys.stderr, flush=True)
        sys.exit(3)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cell = load_cell(load_manifest(), args.workload)[0]

    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); available: {have}",
              file=sys.stderr, flush=True)
        return 2
    fail_if_forbidden("at start-up")
    result = execute(args, torch.device("cuda"))
    fail_if_forbidden("after the window")
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def execute(args, device, root: Path = ROOT) -> dict:
    """Set-up, window, the traced span with ``--trace 1``, and the check, on
    ``device`` (the card; the tests drive it on the CPU); returns the
    result object."""
    import torch

    manifest = load_manifest(root)
    cell, workload, config = load_cell(manifest, args.workload, root)
    on_card = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(args.seed, workload, config, device)
    driver = importlib.import_module(f"gnnbench.drivers.{workload['driver']}")
    with contextlib.redirect_stdout(sys.stderr):
        run.log(f"set-up: imports done at {time.perf_counter() - T_START:.3f} s")
        if on_card:
            torch.zeros(1, device=device)
            torch.cuda.synchronize()
            run.log(f"set-up: the card's context at {time.perf_counter() - T_START:.3f} s")
        st = driver.setup(run)
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - T_START
        metrics, breakdown, tr = {}, None, None
        if args.trace == 0:
            win = driver.window(st, args.seconds, run)
            measured = dict(win["measured"], setup_s=setup_s)
            for m in cell_metrics(manifest, "end_to_end", args.workload):
                metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
        else:
            from gnnbench import trace as tracing

            ctx = driver.traced(st, run)
            win = {"attempted": ctx["attempted"], "failed": ctx["failed"]}
            tr = ctx["trace"]
            for m in cell_metrics(manifest, "per_layer", args.workload):
                value = load_reader(m["name"], root)(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            breakdown = {"device_ops": tracing.top_device_ops(tr),
                         "idle_gaps": tracing.idle_by_host(tr)}
            del ctx
        device_info = {"platform": "gpu" if on_card else device.type,
                       "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                       "count": cell["chips"],
                       "memory_peak_bytes": torch.cuda.max_memory_allocated(device)
                       if on_card else 0,
                       "power_limit": power_limit() if on_card else "none"}
        if tr is not None:
            device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        driver.release(st)
        if on_card:
            torch.cuda.empty_cache()
        from gnnbench import compare

        t_check = time.perf_counter()
        correct, checks = compare.judge(driver.check(st, run), workload["limits"])
        run.log(f"check: {time.perf_counter() - t_check:.3f} s")
    result = {"correct": correct and win["failed"] == 0,
              "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


if __name__ == "__main__":
    sys.exit(main())
