"""Port of ``tpugraph/utils/profiling.py``: named trace regions, a traced
block written as a Chrome trace, and a fenced timing harness, on
``torch.profiler`` (``tpugraph`` uses ``jax.profiler``).

:func:`device_busy` reads such a trace: the union of the card's kernel
intervals over a named region's wall window, and the launches in it.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace_annotation(name: str):
    """A named region in a ``torch.profiler`` trace; nothing at all while
    no profiler is recording, so a loop can carry it for free."""
    if not torch.autograd._profiler_enabled():
        yield
        return
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Profile the block (CPU activity, and CUDA activity when a card is
    present) and write its Chrome trace to ``logdir/trace_<unix s>.json``
    when it ends; yields the profiler, whose ``trace_path`` then names
    the file."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.trace_path = os.path.join(logdir, f"trace_{int(time.time())}.json")
    prof.export_chrome_trace(prof.trace_path)


def _has_cuda(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, (list, tuple)):
        return any(_has_cuda(o) for o in out)
    if isinstance(out, dict):
        return any(_has_cuda(o) for o in out.values())
    return False


def _fence(out) -> None:
    if _has_cuda(out):
        torch.cuda.synchronize()


def benchmark(fn: Callable, *args, iters: int = 20, warmup: int = 2,
              work_items: Optional[int] = None) -> Dict[str, float]:
    """Wall-clock seconds of ``fn(*args)``, each call fenced by
    ``torch.cuda.synchronize`` when its result holds a CUDA tensor:
    ``median_s``, ``mean_s``, ``min_s``, ``iters`` and, with
    ``work_items`` (an edge count, say), ``items_per_s`` at the median."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _fence(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        _fence(out)
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    result = {"median_s": med, "mean_s": float(np.mean(times)),
              "min_s": float(np.min(times)), "iters": float(iters)}
    if work_items is not None:
        result["items_per_s"] = work_items / med
    return result


def device_busy(trace_path: str, region: str, index: int = -1) -> Dict[str, float]:
    """From a Chrome trace of :func:`profile_trace`: the ``index``-th
    host occurrence of the ``region`` annotation (the last by default;
    the ``gpu_user_annotation`` copies that a CUDA trace adds under the
    same name are not windows of the host).  The
    runtime's kernel launches inside it (``launches``: ``cudaLaunchKernel``
    and its kin, with their mean duration ``launch_api_us``), the kernels
    they launched (``kernels``, matched by correlation id), the wall
    window from the region's start to its end or the last of those
    kernels' ends, whichever is later (``window_us``), the union of the
    kernels' intervals in it (``busy_us``, and ``busy_share`` of the
    window) and the window per launch (``window_us_per_launch``)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    wins = [e for e in events if e.get("name") == region and e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]
    if not wins:
        raise ValueError(f"{trace_path}: no region {region!r}")
    win = wins[index]
    t0, t1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    calls = [e for e in events if e.get("ph") == "X"
             and e.get("cat", "").startswith("cuda_")  # the runtime and lower API
             and ("LaunchKernel" in e.get("name", "") or "cuLaunch" in e.get("name", ""))
             and t0 <= float(e["ts"]) <= t1]
    ids = {e.get("args", {}).get("correlation") for e in calls}
    kernels = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
                     and e.get("args", {}).get("correlation") in ids)
    end = max([t1] + [b for _, b in kernels])
    busy, covered = 0.0, t0
    for a, b in kernels:
        a = max(a, covered)
        if b > a:
            busy += b - a
            covered = b
    window = end - t0
    return {"window_us": window, "busy_us": busy,
            "busy_share": busy / window if window > 0 else 0.0,
            "kernels": float(len(kernels)), "launches": float(len(calls)),
            "launch_api_us": (float(np.mean([float(e["dur"]) for e in calls]))
                              if calls else 0.0),
            "window_us_per_launch": window / len(calls) if calls else 0.0}
