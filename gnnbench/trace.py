"""A traced span of the timed path, read from ``torch.profiler`` (CPU and
CUDA activity): the device's operations, the union of their intervals
(``busy_s``) over the span's wall time (``window_s``), and where the
device sat idle, named by what the host was doing then.

The busy union is the arithmetic of ``tpugraph_torch/utils/profiling.py:
device_busy``, copied, over every operation on the device (kernels,
copies, sets) rather than over one annotated region's launches.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float, float]]  # (name, start s, end s)
    host_ops: List[Tuple[str, float, float]]
    gaps: List[Tuple[float, float]]             # idle intervals inside the window


def _events(prof) -> list:
    """``(name, device type, start ns, duration ns, is a user annotation)``
    of every event the profiler recorded."""
    return [(e.name(), str(e.device_type()), e.start_ns(), e.duration_ns(),
             bool(e.is_user_annotation()))
            for e in prof.profiler.kineto_results.events()]


_SPAN = "gnnbench.traced_span"


@contextlib.contextmanager
def span(name: str):
    """A named host span of the benchmark's own, recorded only while a
    profiler records (``gnnbench.<name>`` in the trace)."""
    if not torch.autograd._profiler_enabled():
        yield
        return
    with torch.profiler.record_function(f"gnnbench.{name}"):
        yield


def capture(fn: Callable[[], object]) -> Tuple[object, Trace]:
    """Run ``fn`` under the profiler inside one named host span that ends
    after the device is synchronised; returns its result and the span's
    :class:`Trace` (idle time before the first and after the last device
    operation counts as a gap)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    card = torch.cuda.is_available()
    if card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(_SPAN):
            out = fn()
            if card:
                torch.cuda.synchronize()
    events = _events(prof)
    spans = [(s, s + d) for name, dev, s, d, _ in events
             if name == _SPAN and "CPU" in dev]
    if not spans:
        raise RuntimeError("the profiler recorded no host span")
    t0, t1 = spans[0]
    annotations = {name for name, dev, _, _, ann in events if ann and "CPU" in dev}
    annotations.add(_SPAN)
    dev_ops = sorted(((name, s, s + d) for name, dev, s, d, ann in events
                      if "CUDA" in dev and not ann and name not in annotations
                      and d > 0 and s < t1 and s + d > t0),
                     key=lambda t: t[1])
    host_ops = [(name, s, s + d) for name, dev, s, d, _ in events
                if "CPU" in dev and d > 0 and name != _SPAN]
    busy, covered, gaps = 0, t0, []
    for _, s, e in dev_ops:
        s, e = max(s, t0), min(e, t1)
        if s > covered:
            gaps.append((covered, s))
        if e > covered:
            busy += e - max(s, covered)
            covered = e
    if t1 > covered:
        gaps.append((covered, t1))
    ns = 1e-9
    return out, Trace((t1 - t0) * ns, busy * ns,
                      [(n, s * ns, e * ns) for n, s, e in dev_ops],
                      [(n, s * ns, e * ns) for n, s, e in host_ops],
                      [(a * ns, b * ns) for a, b in gaps])


def top_device_ops(tr: Trace, k: int = 10) -> List[List]:
    """The ``k`` device operations with the most time, summed by name."""
    tot: Dict[str, float] = collections.defaultdict(float)
    for name, s, e in tr.device_ops:
        tot[name] += e - s
    return [[n, t] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def idle_by_host(tr: Trace, k: int = 10) -> List[List]:
    """The device's idle time summed by the innermost host operation running
    at each gap's midpoint (the one started last of those still open;
    ``host`` where none ran), the ``k`` largest."""
    ops = sorted(tr.host_ops, key=lambda t: t[1])
    tot: Dict[str, float] = collections.defaultdict(float)
    stack: List[Tuple[str, float, float]] = []
    i = 0
    for a, b in sorted(tr.gaps):
        mid = 0.5 * (a + b)
        while i < len(ops) and ops[i][1] <= mid:
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        tot[stack[-1][0] if stack else "host"] += b - a
    return [[n, t] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def matched_device_time(tr: Trace, patterns) -> float:
    """Seconds of the device operations whose name holds any of ``patterns``."""
    return float(np.sum([e - s for n, s, e in tr.device_ops
                         if any(p in n for p in patterns)]))
