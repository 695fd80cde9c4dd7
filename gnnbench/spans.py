"""Device time attributed to the program's own spans by launch.

The program marks its layers with named trace regions
(``tpugraph_torch/utils/profiling.py:trace_annotation``): ``train_epoch``,
``train_step`` and the regions named ``train.*`` and ``nn.*``.  A traced
job (:func:`gnnbench.trace.capture`) holds them among its host
operations, beside the runtime calls that launch work on the card
(``cudaLaunchKernel`` and its kin, ``cudaMemcpyAsync``,
``cudaMemsetAsync``), and the device's operations, all on the
profiler's one clock.  It carries no correlation ids, so a device
operation is matched to its launch by order: the program puts all its
work on one CUDA stream, which runs its operations in the order they were
launched, so the k-th kernel (copy, set) on the device is the one the
k-th kernel (copy, set) launch call made.  The operation is then put
under the program spans open when that call started: the launching
thread's and, since the host's threads take turns here (the main thread
waits in ``backward`` while autograd's thread launches), the main
thread's around them.  A device operation beyond the last launch call of
its kind has no launch and stays unattributed.

The card's timestamps are converted to the host's clock with an error of
some microseconds, so no device operation is required to start after its
launch call.
"""

from __future__ import annotations

import collections
import re
from typing import Dict, List, Optional, Sequence, Tuple

PROGRAM_SPAN = re.compile(r"^(train_epoch|train_step|train\.|nn\.)")
AGGREGATE = ("nn.aggregate", "nn.aggregate.backward")

Op = Tuple[str, float, float]  # (name, start s, end s)
Path = Tuple[str, ...]         # the program spans open at a launch, outermost first


def launch_kind(name: str) -> Optional[str]:
    """The kind of device operation a host call launches (``kernel``,
    ``memcpy``, ``memset``), or ``None`` for a call that launches none."""
    if "LaunchKernel" in name or "LaunchCooperativeKernel" in name:
        return "kernel"
    if name.startswith(("cudaMemcpy", "cuMemcpy")):
        return "memcpy"
    if name.startswith(("cudaMemset", "cuMemset")):
        return "memset"
    return None


def op_kind(name: str) -> str:
    """The kind of a device operation, by the profiler's name for it."""
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def launch_times(device_ops: Sequence[Op], host_ops: Sequence[Op]
                 ) -> List[Optional[float]]:
    """For each of ``device_ops`` (in start order), the start of the host
    call that launched it: the k-th launch call of its kind; ``None`` past
    the last one."""
    calls: Dict[str, List[float]] = collections.defaultdict(list)
    for name, s, _ in host_ops:
        kind = launch_kind(name)
        if kind is not None:
            calls[kind].append(s)
    for starts in calls.values():
        starts.sort()
    seen: Dict[str, int] = collections.Counter()
    out: List[Optional[float]] = []
    for name, _, _ in device_ops:
        kind = op_kind(name)
        k = seen[kind]
        seen[kind] += 1
        starts = calls.get(kind, ())
        out.append(starts[k] if k < len(starts) else None)
    return out


def attribute(device_ops: Sequence[Op], host_ops: Sequence[Op]
              ) -> List[Optional[Path]]:
    """For each device operation, the program spans open at its launch,
    outermost first (``()`` where none was open); ``None`` where no launch
    call matched it."""
    times = launch_times(device_ops, host_ops)
    # outer before inner where two start together
    spans = sorted(((s, e, name) for name, s, e in host_ops
                    if PROGRAM_SPAN.match(name)), key=lambda sp: (sp[0], -sp[1]))
    out: List[Optional[Path]] = [None] * len(times)
    active: List[Tuple[float, float, str]] = []
    j = 0
    for t, i in sorted((t, i) for i, t in enumerate(times) if t is not None):
        while j < len(spans) and spans[j][0] <= t:
            active.append(spans[j])
            j += 1
        active = [sp for sp in active if sp[1] > t]
        out[i] = tuple(name for _, _, name in active)
    return out


def attributed(tr) -> List[Tuple[Op, Optional[Path]]]:
    """Each device operation of the traced job ``tr`` with its path."""
    return list(zip(tr.device_ops, attribute(tr.device_ops, tr.host_ops)))


def under(path: Optional[Path], *names: str) -> bool:
    """Whether ``path`` holds any span of ``names``."""
    return path is not None and any(n in path for n in names)


def seconds(ops: Sequence[Tuple[Op, Optional[Path]]], keep) -> float:
    """Device seconds of the operations whose path ``keep`` accepts."""
    return sum(e - s for (_, s, e), path in ops if keep(path))


def busy_share(intervals: Sequence[Tuple[float, float]]) -> Optional[float]:
    """The union of ``intervals`` over the window from the first start to
    the last end, or ``None`` where there is no window."""
    if not intervals:
        return None
    intervals = sorted(intervals)
    t0, t1 = intervals[0][0], max(e for _, e in intervals)
    busy, covered = 0.0, t0
    for s, e in intervals:
        s = max(s, covered)
        if e > s:
            busy += e - s
            covered = e
    return busy / (t1 - t0) if t1 > t0 else None
