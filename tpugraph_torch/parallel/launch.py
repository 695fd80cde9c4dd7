"""Spawn a process group and run one function in every rank (no
counterpart in ``tpugraph``, where one process drives every device of a
JAX mesh).

:func:`run_ranks` starts ``n`` processes (``spawn``), joins them into a
``torch.distributed`` group — gloo on the CPU, or NCCL with card ``r``
for rank ``r``, never fewer cards than ranks — through a ``file://``
store in a fresh temporary directory (no TCP port to clash with another
group), calls ``fn(*args)`` in each and returns rank 0's result.  Every
collective and the whole run have a timeout, and a rank that raises or
dies ends the others, so a fault fails fast instead of hanging.  ``fn``
must be importable by name (a module-level function), as must everything
in ``args``.  :func:`single_rank` makes a group of the calling process
alone, for the multi-device paths at world size 1.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Iterator, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEFAULT_TIMEOUT_S = 600.0


def check_backend(n: int, backend: str) -> None:
    """Raise unless ``n`` ranks can run on ``backend``: NCCL takes one
    CUDA card a rank and never falls back to the CPU."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if backend == "nccl":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise RuntimeError(
                f"{n} ranks on NCCL need {n} CUDA devices, one a rank; this "
                f"host has {have} (run on a host with {n} cards, or pass "
                "--platform cpu / backend 'gloo' for CPU ranks)")


def _rank_main(call, rank, n, backend, init_file, results, timeout_s):
    try:
        fn, args = pickle.loads(call)
        if backend == "nccl":
            torch.cuda.set_device(rank)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(*args)
        dist.barrier()
        # bytes, not tensors: a tensor would go through shared memory that
        # dies with this process
        results.put((rank, True, pickle.dumps(out) if rank == 0 else None))
    except BaseException:  # report every failure to the parent, then exit with it
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@contextlib.contextmanager
def single_rank(backend: str = "gloo",
                timeout_s: float = DEFAULT_TIMEOUT_S) -> Iterator[None]:
    """A process group of this process alone (world size 1) on
    ``backend`` for the block: the multi-device paths at one rank, without
    a spawn (NCCL on card 0).  Raises if a group is already active."""
    check_backend(1, backend)
    if dist.is_initialized():
        raise RuntimeError("a process group is already active")
    tmp = tempfile.mkdtemp(prefix="tpugraph_rank_")
    try:
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(tmp, 'store')}",
            rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=timeout_s))
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def call_with_mesh(fn: Callable[..., Any], args: tuple = (),
                   kwargs: Optional[dict] = None, axis="data") -> Any:
    """``fn(*args, mesh=group_mesh(axis), **kwargs)`` in a rank: the
    function :func:`run_ranks` calls to hand a trainer that takes a
    ``mesh`` the mesh of the group it spawned."""
    from tpugraph_torch.parallel.mesh import group_mesh

    return fn(*args, mesh=group_mesh(axis), **(kwargs or {}))


def call_each(calls) -> list:
    """Each ``(fn, args, kwargs)`` of ``calls`` in turn, in a rank; their
    results in a list: several runs in one spawned group."""
    return [fn(*args, **kwargs) for fn, args, kwargs in calls]


def run_ranks(fn: Callable[..., Any], n: int, backend: str, *args: Any,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Any:
    """``fn(*args)`` in each of ``n`` spawned ranks of a new process group
    on ``backend`` (``"gloo"`` or ``"nccl"``); returns rank 0's result.
    Raises ``RuntimeError`` with the failing rank's traceback when a rank
    raises or exits without a result, or when ``timeout_s`` passes, and
    before spawning anything when NCCL has fewer cards than ranks."""
    check_backend(n, backend)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="tpugraph_ranks_")
    results = ctx.Queue()
    # the call as bytes: each rank gets its own copy of every tensor (a
    # tensor passed as is would be one shared-memory buffer for all ranks)
    call = pickle.dumps((fn, args))
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(call, r, n, backend, os.path.join(tmp, "store"),
                               results, timeout_s))
             for r in range(n)]
    deadline = time.monotonic() + timeout_s
    done = {}
    try:
        for p in procs:
            p.start()
        while len(done) < n:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in done]
                if dead:
                    # a last message may still be in flight
                    try:
                        rank, ok, payload = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} of {n} exited with code "
                            f"{procs[dead[0]].exitcode} and no result") from None
                elif time.monotonic() > deadline:
                    raise RuntimeError(f"{n} ranks did not finish within "
                                       f"{timeout_s:.0f} s") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{payload}")
            done[rank] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return pickle.loads(done[0])
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10.0)
                if p.is_alive():
                    p.kill()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
