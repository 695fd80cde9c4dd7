"""Port of ``tpugraph/parallel/mesh.py``: the device mesh as a process
group of ``torch.distributed``.

A :class:`Mesh` is the group of ranks a collective runs over (one rank a
device), its axis names and shape, and for a 2-D ``("dcn", "data")``
layout the two subgroups of this rank: ``inner`` (the ranks that share
its outer index, the fast axis) and ``outer`` (the ranks that share its
inner index).  Every rank creates every subgroup, in one order, as
``torch.distributed.new_group`` requires.  A rank's device is its CUDA
card on NCCL (the launcher gives rank ``r`` card ``r``) and the CPU on
gloo.

:func:`init_distributed` joins a group that ``torchrun`` describes in the
environment; :func:`tpugraph_torch.parallel.launch.run_ranks` spawns one.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Mesh:
    """A process group with named axes: ``shape[i]`` ranks along
    ``axis_names[i]``, the last axis the fastest varying (rank ``r`` of a
    ``(no, ni)`` mesh sits at ``(r // ni, r % ni)``).  ``group`` ``None`` is
    the default group."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    group: Optional[dist.ProcessGroup] = None
    inner: Optional[dist.ProcessGroup] = None
    outer: Optional[dist.ProcessGroup] = None

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    @property
    def device(self) -> torch.device:
        """This rank's device: its CUDA card on NCCL, else the CPU."""
        if self.backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    @property
    def hierarchical(self) -> bool:
        return len(self.shape) == 2


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(num_devices: int = 0, axis_names: Sequence[str] = ("data",),
              shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """The mesh over the first ``num_devices`` ranks (every rank when 0)
    of the initialized process group (``tpugraph/parallel/mesh.py:28``):
    1-D on one ``data`` axis by default, N-D with ``shape``, the first axis
    the slow one (``make_mesh(axis_names=("dcn", "data"), shape=(2, 4))``).
    The ``ValueError`` texts are ``tpugraph``'s.  Every rank calls it, and
    the ranks outside a smaller mesh must call it too (their mesh is not
    theirs to use)."""
    devs = _world()
    if num_devices:
        if num_devices > devs:
            raise ValueError(f"mesh of {num_devices} devices, have {devs}")
        devs = num_devices
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError(
                "multi-axis meshes need an explicit shape, e.g. "
                "make_mesh(axis_names=('dcn', 'data'), shape=(2, 4))")
        shape = (devs,)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} vs axis_names {axis_names}")
    n = int(np.prod(shape))
    if n > devs:
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, "
                         f"have {devs}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group: "
                           "launch the ranks with parallel.launch.run_ranks "
                           "or torchrun (init_distributed)")
    group = None if n == dist.get_world_size() else dist.new_group(list(range(n)))
    mesh = Mesh(tuple(axis_names), tuple(int(s) for s in shape), group)
    if len(shape) == 2:
        no, ni = shape
        me = dist.get_rank()
        for a in range(no):  # rows: one outer index, the inner axis
            g = dist.new_group([a * ni + c for c in range(ni)])
            if me // ni == a:
                mesh.inner = g
        for c in range(ni):  # columns: one inner index, the outer axis
            g = dist.new_group([a * ni + c for a in range(no)])
            if me % ni == c:
                mesh.outer = g
    elif len(shape) > 2:
        raise ValueError(f"meshes of 1 or 2 axes, got shape {tuple(shape)}")
    return mesh


def group_mesh(axis="data") -> Mesh:
    """The mesh of every rank of the active group: 1-D on ``axis``, or for
    a pair ``(outer, inner)`` the 2-D ``(2, n / 2)`` mesh ``tpugraph``'s
    halo trainer builds (``tpugraph/train/loop.py:611``)."""
    if isinstance(axis, str):
        return make_mesh(axis_names=(axis,))
    return make_mesh(axis_names=tuple(axis), shape=(2, _world() // 2))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout_s: float = 600.0) -> bool:
    """Join the process group ``torchrun`` describes (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) or the
    arguments give (``coordinator_address`` as ``host:port``)
    (``tpugraph/parallel/mesh.py:64``): NCCL with card ``LOCAL_RANK``
    where CUDA is available, else gloo.  Returns ``True`` when a group is
    active after the call and ``False`` (single process) when nothing
    describes one."""
    if dist.is_initialized():
        return True
    env = os.environ
    world = num_processes if num_processes is not None else env.get("WORLD_SIZE")
    rank = process_id if process_id is not None else env.get("RANK")
    if world is None or rank is None:
        log.info("torch.distributed not configured; single process")
        return False
    init = (f"tcp://{coordinator_address}" if coordinator_address is not None
            else "env://")
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init, world_size=int(world),
                            rank=int(rank),
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True
