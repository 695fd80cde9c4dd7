"""Launch-cost probes, the counterparts of the per-call probes of
``bench_palcall_diag.py`` (``tiny_call`` ``:71``, ``res_call`` ``:104``).

* :func:`probe_tiny` — ``o[8, 128] = x * 0.999`` (f32) over a grid of 1 or
  2 CTAs: what one launch costs when the kernel does nearly nothing.
* :func:`probe_resident` — ``out[n, 128]`` f32 zeroed, its first 8 rows
  ``tok + x[0:8]`` (``x`` bf16 ``[n, 128]``): the launch cost as the
  output grows with ``n``.

Each wrapper launches the hand-written kernel of
``tpugraph_torch/csrc/probe_kernels.cu`` and raises on any tensor that is
not on a CUDA device: a probe measures a launch, which a CPU tensor has
none of.  The ``_plain`` twins give the values each probe must return.
Nothing on a training or diffusion path calls them; ``chip_smoke.py``
times them.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from tpugraph_torch.ops._build import check_tensor, library, raise_on, stream

D = 128
GRIDS = (1, 2)
LAUNCHES: Dict[str, int] = {"probe_tiny": 0, "probe_resident": 0}
_bound = False


def _lib():
    global _bound
    lib = library("probe_kernels")
    if not _bound:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.probe_tiny.argtypes = [vp, vp, ci, vp]
        lib.probe_resident.argtypes = [vp, vp, vp, ci, vp]
        lib.probe_tiny.restype = lib.probe_resident.restype = ci
        _bound = True
    return lib


def probe_tiny_plain(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tensor(0.999, dtype=torch.float32)


def probe_resident_plain(tok: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros((x.shape[0], D), dtype=torch.float32, device=x.device)
    out[:8] = tok + x[:8].float()
    return out


def _device_of(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the probes run on a CUDA device only, got {t.device}")
    return t.device


def probe_tiny(x: torch.Tensor, grid: int = 1) -> torch.Tensor:
    """``x [8, 128]`` float32 times 0.999 over ``grid`` (1 or 2) CTAs."""
    dev = _device_of(x)
    check_tensor("x", x, torch.float32, 2, dev)
    if tuple(x.shape) != (8, D) or grid not in GRIDS:
        raise ValueError(f"x must be [8, {D}] and grid in {GRIDS}, got "
                         f"{tuple(x.shape)} and {grid}")
    o = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = _lib().probe_tiny(x.data_ptr(), o.data_ptr(), grid, stream(dev))
    raise_on(err, "probe_tiny")
    LAUNCHES["probe_tiny"] += 1
    return o


def probe_resident(tok: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out [n, 128]`` float32: zeros, rows 0-7 ``tok + x[0:8]``;
    ``tok [8, 128]`` float32, ``x [n >= 8, 128]`` bfloat16."""
    dev = _device_of(tok)
    check_tensor("tok", tok, torch.float32, 2, dev)
    check_tensor("x", x, torch.bfloat16, 2, dev)
    if tuple(tok.shape) != (8, D) or x.shape[0] < 8 or x.shape[1] != D:
        raise ValueError(f"tok must be [8, {D}] and x [n >= 8, {D}], got "
                         f"{tuple(tok.shape)} and {tuple(x.shape)}")
    out = torch.empty((x.shape[0], D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().probe_resident(tok.data_ptr(), x.data_ptr(), out.data_ptr(),
                                    x.shape[0], stream(dev))
    raise_on(err, "probe_resident")
    LAUNCHES["probe_resident"] += 1
    return out
