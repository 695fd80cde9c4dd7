"""Build and load the hand-written CUDA kernels (no counterpart in
``tpugraph``, whose Pallas kernels compile inside JAX).

Every ``*.cu`` source under ``tpugraph_torch/csrc/`` is compiled by
``nvcc`` for ``sm_90a`` into ``build/tpugraph_torch/`` at first use: one
``nvcc`` process per source, all started together.  Each library name
carries a hash of its source, so an edited source is rebuilt.  The
libraries have a plain C interface and are loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpugraph_torch"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_kernels() -> float:
    """Build (where needed) and load every kernel library; returns the
    seconds spent.  Raises if any source fails to compile."""
    if _libs:
        return 0.0
    t0 = time.perf_counter()
    targets = {}
    for src in sorted(_CSRC.glob("*.cu")):
        digest = hashlib.sha256(src.read_bytes() + " ".join(_FLAGS).encode()
                                ).hexdigest()[:12]
        targets[src] = _BUILD_DIR / f"lib{src.stem}_{digest}.so"
    jobs = []
    for src, so in targets.items():
        if so.is_file():
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, so, tmp, proc))
    failed = []
    for src, so, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} (nvcc {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    libs = {src.stem: ctypes.CDLL(str(so)) for src, so in targets.items()}
    _libs.update(libs)
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    build_kernels()
    return _libs[name]


def check_tensor(name: str, t, dtype, ndim: int, device) -> None:
    """Raise ``ValueError`` unless ``t`` has this dtype, rank and device
    and is contiguous (what every kernel wrapper takes)."""
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {dtype} with {ndim} dims, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
