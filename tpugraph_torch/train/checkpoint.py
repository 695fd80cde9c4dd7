"""Port of ``tpugraph/train/checkpoint.py``: the checkpoint directory and
its trained-model -> explainer handoff bundle.

Same prefix scheme, ``cg.npz`` keys, ``train_idx.npy`` and ``meta.json``
as ``tpugraph``; the parameters are a PyTorch ``state_dict`` in
``params.pt`` instead of flax msgpack, and the optimizer state (for
``--resume``) is the port's optimizer ``state_dict`` in ``opt_state.pt``
instead of ``opt_state.msgpack``.  A checkpoint that ``tpugraph`` wrote
(``params.msgpack`` and no ``params.pt``) loads through the port's own
flax msgpack decoder (:func:`read_flax_msgpack`) and
:func:`tpugraph_torch.nn.encoders.params_from_jax`.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tpugraph_torch.nn.encoders import params_from_jax


def gen_prefix(name: str, method: str = "base", hidden_dim: int = 20,
               output_dim: int = 20, bias: bool = True,
               suffix: str = "") -> str:
    """``<name>_<method>_h<H>_o<O>[_nobias][_suffix]``
    (``tpugraph/train/checkpoint.py:25``)."""
    out = f"{name}_{method}_h{hidden_dim}_o{output_dim}"
    if not bias:
        out += "_nobias"
    if suffix:
        out += "_" + suffix
    return out


def gen_explainer_prefix(prefix: str, explainer_suffix: str = "") -> str:
    """``<prefix>_explain[_suffix]`` (``tpugraph/train/checkpoint.py:42``)."""
    out = prefix + "_explain"
    if explainer_suffix:
        out += "_" + explainer_suffix
    return out


def save_checkpoint(
    ckptdir: str,
    prefix: str,
    params: Dict[str, torch.Tensor],
    cg_dict: Optional[Dict[str, Any]] = None,
    meta: Optional[Dict[str, Any]] = None,
    opt_state: Optional[Dict[str, Any]] = None,
) -> str:
    """Write params (``params.pt``), the optimizer state when given
    (``opt_state.pt``), the cg bundle (``cg.npz`` plus ``train_idx.npy``)
    and ``meta.json`` into ``<ckptdir>/<prefix>``; returns the directory
    (``tpugraph/train/checkpoint.py:62``)."""
    path = os.path.join(ckptdir, prefix)
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in params.items()},
               os.path.join(path, "params.pt"))
    if opt_state is not None:
        torch.save(opt_state, os.path.join(path, "opt_state.pt"))
    if cg_dict is not None:
        arrays = {k: np.asarray(v) for k, v in cg_dict.items()
                  if v is not None and k != "train_idx"}
        np.savez_compressed(os.path.join(path, "cg.npz"), **arrays)
        if cg_dict.get("train_idx") is not None:
            np.save(os.path.join(path, "train_idx.npy"),
                    np.asarray(cg_dict["train_idx"]))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"epoch": -1, **(meta or {})}, f, indent=2,
                  default=lambda o: o.tolist() if hasattr(o, "tolist") else str(o))
    return path


def load_checkpoint(ckptdir: str, prefix: str) -> Dict[str, Any]:
    """``{params, opt_state, cg, meta, train_idx}`` from
    ``<ckptdir>/<prefix>`` (``tpugraph/train/checkpoint.py:103``), on the
    CPU.  ``params`` is ``params.pt``, or without it ``tpugraph``'s
    ``params.msgpack`` decoded and mapped onto the port's parameter names;
    ``opt_state`` is ``opt_state.pt`` or ``None``."""
    path = os.path.join(ckptdir, prefix)
    pfile = os.path.join(path, "params.pt")
    mfile = os.path.join(path, "params.msgpack")
    if os.path.isfile(pfile):
        params = torch.load(pfile, map_location="cpu", weights_only=True)
    elif os.path.isfile(mfile):
        with open(mfile, "rb") as f:
            params = params_from_jax(read_flax_msgpack(f.read()))
    else:
        raise FileNotFoundError(
            f"Checkpoint does not exist at {path!r}: train a model for this "
            f"dataset first")
    ofile = os.path.join(path, "opt_state.pt")
    out: Dict[str, Any] = {
        "params": params,
        "opt_state": (torch.load(ofile, map_location="cpu", weights_only=True)
                      if os.path.isfile(ofile) else None),
        "cg": None, "meta": None, "train_idx": None,
    }
    cg_file = os.path.join(path, "cg.npz")
    if os.path.isfile(cg_file):
        with np.load(cg_file, allow_pickle=False) as z:
            out["cg"] = {k: z[k] for k in z.files}
    ti = os.path.join(path, "train_idx.npy")
    if os.path.isfile(ti):
        out["train_idx"] = np.load(ti)
    mfile = os.path.join(path, "meta.json")
    if os.path.isfile(mfile):
        with open(mfile) as f:
            out["meta"] = json.load(f)
    return out


def read_flax_msgpack(blob: bytes) -> Any:
    """Decode ``flax.serialization.to_bytes`` output (flax 0.12's
    ``msgpack_serialize``) of a parameter tree into nested dicts with numpy
    array leaves, without msgpack or flax.  It reads the subset such a tree
    is written in: maps, str, int and float, and flax's ndarray extension
    (type 1: a packed ``(shape, dtype name, C-order bytes)``, so arrays
    and bin inside it).  Anything else raises ``ValueError``, flax's
    chunked leaves (written only for a leaf over 1 GiB) among it."""
    obj, end = _unpack(memoryview(blob), 0)
    if end != len(blob):
        raise ValueError(f"flax msgpack: {len(blob) - end} trailing bytes")
    return obj


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
          0xCA: ">f", 0xCB: ">d"}
_SIZED = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
          0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
          0xDC: (">H", "array"), 0xDD: (">I", "array"),
          0xDE: (">H", "map"), 0xDF: (">I", "map"),
          0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _unpack(buf: memoryview, i: int) -> Tuple[Any, int]:
    """One msgpack object at ``buf[i:]``; returns it and the next offset."""
    b = buf[i]
    i += 1
    if b <= 0x7F:
        return b, i
    if b >= 0xE0:
        return b - 0x100, i
    if 0x80 <= b <= 0x8F:
        return _body(buf, i, "map", b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _body(buf, i, "array", b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        return _body(buf, i, "str", b & 0x1F)
    if b in _FIXED:
        fmt = _FIXED[b]
        return struct.unpack_from(fmt, buf, i)[0], i + struct.calcsize(fmt)
    if b in _FIXEXT:
        return _body(buf, i, "ext", _FIXEXT[b])
    if b in _SIZED:
        fmt, kind = _SIZED[b]
        n = struct.unpack_from(fmt, buf, i)[0]
        return _body(buf, i + struct.calcsize(fmt), kind, n)
    raise ValueError(f"flax msgpack: unsupported type byte 0x{b:02x}")


def _body(buf: memoryview, i: int, kind: str, n: int) -> Tuple[Any, int]:
    if kind == "bin":
        return bytes(buf[i:i + n]), i + n
    if kind == "str":
        return str(buf[i:i + n], "utf-8"), i + n
    if kind == "array":
        out = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            out.append(v)
        return out, i
    if kind == "map":
        d = {}
        for _ in range(n):
            k, i = _unpack(buf, i)
            d[k], i = _unpack(buf, i)
        return d, i
    code = struct.unpack_from(">b", buf, i)[0]  # ext: type, then n bytes
    if code != 1:
        raise ValueError(f"flax msgpack: unsupported extension type {code}")
    (shape, name, raw), _ = _unpack(buf[i + 1:i + 1 + n], 0)
    arr = np.frombuffer(raw, dtype=np.dtype(name)).copy().reshape(shape)
    return arr, i + 1 + n
