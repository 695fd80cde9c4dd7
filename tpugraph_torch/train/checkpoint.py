"""Port of ``tpugraph/train/checkpoint.py``: the checkpoint directory and
its trained-model -> explainer handoff bundle.

Same prefix scheme, ``cg.npz`` keys, ``train_idx.npy`` and ``meta.json``
as ``tpugraph``; the parameters are a PyTorch ``state_dict`` in
``params.pt`` instead of flax msgpack.  (Reading ``tpugraph``'s
``params.msgpack`` is not ported yet.)
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch


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
) -> str:
    """Write params (``params.pt``), the cg bundle (``cg.npz`` plus
    ``train_idx.npy``) and ``meta.json`` into ``<ckptdir>/<prefix>``;
    returns the directory."""
    path = os.path.join(ckptdir, prefix)
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in params.items()},
               os.path.join(path, "params.pt"))
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
    """``{params, cg, meta, train_idx}`` from ``<ckptdir>/<prefix>``;
    params load on the CPU."""
    path = os.path.join(ckptdir, prefix)
    pfile = os.path.join(path, "params.pt")
    if not os.path.isfile(pfile):
        raise FileNotFoundError(
            f"Checkpoint does not exist at {path!r}: train a model for this "
            f"dataset first")
    out: Dict[str, Any] = {
        "params": torch.load(pfile, map_location="cpu", weights_only=True),
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
