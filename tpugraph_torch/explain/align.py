"""Port of ``tpugraph/explain/align.py``: the explanation-alignment
experiment (reference ``explain.py:503-533``), which learns a relaxed
permutation ``P`` minimizing ``||P Xc - Xr||_F + ||P Ac P^T - Ar||_F`` by
Adam (``betas=(0.5, 0.999)``, ``eps=1e-8``: optax's ``adam(lr, b1=0.5)``)
from a uniform ``P`` with the query pair pinned.  At the default lr of
0.01 the optimization amplifies float32 rounding: two correct float32 runs
(or one and a float64 run) part far beyond it within a few hundred steps,
the sooner with constant features.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tpugraph_torch._device import DeviceLike, default_device


def align_explanations(
    ref_feat: np.ndarray,
    ref_adj: np.ndarray,
    ref_node_idx: int,
    curr_feat: np.ndarray,
    curr_adj: np.ndarray,
    curr_node_idx: int,
    num_steps: int = 1000,
    lr: float = 0.01,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(P, aligned_adj, aligned_feat)`` as numpy, after ``num_steps``
    Adam steps on ``device`` (``None`` = CUDA)
    (``tpugraph/explain/align.py:21``)."""
    dev = default_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
    ra, ca, rf, cf = t(ref_adj), t(curr_adj), t(ref_feat), t(curr_feat)
    n_ref, n_curr = ra.shape[0], ca.shape[0]
    P = torch.full((n_ref, n_curr), 1.0 / n_ref, device=dev)
    P[ref_node_idx, :] = 0.0
    P[:, curr_node_idx] = 0.0
    P[ref_node_idx, curr_node_idx] = 1.0
    P.requires_grad_(True)
    opt = torch.optim.Adam([P], lr=lr, betas=(0.5, 0.999), eps=1e-8)
    with torch.enable_grad():
        for _ in range(num_steps):
            loss = (torch.linalg.norm(P @ cf - rf)
                    + torch.linalg.norm(P @ ca @ P.T - ra))
            opt.zero_grad()
            loss.backward()
            opt.step()
    with torch.no_grad():
        aligned_adj = P @ ca @ P.T
        aligned_feat = P @ cf
    return (P.detach().cpu().numpy(), aligned_adj.cpu().numpy(),
            aligned_feat.cpu().numpy())
