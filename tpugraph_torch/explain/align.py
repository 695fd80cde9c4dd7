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

import copy
from typing import Tuple

import numpy as np
import torch

from tpugraph_torch._device import DeviceLike, default_device


class Alignment:
    """One pair's relaxed permutation ``P`` and its Adam state on one
    device.  :meth:`state` and :meth:`load` move the whole state between
    devices, so a long run can be held to another device's run a segment
    at a time, within the horizon where the optimization is still
    conditioned."""

    def __init__(self, ref_feat: np.ndarray, ref_adj: np.ndarray,
                 ref_node_idx: int, curr_feat: np.ndarray, curr_adj: np.ndarray,
                 curr_node_idx: int, lr: float = 0.01, device: DeviceLike = None):
        dev = default_device(device)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
        self.ra, self.ca, self.rf, self.cf = (t(ref_adj), t(curr_adj),
                                              t(ref_feat), t(curr_feat))
        n_ref, n_curr = self.ra.shape[0], self.ca.shape[0]
        P = torch.full((n_ref, n_curr), 1.0 / n_ref, device=dev)
        P[ref_node_idx, :] = 0.0
        P[:, curr_node_idx] = 0.0
        P[ref_node_idx, curr_node_idx] = 1.0
        self.P = P.requires_grad_(True)
        self.opt = torch.optim.Adam([self.P], lr=lr, betas=(0.5, 0.999), eps=1e-8)

    def step(self, num_steps: int) -> None:
        """``num_steps`` Adam steps on ``||P Xc - Xr||_F + ||P Ac P^T - Ar||_F``."""
        P = self.P
        with torch.enable_grad():
            for _ in range(num_steps):
                loss = (torch.linalg.norm(P @ self.cf - self.rf)
                        + torch.linalg.norm(P @ self.ca @ P.T - self.ra))
                self.opt.zero_grad()
                loss.backward()
                self.opt.step()

    def state(self) -> dict:
        """A copy of ``P`` and the optimizer's state."""
        return {"P": self.P.detach().clone(),
                "opt": copy.deepcopy(self.opt.state_dict())}

    def load(self, state: dict) -> None:
        """Continue from :meth:`state` of a run on any device."""
        with torch.no_grad():
            self.P.copy_(state["P"])
        self.opt.load_state_dict(state["opt"])

    def result(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(P, aligned_adj, aligned_feat)`` as numpy."""
        with torch.no_grad():
            P = self.P.detach()
            aligned_adj = P @ self.ca @ P.T
            aligned_feat = P @ self.cf
        return (P.cpu().numpy(), aligned_adj.cpu().numpy(),
                aligned_feat.cpu().numpy())


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
    run = Alignment(ref_feat, ref_adj, ref_node_idx, curr_feat, curr_adj,
                    curr_node_idx, lr=lr, device=device)
    run.step(num_steps)
    return run.result()
