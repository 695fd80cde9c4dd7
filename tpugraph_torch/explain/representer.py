"""Port of ``tpugraph/explain/representer.py``: representer-point prototype
selection (reference ``explain.py:404-488``), which scores training
instances by the gradient of the loss at the prediction layer,
``alpha_i = d loss / d pred_i``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from tpugraph_torch.nn.losses import node_cross_entropy


def representer_scores(model: torch.nn.Module, adj: np.ndarray,
                       feat: np.ndarray, label: np.ndarray) -> Dict[str, np.ndarray]:
    """``alpha`` = d CE / d logits (the reference's ``preds_grad``,
    ``explain.py:465-488``) and the logits ``pred``, from the dense cg
    tensors (``adj [B, N, N]``, ``feat [B, N, D]``, ``label [B, N]``) on the
    model's device (``tpugraph/explain/representer.py:23``)."""
    dev = next(model.parameters()).device
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    with torch.no_grad():
        logits, _ = model(t(feat, torch.float32), t(adj, torch.float32))
    logits.requires_grad_(True)
    with torch.enable_grad():
        loss = node_cross_entropy(logits, t(label, torch.int64))
        alpha, = torch.autograd.grad(loss, logits)
    return {"alpha": alpha.cpu().numpy(), "pred": logits.detach().cpu().numpy()}
