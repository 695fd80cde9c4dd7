"""Port of ``tpugraph/nn/losses.py`` (the cross-entropy losses)."""

from __future__ import annotations

from typing import Optional

import torch


def softmax_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    class_weight: Optional[torch.Tensor] = None,
    sample_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean softmax cross-entropy, ``sum(w * nll) / sum(w)`` with
    ``w = class_weight[label] * sample_mask`` (``tpugraph/nn/losses.py:11``)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    w = class_weight[labels.long()] if class_weight is not None else torch.ones_like(nll)
    if sample_mask is not None:
        w = w * sample_mask
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1e-12)


def node_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    class_weight: Optional[torch.Tensor] = None,
    node_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-node CE over ``logits [..., N, C]`` (``tpugraph/nn/losses.py:35``)."""
    return softmax_cross_entropy(logits, labels, class_weight, node_mask)
