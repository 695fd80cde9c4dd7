"""Port of ``tpugraph/nn/losses.py``: the cross-entropy losses, the
graph classifier's ``margin_loss`` and DiffPool's
``link_prediction_loss``."""

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


def margin_loss(logits: torch.Tensor, labels: torch.Tensor,
                num_classes: int) -> torch.Tensor:
    """Mean over the batch of ``sum_{j != y} max(0, 1 - x_y + x_j)`` over
    ``num_classes`` (``tpugraph/nn/losses.py:46``, torch's
    ``MultiLabelMarginLoss`` with one positive class)."""
    labels = labels.long()
    x_y = torch.gather(logits, -1, labels[..., None])
    margins = torch.clamp(1.0 - x_y + logits, min=0.0)
    onehot = torch.nn.functional.one_hot(labels, num_classes).to(logits.dtype)
    margins = margins * (1.0 - onehot)
    return torch.mean(torch.sum(margins, dim=-1) / num_classes)


def link_prediction_terms(assign_tensor: torch.Tensor, adj: torch.Tensor,
                          node_mask: Optional[torch.Tensor] = None,
                          eps: float = 1e-7):
    """The sum and the count of :func:`link_prediction_loss`: the binary
    cross-entropy between ``min(S S^T, 1)`` and the adjacency summed over
    the real-node pairs of ``node_mask`` (every entry without one), and the
    number of those pairs (data parallelism sums the count over the
    ranks)."""
    pred_adj = torch.clamp(
        torch.matmul(assign_tensor, assign_tensor.transpose(-1, -2)), max=1.0)
    bce = (-adj * torch.log(pred_adj + eps)
           - (1 - adj) * torch.log(1 - pred_adj + eps))
    if node_mask is not None:
        pair_mask = node_mask[..., :, None] * node_mask[..., None, :]
        return torch.sum(bce * pair_mask), torch.sum(pair_mask)
    return torch.sum(bce), torch.tensor(float(bce.numel()), device=bce.device)


def link_prediction_loss(assign_tensor: torch.Tensor, adj: torch.Tensor,
                         node_mask: Optional[torch.Tensor] = None,
                         eps: float = 1e-7) -> torch.Tensor:
    """DiffPool's auxiliary loss (``tpugraph/nn/losses.py:58``): binary
    cross-entropy between ``min(S S^T, 1)`` and the adjacency, averaged over
    the real-node pairs of ``node_mask`` (every entry without one)."""
    total, num = link_prediction_terms(assign_tensor, adj, node_mask, eps)
    return total / torch.clamp(num, min=1.0)
