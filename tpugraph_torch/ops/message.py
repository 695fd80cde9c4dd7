"""Port of ``tpugraph/ops/message.py``: message passing over a padded COO
edge list.

``spmm`` is a gather of the senders' rows (``index_select``, whose
gradient is an ``index_add_``), scaled by the edge weights, then
``index_add_`` over the receivers: the COO aggregation of the GraphConv
layer and the explainer.  The JAX package computes these with
XLA's gather and ``segment_sum``, outside any Pallas kernel, so plain
PyTorch is their port.  On CUDA ``index_add_`` sums with atomics, in an
order that changes from run to run; on the CPU it sums in edge order.

Padding edges carry weight 0 (they gather node 0 and add nothing).
Indices may be int32 or int64.
"""

from __future__ import annotations

from typing import Optional

import torch


def spmm(senders: torch.Tensor, receivers: torch.Tensor,
         edge_weight: torch.Tensor, x: torch.Tensor,
         num_nodes: Optional[int] = None) -> torch.Tensor:
    """``y[i] = sum_e w_e * x[senders[e]]`` over the edges with
    ``receivers[e] == i``: dense ``A @ x`` with ``A[r, s] = w``
    (``tpugraph/ops/message.py:22``).  ``x [N, D]`` -> ``[num_nodes or N, D]``."""
    n = num_nodes or x.shape[0]
    messages = x.index_select(0, senders) * edge_weight[:, None]
    out = messages.new_zeros((n, x.shape[-1]))
    return out.index_add(0, receivers, messages)


def sddmm(senders: torch.Tensor, receivers: torch.Tensor,
          a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-edge ``<a[senders[e]], b[receivers[e]]>``
    (``tpugraph/ops/message.py:48``)."""
    return torch.sum(a[senders] * b[receivers], dim=-1)


def segment_softmax(logits: torch.Tensor, segments: torch.Tensor,
                    num_segments: int,
                    edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax over the edges of each segment, stable by the segment's
    maximum; masked edges (``edge_mask`` 0) get weight 0, and a segment
    with no live edge divides by the 1e-16 floor
    (``tpugraph/ops/message.py:63``)."""
    if edge_mask is not None:
        logits = torch.where(edge_mask > 0, logits,
                             torch.full_like(logits, -torch.inf))
    seg_max = logits.new_full((num_segments,), -torch.inf).scatter_reduce(
        0, segments.long(), logits, reduce="amax", include_self=True)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    exp = torch.exp(logits - seg_max[segments])
    if edge_mask is not None:
        exp = torch.where(edge_mask > 0, exp, torch.zeros_like(exp))
    denom = exp.new_zeros((num_segments,)).index_add(0, segments, exp)
    return exp / torch.clamp(denom[segments], min=1e-16)


def sym_normalize_weights(senders: torch.Tensor, receivers: torch.Tensor,
                          edge_weight: torch.Tensor,
                          num_nodes: int) -> torch.Tensor:
    """``w_e / sqrt(deg_s * deg_r)`` with the in-degree of each node, and
    0 where a degree is 0 (``tpugraph/ops/message.py:83``)."""
    deg = edge_weight.new_zeros((num_nodes,)).index_add(0, receivers,
                                                        edge_weight)
    inv_sqrt = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-12)),
                           torch.zeros_like(deg))
    return edge_weight * inv_sqrt[senders] * inv_sqrt[receivers]
