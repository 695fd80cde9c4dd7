"""Port of ``tpugraph/ops/dense.py``: the dense-adjacency oracles of the
COO ops (``adj[r, s]`` holds the message from s to r)."""

from __future__ import annotations

import torch


def dense_spmm(adj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``adj @ x``, batched over leading dims (``tpugraph/ops/dense.py:16``)."""
    return torch.matmul(adj, x)


def dense_sddmm(adj_support: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """``(a @ b^T) * [adj_support != 0]`` (``tpugraph/ops/dense.py:22``)."""
    scores = torch.matmul(a, torch.transpose(b, -1, -2))
    return scores * (adj_support != 0).to(scores.dtype)
