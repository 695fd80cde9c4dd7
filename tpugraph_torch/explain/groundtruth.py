"""Port of ``tpugraph/explain/groundtruth.py``: motif ground truth and the
explanation AUC, without sklearn.

The ROC AUC is the Mann-Whitney statistic: the mean rank of the positive
scores among all scores (ties get their average rank), which is what
``sklearn.metrics.roc_auc_score`` computes for binary labels.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_HOUSE_EDGES = [(0, 1), (1, 2), (2, 3), (0, 3), (0, 4), (1, 4)]
_CYCLE6_EDGES = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (0, 5)]


def _grid_edges(dim: int = 3) -> List[Tuple[int, int]]:
    """Edges of a dim x dim grid under the generator's row-major node
    numbering (``tpugraph/explain/groundtruth.py:21``)."""
    edges = []
    for i in range(dim):
        for j in range(dim):
            a = i * dim + j
            if j + 1 < dim:
                edges.append((a, a + 1))
            if i + 1 < dim:
                edges.append((a, a + dim))
    return edges


# the motif of each dataset, by node offset from the motif's first node;
# the grids of syn3/syn5 are tpugraph's extension of the reference
MOTIF_EDGES = {
    "syn1": _HOUSE_EDGES,
    "syn2": _HOUSE_EDGES,
    "syn3": _grid_edges(3),
    "syn4": _CYCLE6_EDGES,
    "syn5": _grid_edges(3),
}


def make_pred_real(adj: np.ndarray, start: int, dataset: str = "syn1"
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Upper-triangle mask weights and ground-truth motif-edge labels of a
    dense masked sub-adjacency whose motif starts at ``start``
    (``tpugraph/explain/groundtruth.py:46``)."""
    if dataset not in MOTIF_EDGES:
        raise ValueError(f"no motif ground truth for dataset {dataset!r}")
    adj = np.asarray(adj)
    sel = np.triu(adj) > 0
    pred = adj[sel]
    real = adj.copy()
    n = adj.shape[0]
    for (i, j) in MOTIF_EDGES[dataset]:
        a, b = start + i, start + j
        if a < n and b < n and real[a][b] > 0:
            real[a][b] = 10.0
    real = (real[sel] == 10.0).astype(np.float64)
    return pred, real


def rankdata(a: np.ndarray) -> np.ndarray:
    """``scipy.stats.rankdata(a)``: ranks from 1, ties sharing the mean of
    the ranks they span."""
    a = np.asarray(a).ravel()
    order = np.argsort(a, kind="mergesort")
    s = a[order]
    first = np.concatenate([[True], s[1:] != s[:-1]])
    dense = np.cumsum(first) - 1
    bounds = np.concatenate([np.nonzero(first)[0], [a.size]])
    ranks = np.empty(a.size, dtype=np.float64)
    ranks[order] = 0.5 * (bounds[dense] + bounds[dense + 1] + 1)
    return ranks


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Binary ROC AUC by ranks; raises ``ValueError`` when only one class
    is present, as sklearn does."""
    y_true = np.asarray(y_true) == 1
    n_pos = int(y_true.sum())
    n_neg = y_true.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("ROC AUC needs both classes in y_true")
    ranks = rankdata(np.asarray(y_score, dtype=np.float64))
    return float((ranks[y_true].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def explanation_auc(masked_adjs: List[np.ndarray], starts: List[int],
                    dataset: str) -> Tuple[float, np.ndarray, np.ndarray]:
    """Aggregate ROC AUC over explained nodes
    (``tpugraph/explain/groundtruth.py:73``)."""
    preds, reals = [], []
    for adj, start in zip(masked_adjs, starts):
        p, r = make_pred_real(adj, start, dataset)
        preds.append(p)
        reals.append(r)
    pred_all = np.concatenate(preds, axis=0)
    real_all = np.concatenate(reals, axis=0)
    return roc_auc(real_all, pred_all), real_all, pred_all
