"""A frozen Chung-Lu power-law graph with Gaussian features and uniform
labels: the stand-in for a citation graph at its published scale (the
dataset itself is not in the repository and is not downloaded).

Endpoints are drawn in proportion to the weights ``(i + 10)^(-1 / (gamma
- 1))`` (``chip_smoke.py:make_powerlaw_graph``'s sequence), self-loops
and repeats dropped, and exactly ``num_edges`` distinct undirected edges
kept.  Departure from that copy: it kept the ``num_edges`` smallest
``(lo, hi)`` keys, which biases the graph towards low ids, and could come
up short; here the draw repeats until enough distinct edges exist and a
uniform subset of them is kept.  Features are N(0, 1) float32, labels
uniform over ``num_classes``, both from the same seed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def generate(seed: int, num_nodes: int, num_edges: int, feat_dim: int,
             num_classes: int, gamma: float = 2.5,
             **_unused) -> Dict[str, np.ndarray]:
    """``{"num_nodes", "lo", "hi", "labels", "feat"}``: the node count,
    each undirected edge once as ``lo < hi``, the labels and the
    features."""
    rng = np.random.default_rng(seed)
    n = int(num_nodes)
    w = (np.arange(n) + 10.0) ** (-1.0 / (gamma - 1.0))
    cdf = np.cumsum(w / w.sum())
    keys = np.empty(0, dtype=np.int64)
    while keys.size < num_edges:
        draw = int((num_edges - keys.size) * 1.3) + 1024
        src = np.searchsorted(cdf, rng.random(draw), side="right")
        dst = np.searchsorted(cdf, rng.random(draw), side="right")
        src, dst = np.minimum(src, n - 1), np.minimum(dst, n - 1)
        keep = src != dst
        lo = np.minimum(src, dst)[keep].astype(np.int64)
        hi = np.maximum(src, dst)[keep].astype(np.int64)
        keys = np.unique(np.concatenate([keys, lo * n + hi]))
    keys = rng.permutation(keys)[:num_edges]
    feat = rng.standard_normal((n, feat_dim), dtype=np.float32)
    labels = rng.integers(0, num_classes, size=n).astype(np.int64)
    return {"num_nodes": n, "lo": keys // n, "hi": keys % n,
            "labels": labels, "feat": feat}
