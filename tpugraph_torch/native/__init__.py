"""Port of ``tpugraph/native/__init__.py``: host-side graph helpers.

Only :func:`sym_normalize` is ported, in numpy; the ctypes binding of
``tpugraph/native/graph_engine.cpp`` is not.
"""

from __future__ import annotations

import numpy as np


def sym_normalize(rows: np.ndarray, cols: np.ndarray, weights: np.ndarray,
                  num_nodes: int) -> np.ndarray:
    """``w * inv[rows] * inv[cols]`` with ``inv = 1 / sqrt(deg)`` (0 where
    ``deg`` is 0) and ``deg`` the row sums of ``w``, in a fresh float32
    array (``tpugraph/native/__init__.py:349``, ``graph_engine.cpp:545``).
    Degrees and products are float64, summed in edge order, with one cast
    to float32, so the result is byte-identical to ``tpugraph``'s."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    w = np.asarray(weights, dtype=np.float32)
    deg = np.zeros(num_nodes)
    np.add.at(deg, rows, w)
    inv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-300)), 0.0)
    return (w * inv[rows] * inv[cols]).astype(np.float32)
