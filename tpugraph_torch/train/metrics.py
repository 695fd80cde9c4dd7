"""Port of ``tpugraph/train/metrics.py`` (``eval_node``; numpy already)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _prf(labels: np.ndarray, preds: np.ndarray, num_classes: int):
    conf = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(conf, (labels, preds), 1)
    tp = np.diag(conf).astype(np.float64)
    pred_tot = conf.sum(axis=0).astype(np.float64)
    true_tot = conf.sum(axis=1).astype(np.float64)
    prec = np.where(pred_tot > 0, tp / np.maximum(pred_tot, 1), 0.0)
    rec = np.where(true_tot > 0, tp / np.maximum(true_tot, 1), 0.0)
    return conf, float(prec.mean()), float(rec.mean())


def eval_node(
    ypred: np.ndarray,
    labels: np.ndarray,
    train_idx,
    test_idx,
    num_classes: int = 0,
) -> Tuple[Dict, Dict]:
    """Accuracy, macro precision/recall and confusion matrix over a
    train/test node split; ``ypred [B, N, C]`` logits, ``labels [B, N]``
    (``tpugraph/train/metrics.py:24``)."""
    pred_labels = np.argmax(np.asarray(ypred), axis=2)
    labels = np.asarray(labels)
    if num_classes == 0:
        num_classes = int(ypred.shape[-1])

    def split_result(idx):
        p = np.ravel(pred_labels[:, idx])
        l = np.ravel(labels[:, idx])
        conf, prec, rec = _prf(l, p, num_classes)
        return {"prec": prec, "recall": rec, "acc": float((p == l).mean()),
                "conf_mat": conf}

    return split_result(train_idx), split_result(test_idx)
