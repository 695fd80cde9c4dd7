"""Port of ``tpugraph/explain/baselines.py``: the gradient and attention
baseline explainers (reference ``explain.py:125-133, 178-214, 717-738``).

Both run the model's dense path on each query's dense sub-adjacency,
``torch.matmul`` as ``tpugraph`` computes it with ``jnp.matmul`` outside
any Pallas kernel, with plain autograd:

* grad — ``sigmoid(|dL/dA| + |dL/dA|^T) * A`` with
  ``L = -log(softmax(logits)[pred] + 1e-12)``;
* att — ``sigmoid(sum over layers of adj_att) * A``.

Subgraphs are zero-padded to a multiple of 32 nodes, and a batch of
queries to one shared bucket, as in ``tpugraph``: the padded nodes are
isolated but still enter a graph classifier's max-pool readout (no
``node_mask`` is passed) and, with ``bn``, the batch statistics of each
node position.  Each query is its own batch of one, as ``tpugraph``'s
``vmap`` makes it: the batched calls map the model over the queries with
``torch.func.vmap``, so batch norm never mixes two queries.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
from torch.func import grad, vmap


def _pad_stack(sub_adjs, sub_feats, multiple: int = 32):
    """Ragged dense subgraphs stacked into one batch padded to the shared
    bucket of the largest (``tpugraph/explain/baselines.py:118``); of one
    subgraph it is ``tpugraph``'s ``_pad_bucket`` (``:12``), which the
    single-query functions here run as a batch of one."""
    ns = [np.asarray(a).shape[0] for a in sub_adjs]
    n_pad = ((max(ns) + multiple - 1) // multiple) * multiple
    d = np.asarray(sub_feats[0]).shape[1]
    adjs = np.zeros((len(ns), n_pad, n_pad), dtype=np.float32)
    feats = np.zeros((len(ns), n_pad, d), dtype=np.float32)
    for i, (a, f) in enumerate(zip(sub_adjs, sub_feats)):
        adjs[i, : ns[i], : ns[i]] = a
        feats[i, : ns[i]] = f
    return adjs, feats, ns


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _query_grads(model, sub_adjs, sub_feats, node_idxs, pred_labels,
                 graph_mode: bool, argnum: int):
    """``d(-log p[pred])/d(adj)`` (``argnum=0``) or ``/d(x)`` (1) of every
    query, each run as its own batch of one, in one mapped call on the
    model's device; returns the padded ``[Q, N, N]`` or ``[Q, N, D]``
    gradients (on that device) and the subgraph sizes."""
    adjs, feats, ns = _pad_stack(sub_adjs, sub_feats)
    dev = _device(model)
    n_pad = adjs.shape[1]
    # one-hot selectors: sum(p * node ⊗ label) is p[node, label] exactly and
    # needs no indexing by a mapped tensor
    node_oh = np.zeros((len(ns), n_pad), np.float32)
    node_oh[np.arange(len(ns)), np.asarray(node_idxs, np.int64)] = 1.0
    labs = np.asarray(pred_labels, np.int64)

    def loss(a, x, node_sel, lab_sel):
        ypred, _ = model(x[None], a[None])
        if graph_mode:
            p = torch.sum(torch.softmax(ypred[0], dim=-1) * lab_sel)
        else:
            p = torch.sum(torch.softmax(ypred[0], dim=-1)
                          * node_sel[:, None] * lab_sel[None, :])
        return -torch.log(p + 1e-12)

    lab_oh = np.eye(model.pred_model.pred.out_features, dtype=np.float32)[labs]
    t = lambda a: torch.from_numpy(a).to(dev)
    with torch.no_grad():  # the model is frozen; grad traces its own graph
        g = vmap(grad(loss, argnums=argnum))(t(adjs), t(feats), t(node_oh),
                                             t(lab_oh))
    return g, ns


def grad_saliency_batch(model: torch.nn.Module, sub_adjs, sub_feats,
                        node_idxs: Sequence[int], pred_labels: Sequence[int],
                        graph_mode: bool = False) -> List[np.ndarray]:
    """Every query's gradient saliency in one mapped call
    (``tpugraph/explain/baselines.py:133``): ``[n_i, n_i]`` maps masked to
    the edge support."""
    g, ns = _query_grads(model, sub_adjs, sub_feats, node_idxs, pred_labels,
                         graph_mode, argnum=0)
    g = torch.abs(g)
    sal = torch.sigmoid(g + g.transpose(-1, -2)).cpu().numpy()
    return [sal[i, :n, :n] * np.asarray(sub_adjs[i]) for i, n in enumerate(ns)]


def grad_saliency(model: torch.nn.Module, sub_adj: np.ndarray,
                  sub_feat: np.ndarray, node_idx_new: int, pred_label: int,
                  graph_mode: bool = False) -> np.ndarray:
    """Gradient baseline of one query: one backward pass of
    ``-log p[pred_label]`` with respect to the dense sub-adjacency,
    ``sigmoid(|dA| + |dA|^T) * A`` (``tpugraph/explain/baselines.py:58``)."""
    return grad_saliency_batch(model, [sub_adj], [sub_feat], [node_idx_new],
                               [pred_label], graph_mode)[0]


def grad_feat_saliency(model: torch.nn.Module, sub_adj: np.ndarray,
                       sub_feat: np.ndarray, node_idx_new: int,
                       pred_label: int, graph_mode: bool = False) -> np.ndarray:
    """``d(-log p)/dx`` of one query, ``[n, D]``
    (``tpugraph/explain/baselines.py:87``)."""
    g, ns = _query_grads(model, [sub_adj], [sub_feat], [node_idx_new],
                         [pred_label], graph_mode, argnum=1)
    return g[0, : ns[0]].cpu().numpy()


def attention_saliency_batch(model: torch.nn.Module, sub_adjs,
                             sub_feats) -> List[np.ndarray]:
    """Every query's attention saliency in one mapped call
    (``tpugraph/explain/baselines.py:178``)."""
    adjs, feats, ns = _pad_stack(sub_adjs, sub_feats)
    dev = _device(model)

    def att(a, x):
        _, att_all = model(x[None], a[None])
        return torch.sigmoid(sum(t[0] for t in att_all))

    with torch.no_grad():
        sal = vmap(att)(torch.from_numpy(adjs).to(dev),
                        torch.from_numpy(feats).to(dev)).cpu().numpy()
    return [sal[i, :n, :n] * np.asarray(sub_adjs[i]) for i, n in enumerate(ns)]


def attention_saliency(model: torch.nn.Module, sub_adj: np.ndarray,
                       sub_feat: np.ndarray) -> np.ndarray:
    """Attention baseline of one query: the layers' attention matrices
    summed, squashed and masked to the edge support
    (``tpugraph/explain/baselines.py:201``)."""
    return attention_saliency_batch(model, [sub_adj], [sub_feat])[0]
