"""Port of ``tpugraph/train/multigraph.py``: one shared node classifier
trained over a stack of same-size graphs (the Enron time slices), each
with its own node-level train/test split.

JAX ``vmap``s the forward over the graph axis; here ``torch.func.vmap``
maps the model (``functional_call`` on its parameters) over the leading
slice axis of the features and the padded COO edge lists, so every slice
has its own batch statistics, as under JAX.  One optimizer update an
epoch, ``log_fn`` every 25 epochs and after the last.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call, vmap

from tpugraph_torch._device import DeviceLike, default_device
from tpugraph_torch.core.graph import Graph, batch_graphs
from tpugraph_torch.nn.layers import SparseAdj
from tpugraph_torch.nn.losses import node_cross_entropy
from tpugraph_torch.train.loop import LOG_EVERY, TrainConfig, _opt_config, split_nodes
from tpugraph_torch.train.metrics import eval_node
from tpugraph_torch.train.optim import build_optimizer


def train_node_classifier_multigraph(
    model: torch.nn.Module,
    graphs: List[Graph],
    feats: np.ndarray,     # [G, N_pad, D]
    labels: np.ndarray,    # [G, N_real] (or [G, N_pad])
    cfg: TrainConfig,
    seed: int = 0,
    log_fn=None,
    init_params: Optional[Dict[str, torch.Tensor]] = None,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Train ``model`` (a :class:`~tpugraph_torch.nn.GcnEncoderNode`, moved
    to ``device``, ``None`` = CUDA, starting from ``init_params`` when
    given) on every graph at once (``tpugraph/train/multigraph.py:32``):
    the mean cross-entropy over all graphs' training nodes, the split of
    each graph drawn in turn from ``np.random.default_rng(seed)``.
    Returns params, ``ypred [G, N_pad, C]``, the splits (``[G, .]``), the
    history, the train/test results of the first graph's split over all
    graphs, and the seconds of the epoch loop."""
    device = default_device(device)
    rng = np.random.default_rng(seed)
    bg = batch_graphs(graphs).to(device)
    n_graphs = len(graphs)
    n_pad = graphs[0].num_nodes_padded
    n_real = int(graphs[0].n_node)

    labels = np.asarray(labels)
    labels_pad = np.zeros((n_graphs, n_pad), dtype=np.int64)
    labels_pad[:, : labels.shape[1]] = labels
    train_masks = np.zeros((n_graphs, n_pad), dtype=np.float32)
    test_masks = np.zeros((n_graphs, n_pad), dtype=np.float32)
    train_idx_all, test_idx_all = [], []
    for gi in range(n_graphs):
        tr, te = split_nodes(n_real, cfg.train_ratio, rng)
        train_idx_all.append(tr)
        test_idx_all.append(te)
        train_masks[gi, tr] = 1.0
        test_masks[gi, te] = 1.0

    x = torch.from_numpy(np.asarray(feats, dtype=np.float32)).to(device)
    y = torch.from_numpy(labels_pad).to(device)
    trm = torch.from_numpy(train_masks).to(device)
    tem = torch.from_numpy(test_masks).to(device)
    senders, receivers = bg.senders.long(), bg.receivers.long()

    model.to(device)
    if init_params is not None:
        model.load_state_dict(init_params)
    buffers = dict(model.named_buffers())

    def fwd(params, xg, s, r, w):
        return functional_call(model, (params, buffers), (xg, SparseAdj(s, r, w)))[0]

    vfwd = vmap(fwd, in_dims=(None, 0, 0, 0, 0))
    opt = build_optimizer(model.parameters(), _opt_config(cfg))

    def acc(correct, mask):
        return torch.sum(correct * mask) / torch.clamp(torch.sum(mask), min=1.0)

    hist: Dict[str, List[torch.Tensor]] = {"loss": [], "train_acc": [], "test_acc": []}
    begin = time.time()
    for epoch in range(1, cfg.num_epochs + 1):
        logits = vfwd(dict(model.named_parameters()), x, senders, receivers,
                      bg.edge_weight)
        loss = node_cross_entropy(logits, y, node_mask=trm)
        opt.zero_grad()
        loss.backward()
        opt.step()
        with torch.no_grad():
            correct = (torch.argmax(logits, dim=-1) == y).float()
            hist["loss"].append(loss.detach())
            hist["train_acc"].append(acc(correct, trm))
            hist["test_acc"].append(acc(correct, tem))
        if log_fn is not None and (epoch % LOG_EVERY == 0 or epoch == cfg.num_epochs):
            log_fn(epoch, {k: v[-1].item() for k, v in hist.items()})
    history = {k: (torch.stack(v).tolist() if v else []) for k, v in hist.items()}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.time() - begin

    with torch.no_grad():
        ypred = vfwd(dict(model.named_parameters()), x, senders, receivers,
                     bg.edge_weight).cpu().numpy()
    result_train, result_test = eval_node(ypred[:, :n_real], labels_pad[:, :n_real],
                                          train_idx_all[0], test_idx_all[0])
    return {
        "params": model.state_dict(),
        "ypred": ypred,
        "train_idx": np.asarray(train_idx_all),
        "test_idx": np.asarray(test_idx_all),
        "history": history,
        "result_train": result_train,
        "result_test": result_test,
        "elapsed": elapsed,
    }
