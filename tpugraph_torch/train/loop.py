"""Port of ``tpugraph/train/loop.py``: full-batch node classification on
the BCSR path.

The JAX loop fuses epochs into one ``lax.scan`` per device call; here it
is an eager Python loop, one optimizer step per epoch, with the same node
split RNG and the same per-epoch metrics (loss and accuracies of the
training-mode forward, before the update).  Only the branch of
``tpugraph/train/loop.py:454-467`` is ported: ``use_bcsr=True``,
``bcsr_format="tiles"``, resident off, ``k_pack=0`` — the others raise.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpugraph_torch._device import DeviceLike, default_device
from tpugraph_torch.core.graph import Graph
from tpugraph_torch.nn.layers import BCSRAdj
from tpugraph_torch.nn.losses import node_cross_entropy
from tpugraph_torch.ops.bcsr import bcsr_from_coo, bcsr_transpose_host
from tpugraph_torch.train.metrics import eval_node
from tpugraph_torch.train.optim import OptimizerConfig, build_optimizer


@dataclasses.dataclass
class TrainConfig:
    """The ``tpugraph`` ``TrainConfig`` fields this path reads.  The BCSR
    fields default to the one ported branch."""

    num_epochs: int = 1000
    lr: float = 0.001
    clip: float = 2.0
    weight_decay: float = 0.005
    train_ratio: float = 0.8
    opt: str = "adam"
    opt_scheduler: str = "none"
    use_bcsr: bool = True
    bcsr_block: int = 128
    bcsr_k_pack: int = 0
    bcsr_format: str = "tiles"
    bcsr_resident: str = "off"


def split_nodes(num_nodes: int, train_ratio: float,
                rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Shuffled node-level train/test split (``tpugraph/train/loop.py:269``)."""
    idx = np.arange(num_nodes)
    rng.shuffle(idx)
    num_train = int(num_nodes * train_ratio)
    return idx[:num_train], idx[num_train:]


def _check_supported(cfg: TrainConfig) -> None:
    if not cfg.use_bcsr:
        raise NotImplementedError("the COO path (use_bcsr=False) is not "
                                  "ported yet")
    if (cfg.bcsr_format, cfg.bcsr_resident, cfg.bcsr_k_pack) != ("tiles", "off", 0):
        raise NotImplementedError(
            "only bcsr_format='tiles', bcsr_resident='off', bcsr_k_pack=0 "
            "is ported")


def train_node_classifier(
    model: torch.nn.Module,
    g: Graph,
    feat: np.ndarray,
    labels: np.ndarray,
    cfg: TrainConfig,
    seed: int = 0,
    init_params: Optional[Dict[str, torch.Tensor]] = None,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Full-batch node classification on one padded graph
    (``tpugraph/train/loop.py:279``).

    ``model`` is a :class:`tpugraph_torch.nn.GcnEncoderNode`; it moves to
    ``device`` (``None`` = CUDA) and trains in place, starting from
    ``init_params`` (a ``state_dict``) when given.  ``feat`` is
    ``float32[N_pad, D]``, ``labels`` ``int[N_real]``.  Returns params
    (the ``state_dict``), ``ypred [1, N_pad, C]``, the split, the metric
    history, train/test results and the elapsed seconds.
    """
    _check_supported(cfg)
    device = default_device(device)
    rng = np.random.default_rng(seed)
    n_real = g.n_node
    train_idx, test_idx = split_nodes(n_real, cfg.train_ratio, rng)

    s_np = g.senders.numpy()
    r_np = g.receivers.numpy()
    w_np = g.edge_weight.numpy()
    n_pad = g.num_nodes_padded
    m = bcsr_from_coo(s_np, r_np, w_np, n_pad, block=cfg.bcsr_block)
    m_t = bcsr_transpose_host(s_np, r_np, w_np, n_pad, block=cfg.bcsr_block)
    sp = BCSRAdj(m.to(device), m_t.to(device))
    n_new = m.num_nodes  # node padding grows to a block multiple

    feat_pad = np.zeros((n_new, feat.shape[1]), dtype=np.float32)
    feat_pad[: feat.shape[0]] = feat
    labels_pad = np.zeros((n_new,), dtype=np.int64)
    labels_pad[:n_real] = np.asarray(labels)
    train_mask = np.zeros((n_new,), dtype=np.float32)
    train_mask[train_idx] = 1.0
    test_mask = np.zeros((n_new,), dtype=np.float32)
    test_mask[test_idx] = 1.0

    x = torch.from_numpy(feat_pad).to(device)
    y = torch.from_numpy(labels_pad).to(device)
    train_mask_d = torch.from_numpy(train_mask).to(device)
    test_mask_d = torch.from_numpy(test_mask).to(device)

    model.to(device)
    if init_params is not None:
        model.load_state_dict(init_params)
    model.train()
    opt = build_optimizer(model.parameters(), OptimizerConfig(
        opt=cfg.opt, lr=cfg.lr, scheduler=cfg.opt_scheduler,
        weight_decay=cfg.weight_decay, clip=cfg.clip))

    def acc(correct, mask):
        return torch.sum(correct * mask) / torch.clamp(torch.sum(mask), min=1.0)

    hist: Dict[str, List[torch.Tensor]] = {"loss": [], "train_acc": [],
                                           "test_acc": []}
    begin = time.time()
    for _ in range(cfg.num_epochs):
        logits, _ = model(x, sp)
        loss = node_cross_entropy(logits, y, node_mask=train_mask_d)
        opt.zero_grad()
        loss.backward()
        opt.step()
        with torch.no_grad():
            correct = (torch.argmax(logits, dim=-1) == y).float()
            hist["loss"].append(loss.detach())
            hist["train_acc"].append(acc(correct, train_mask_d))
            hist["test_acc"].append(acc(correct, test_mask_d))
    history = {k: (torch.stack(v).tolist() if v else [])
               for k, v in hist.items()}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.time() - begin

    model.eval()
    with torch.no_grad():
        logits, _ = model(x, sp)
    ypred = logits.cpu().numpy()[None]  # [1, N_pad, C]
    result_train, result_test = eval_node(
        ypred[:, :n_real], np.asarray(labels)[None], train_idx, test_idx)
    return {
        "params": model.state_dict(),
        "ypred": ypred,
        "train_idx": train_idx,
        "test_idx": test_idx,
        "history": history,
        "result_train": result_train,
        "result_test": result_test,
        "elapsed": elapsed,
    }
