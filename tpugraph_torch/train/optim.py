"""Port of ``tpugraph/train/optim.py`` for ``opt="adam"``,
``scheduler="none"``.

The JAX chain is clip by global norm, then coupled L2 decay added to the
gradient, then Adam (``tpugraph/train/optim.py:59-69``): in PyTorch that
is ``clip_grad_norm_`` before ``torch.optim.Adam(weight_decay=...)``.
Other optimizers and schedules raise.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch


@dataclasses.dataclass
class OptimizerConfig:
    opt: str = "adam"
    lr: float = 0.001
    scheduler: str = "none"
    weight_decay: float = 0.0
    clip: Optional[float] = None  # global-norm clip; None = off


class ClippedOptimizer:
    """An optimizer whose ``step`` clips the gradients' global norm first."""

    def __init__(self, params, inner: torch.optim.Optimizer,
                 clip: Optional[float]):
        self.params = list(params)
        self.inner = inner
        self.clip = clip

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.clip:
            torch.nn.utils.clip_grad_norm_(self.params, self.clip)
        self.inner.step()


def build_optimizer(params: Iterable[torch.nn.Parameter],
                    cfg: OptimizerConfig) -> ClippedOptimizer:
    if cfg.opt != "adam":
        raise NotImplementedError(f"optimizer {cfg.opt!r} is not ported yet")
    if cfg.scheduler != "none":
        raise NotImplementedError(
            f"scheduler {cfg.scheduler!r} is not ported yet")
    params = list(params)
    adam = torch.optim.Adam(params, lr=cfg.lr, weight_decay=cfg.weight_decay)
    return ClippedOptimizer(params, adam, cfg.clip)
