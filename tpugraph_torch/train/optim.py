"""Port of ``tpugraph/train/optim.py``: the optimizer chain and its learning
rate schedules, held to optax's arithmetic rather than ``torch.optim``'s.

The JAX chain is clip by global norm, then coupled L2 decay added to the
gradient, then the core optimizer (``tpugraph/train/optim.py:59-69``):

* clip — optax's ``clip_by_global_norm``: ``norm = sqrt(sum |g|^2)`` over
  every parameter; the gradients stay as they are when ``norm < clip``
  and become ``(g / norm) * clip`` otherwise (torch's ``clip_grad_norm_``
  divides by ``norm + 1e-6`` instead);
* decay — ``g + weight_decay * w``;
* core — ``adam`` is ``torch.optim.Adam``, optax's formula but for the
  bias corrections ``1 - b^k``, which optax rounds to float32 and torch
  keeps in float64 (the updates part by up to 1e-5 of themselves in the
  first steps); ``sgd`` is optax's ``sgd(lr, momentum=0.95)`` (``t <- g + 0.95 t``,
  ``w <- w - lr t``); ``rmsprop`` is optax's (``nu <- 0.1 g^2 + 0.9 nu``,
  ``w <- w - lr g rsqrt(nu + 1e-8)``, where torch decays by 0.99 and adds
  eps outside the root); ``adagrad`` is optax's (the sum of squares starts
  at 0.1, ``w <- w - lr g rsqrt(s + 1e-7)``; torch starts at 0 and adds
  eps outside the root).

The schedules read the optimizer's own update count, 0 at the first
update, as optax's ``scale_by_schedule`` does (``torch.optim.lr_scheduler``
steps after the update, so its first update would take another rate):
``step`` is ``exponential_decay(lr, decay_step, decay_rate,
staircase=True)`` and ``cos`` is ``cosine_decay_schedule(lr, restart)``,
which stays at 0 once the count reaches it.  The node trainer takes one
update an epoch, so the count is the epoch's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

OPTIMIZERS = ("adam", "sgd", "rmsprop", "adagrad")
_SGD_MOMENTUM = 0.95
_RMS_DECAY, _RMS_EPS = 0.9, 1e-8
_ADAGRAD_INIT, _ADAGRAD_EPS = 0.1, 1e-7
# each plain core optimizer's buffers, one per parameter, and their
# initial value (Adam's live in torch.optim.Adam)
_BUFFERS = {"adam": (), "sgd": (("trace", 0.0),),
            "rmsprop": (("nu", 0.0),),
            "adagrad": (("sum_of_squares", _ADAGRAD_INIT),)}


@dataclasses.dataclass
class OptimizerConfig:
    opt: str = "adam"
    lr: float = 0.001
    scheduler: str = "none"       # none | step | cos
    decay_step: int = 100         # epochs between step decays
    decay_rate: float = 0.1
    restart: int = 200            # cosine period (reference opt_restart)
    weight_decay: float = 0.0
    clip: Optional[float] = None  # global-norm clip; None = off


def build_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """The learning rate at update count ``k`` (0 for the first update),
    its schedules in float32 as optax computes them
    (``tpugraph/train/optim.py:33-45``); without one, ``cfg.lr`` itself."""
    lr = np.float32(cfg.lr)
    if cfg.scheduler == "none":
        return lambda k: cfg.lr
    if cfg.scheduler == "step":
        steps = cfg.decay_step
        if steps <= 0 or cfg.decay_rate == 0:
            return lambda k: float(lr)  # optax's constant fallbacks
        rate = np.float32(cfg.decay_rate)
        return lambda k: float(lr * np.power(rate, np.float32(k // steps)))
    if cfg.scheduler == "cos":
        period = float(max(cfg.restart, 1))

        def cos(k: int) -> float:
            c = np.float32(min(float(k), period))
            decay = np.float32(0.5) * (np.float32(1.0) + np.cos(
                np.float32(math.pi) * c / np.float32(period), dtype=np.float32))
            return float(lr * decay)

        return cos
    raise ValueError(f"unknown scheduler {cfg.scheduler!r}")


def clip_by_global_norm_(grads: List[torch.Tensor], clip: float,
                         sq_norm: Optional[torch.Tensor] = None) -> None:
    """optax's ``clip_by_global_norm`` in place, without a host sync:
    ``(g / d) * c`` with ``d, c = 1, 1`` under the clip (``g`` exactly)
    and ``norm, clip`` over it.  ``sq_norm``, when given, is the squared
    global norm (of gradients held across ranks)."""
    if not grads:
        return
    if sq_norm is None:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    else:
        norm = torch.sqrt(sq_norm)
    keep = norm < clip
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, clip)))


class ClippedOptimizer:
    """The chain of :class:`OptimizerConfig` over ``params``: ``step``
    clips, adds the decay, and applies the core optimizer at the
    schedule's rate for the current update count.  ``state_dict`` /
    ``load_state_dict`` carry the count and the core's buffers.
    ``grad_sq_norm(params, grads)``, when set, gives the squared global
    norm the clip divides by (the tensor-parallel step sets it to sum
    the shards' over the ranks)."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 cfg: OptimizerConfig):
        if cfg.opt not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {cfg.opt!r}")
        self.params = list(params)
        self.cfg = cfg
        self.lr_at = build_schedule(cfg)
        self.count = 0
        self.grad_sq_norm: Optional[Callable] = None
        self.adam = (torch.optim.Adam(self.params, lr=cfg.lr,
                                      weight_decay=cfg.weight_decay)
                     if cfg.opt == "adam" else None)
        self.buffers: Dict[str, List[torch.Tensor]] = {
            name: [torch.full_like(p, init).detach() for p in self.params]
            for name, init in _BUFFERS[cfg.opt]}

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        live = [i for i, p in enumerate(self.params) if p.grad is not None]
        ps = [self.params[i] for i in live]
        grads = [p.grad for p in ps]
        bufs = {k: [v[i] for i in live] for k, v in self.buffers.items()}
        if self.cfg.clip:
            clip_by_global_norm_(grads, self.cfg.clip,
                                 None if self.grad_sq_norm is None
                                 else self.grad_sq_norm(ps, grads))
        lr = self.lr_at(self.count)
        self.count += 1
        if self.adam is not None:  # adds the decay itself
            for group in self.adam.param_groups:
                group["lr"] = lr
            self.adam.step()
            return
        if self.cfg.weight_decay:
            grads = torch._foreach_add(grads, ps, alpha=self.cfg.weight_decay)
        if self.cfg.opt == "sgd":
            trace = bufs["trace"]
            torch._foreach_mul_(trace, _SGD_MOMENTUM)
            torch._foreach_add_(trace, grads)
            upd = trace
        elif self.cfg.opt == "rmsprop":
            nu = bufs["nu"]
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1.0 - _RMS_DECAY)
            torch._foreach_mul_(nu, _RMS_DECAY)
            torch._foreach_add_(nu, sq)
            upd = torch._foreach_mul(
                torch._foreach_rsqrt(torch._foreach_add(nu, _RMS_EPS)), grads)
        else:  # adagrad
            # the sum starts at 0.1 and only grows, so optax's 0 where it
            # is 0 never applies
            acc = bufs["sum_of_squares"]
            torch._foreach_add_(acc, torch._foreach_mul(grads, grads))
            upd = torch._foreach_mul(
                torch._foreach_rsqrt(torch._foreach_add(acc, _ADAGRAD_EPS)), grads)
        torch._foreach_add_(ps, torch._foreach_mul(upd, -lr))

    def state_dict(self) -> Dict:
        return {"opt": self.cfg.opt, "count": self.count,
                "adam": None if self.adam is None else self.adam.state_dict(),
                "buffers": {k: [b.cpu().clone() for b in v]
                            for k, v in self.buffers.items()}}

    def load_state_dict(self, state: Dict) -> None:
        if state["opt"] != self.cfg.opt:
            raise ValueError(f"optimizer state of {state['opt']!r} cannot "
                             f"resume {self.cfg.opt!r}")
        self.count = int(state["count"])
        if self.adam is not None:
            self.adam.load_state_dict(state["adam"])
        for k, bufs in self.buffers.items():
            for b, saved in zip(bufs, state["buffers"][k], strict=True):
                b.copy_(saved)


def build_optimizer(params: Iterable[torch.nn.Parameter],
                    cfg: OptimizerConfig) -> ClippedOptimizer:
    """The optimizer chain of ``cfg`` (``tpugraph/train/optim.py:31``)."""
    return ClippedOptimizer(params, cfg)
