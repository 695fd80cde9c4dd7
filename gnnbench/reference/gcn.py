"""Plain float32 reference of the GNNExplainer node classifier and of a
whole full-batch training job with it, for the benchmark's check (no
import of the measured program).

Model (``gnn-model-explainer/models.py``, ``GcnEncoderNode``): three
graph convolutions ``y = normalize((A @ x) @ W + b)`` (L2 per node), a
ReLU after every layer but the last, each followed by batch norm when
``bn``, the layers' outputs concatenated into a linear head.  ``A[r, s]``
is the weight of edge ``s -> r``; no self-loop and no degree
normalisation is added (the reference's syn tasks use the raw adjacency).

Departures, each written where it acts:

* ``bn`` normalises each node over its features with biased variance and
  no affine terms.  That is what the reference's ``nn.BatchNorm1d(N)``
  does to a ``[1, N, F]`` batch (the nodes are its channels), built anew
  in every forward, and what the program computes.
* The optimizer is the program's stated chain, optax's order: clip by the
  global norm (``g * clip / norm`` once ``norm >= clip``), then the
  coupled decay ``g + weight_decay * w``, then Adam with torch's formula.

``precision="tf32"`` rounds both operands of every dense matrix product
(forward and backward) to TF32 (10 mantissa bits, round to nearest even)
and accumulates in float32: what cuBLAS computes with TF32 allowed.  It
is the benchmark's control, a precision below the configuration's.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10 mantissa bits, to nearest even."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ round_tf32(b).transpose(-1, -2), round_tf32(a).transpose(-1, -2) @ g


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """``a @ b`` in float32 (TF32 off) or, with ``"tf32"``, as TF32."""
    if precision == "tf32":
        return _TF32Matmul.apply(a, b)
    if precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    return a @ b


def csr_product(senders: torch.Tensor, receivers: torch.Tensor,
                weight: torch.Tensor, num_nodes: int):
    """``A @ x`` as a function of ``x``: ``A[r, s]`` sums the weights of
    the edges ``s -> r`` (repeats add up), held as a sparse CSR matrix and
    multiplied by torch's sparse-dense product (cuSPARSE on the card),
    ``A^T @ g`` its backward, each accumulating in float32."""
    shape = (num_nodes, num_nodes)

    def csr(rows, cols):
        coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), weight, shape,
                                      check_invariants=False).coalesce()
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            return coo.to_sparse_csr()

    a, a_t = csr(receivers, senders), csr(senders, receivers)

    class _Product(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return a @ x

        @staticmethod
        def backward(ctx, g):
            return a_t @ g

    return _Product.apply


def _bn(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def conv_names(num_layers: int) -> List[str]:
    """The convolutions' parameter prefixes, first to last."""
    return (["stack.conv_first"]
            + [f"stack.conv_block.{i}" for i in range(num_layers - 2)]
            + ["stack.conv_last"])


def forward(params: Params, x: torch.Tensor, product, num_layers: int,
            bn: bool, precision: str = "f32") -> torch.Tensor:
    """Logits ``[N, C]`` of every node; ``product(h)`` is ``A @ h``."""
    outs = []
    h = x
    names = conv_names(num_layers)
    for i, name in enumerate(names):
        y = matmul(product(h), params[f"{name}.weight"], precision)
        y = F.normalize(y + params[f"{name}.bias"], p=2, dim=-1)
        if i < len(names) - 1:
            y = torch.relu(y)
            if bn:
                y = _bn(y)
        outs.append(y)
        h = y
    emb = torch.cat(outs, dim=-1)
    return (matmul(emb, params["pred_model.pred.weight"].t(), precision)
            + params["pred_model.pred.bias"])


def split_nodes(num_nodes: int, train_ratio: float, seed: int):
    """The node split of a training job from its seed: a shuffle of the
    node ids by ``numpy.random.default_rng(seed)``, the first
    ``int(num_nodes * train_ratio)`` for training (the program's stated
    split, ``train/loop.py:split_nodes``)."""
    import numpy as np

    idx = np.arange(num_nodes)
    np.random.default_rng(seed).shuffle(idx)
    k = int(num_nodes * train_ratio)
    return idx[:k], idx[k:]


class Adam:
    """Clip by global norm, coupled decay, then Adam (torch's formula:
    ``m``, ``v`` by lerp and addcmul, bias corrections in float64)."""

    def __init__(self, params: Params, lr: float, weight_decay: float,
                 clip: Optional[float], betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.wd, self.clip = lr, weight_decay, clip
        self.b1, self.b2 = betas
        self.eps = eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def effective_grads(self, params: Params, grads: Params) -> Params:
        """The gradients as Adam receives them: clipped, plus the decay."""
        out = dict(grads)
        if self.clip:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            if float(norm) >= self.clip:
                out = {k: g / norm * self.clip for k, g in grads.items()}
        if self.wd:
            out = {k: g + self.wd * params[k] for k, g in out.items()}
        return out

    @torch.no_grad()
    def step(self, params: Params, grads: Params) -> Params:
        """Updates ``params`` in place; returns the effective gradients."""
        eff = self.effective_grads(params, grads)
        self.t += 1
        bc1 = 1 - self.b1 ** self.t
        bc2 = 1 - self.b2 ** self.t
        for k, g in eff.items():
            self.m[k].lerp_(g, 1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k].sqrt() / math.sqrt(bc2)).add_(self.eps)
            params[k].addcdiv_(self.m[k], denom, value=-self.lr / bc1)
        return eff


def train_job(params: Params, x: torch.Tensor, product, labels: torch.Tensor,
              train_idx: torch.Tensor, *, num_layers: int, bn: bool, lr: float,
              weight_decay: float, clip: Optional[float], epochs: int,
              snapshot: int, precision: str = "f32",
              loss_rows: Optional[torch.Tensor] = None,
              freeze_after: Optional[int] = None) -> Dict:
    """A training job of ``epochs`` full-batch steps from ``params``
    (copied).  Returns the loss of every step's forward (before its
    update), the first step's effective gradient, the parameters and the
    logits after ``snapshot`` steps and after the last.

    Planted faults, for the check's calibration: ``loss_rows`` replaces
    ``train_idx`` in the loss (a part of the batch left out);
    ``freeze_after`` leaves the state unchanged from that step on."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    opt = Adam(p, lr, weight_decay, clip)
    rows = train_idx if loss_rows is None else loss_rows

    def outputs():
        with torch.no_grad():
            logits = forward(p, x, product, num_layers, bn, precision)
        return {k: v.detach().clone() for k, v in p.items()}, logits

    losses, first_grad, at_snapshot = [], None, None
    for step in range(epochs):
        if step == snapshot:
            at_snapshot = outputs()
        if freeze_after is not None and step >= freeze_after:
            # the state no longer moves, so neither does the loss
            if step == freeze_after:
                with torch.no_grad():
                    logits = forward(p, x, product, num_layers, bn, precision)
                    frozen = float(F.cross_entropy(logits[rows], labels[rows]))
            losses.append(frozen)
            continue
        logits = forward(p, x, product, num_layers, bn, precision)
        loss = F.cross_entropy(logits[rows], labels[rows])
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        eff = opt.step(p, dict(zip(p.keys(), grads)))
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in eff.items()}
    final = outputs()
    if at_snapshot is None:
        at_snapshot = final
    return {"losses": losses, "first_grad": first_grad,
            "snapshot_params": at_snapshot[0], "snapshot_logits": at_snapshot[1],
            "params": final[0], "logits": final[1]}
