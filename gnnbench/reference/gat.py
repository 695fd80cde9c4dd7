"""Plain float32 reference of a GAT node classifier and of a whole
full-batch training job with it.  Plain torch only: it imports no JAX, no
``tpugraph`` and nothing of ``tpugraph_torch``.

Model: GAT (Velickovic et al., *Graph Attention Networks*, ICLR 2018,
arXiv:1710.10903) as DGL's ogbn-arxiv example builds it
(https://github.com/dmlc/dgl/blob/master/examples/pytorch/ogb/ogbn-arxiv/gat.py).
For layer ``l``, head ``h`` and receiver ``i`` over ``N(i)``, its
in-edges, which include one self-loop:

* ``z_j^h = (x_j W)^h``, ``e_ij^h = LeakyReLU_slope(a_l^h . z_j^h + a_r^h . z_i^h)``,
  ``alpha_ij^h = softmax_j e_ij^h``;
* hidden layers: ``y_i = ||_h sum_j alpha_ij^h z_j^h + x_i W_res``, then
  ``BatchNorm1d`` over the ``H F`` features (batch statistics while
  training, running statistics with momentum 0.1 for evaluation) and ReLU;
* the last layer: ``y_i = mean_h (sum_j alpha_ij^h z_j^h + (x_i W_res)^h) + b``.

``A[r, s]`` is edge ``s -> r``.  Each head's weighted sum is torch's
sparse CSR product (cuSPARSE on the card) with ``alpha`` as the values;
its backward is the transposed CSR's product and, for ``alpha``, the dot
``<g_r, z_s>`` on each edge (gathered rows, in slices of edges).
The softmax is plain torch over the edge list (``scatter_reduce`` for the
maxima, ``index_add`` for the sums).  Departures from DGL's example, each
also in the configuration's ``assumed``:

* no dropout of any kind (the example: input 0.1, hidden 0.75; attention
  and edge dropout 0), so the program and the reference compute the same
  arithmetic;
* the loss is the plain mean cross-entropy over the training nodes (the
  example's is ``log(eps + CE) - log eps``, ``eps = 1 - ln 2``), and the
  learning rate is constant (the example warms up and decays on plateau);
* no symmetric-degree normalisation and no label inputs (the example's
  ``--use-norm``, ``--use-labels``, off by default);
* the optimizer is the program's chain, optax's order: clip by the global
  norm (when ``clip``), the coupled decay ``g + weight_decay * w``, then
  Adam with torch's formula.

``precision="tf32"`` rounds both operands of every dense matrix product
(forward and backward) to TF32 (10 mantissa bits, round to nearest even)
and accumulates in float32: what cuBLAS computes with TF32 allowed, a
precision below float32.  The sparse products stay float32.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, Optional

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


def with_self_loops(senders: torch.Tensor, receivers: torch.Tensor, num_nodes: int):
    """The edges GAT attends over: ``senders -> receivers`` without their
    self-loops, then one self-loop a node (DGL's
    ``remove_self_loop().add_self_loop()``); int64."""
    keep = senders != receivers
    loops = torch.arange(num_nodes, device=senders.device)
    return (torch.cat([senders[keep].long(), loops]),
            torch.cat([receivers[keep].long(), loops]))


def structure(senders: torch.Tensor, receivers: torch.Tensor, num_nodes: int) -> Dict:
    """The edge list and its CSR layouts: ``perm`` orders the edges by
    (receiver, sender), the rows of ``A``; ``perm_t`` by (sender,
    receiver), the rows of ``A^T``."""
    s, r, n = senders.long(), receivers.long(), int(num_nodes)
    out = {"s": s, "r": r, "n": n}
    for tag, rows, cols in (("", r, s), ("_t", s, r)):
        perm = torch.sort(rows * n + cols, stable=True).indices
        counts = torch.bincount(rows, minlength=n)
        crow = torch.zeros(n + 1, dtype=torch.int64, device=s.device)
        crow[1:] = torch.cumsum(counts, 0)
        out.update({"perm" + tag: perm, "crow" + tag: crow, "col" + tag: cols[perm]})
    return out


def _csr(st: Dict, tag: str, values: torch.Tensor) -> torch.Tensor:
    n = st["n"]
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(st["crow" + tag], st["col" + tag],
                                       values[st["perm" + tag]], (n, n))


class _Attend(torch.autograd.Function):
    """``y_h = A(alpha_h) @ z_h`` for each head ``h``, ``A[r_e, s_e] =
    alpha[e, h]``: one CSR product a head; backward ``A(alpha_h)^T @ g_h``
    and ``d alpha[e, h] = <g_h[r_e], z_h[s_e]>`` (gathered and multiplied a
    slice of ``_EDGE_CHUNK`` edges at a time)."""

    @staticmethod
    def forward(ctx, alpha, z, st, heads):
        ctx.st, ctx.heads = st, heads
        ctx.save_for_backward(alpha, z)
        zh = z.view(st["n"], heads, -1)
        return torch.cat([_csr(st, "", alpha[:, h].contiguous()) @ zh[:, h].contiguous()
                          for h in range(heads)], dim=1)

    @staticmethod
    def backward(ctx, g):
        alpha, z = ctx.saved_tensors
        st, heads, n = ctx.st, ctx.heads, ctx.st["n"]
        gh = g.contiguous().view(n, heads, -1)
        dz = torch.cat([_csr(st, "_t", alpha[:, h].contiguous()) @ gh[:, h].contiguous()
                        for h in range(heads)], dim=1)
        zh = z.view(n, heads, -1)
        da = torch.empty_like(alpha)
        for lo in range(0, alpha.shape[0], _EDGE_CHUNK):
            hi = min(lo + _EDGE_CHUNK, alpha.shape[0])
            da[lo:hi] = torch.sum(gh[st["r"][lo:hi]] * zh[st["s"][lo:hi]], dim=-1)
        return da, dz, None, None


_EDGE_CHUNK = 1 << 18


def attention(z: torch.Tensor, el: torch.Tensor, er: torch.Tensor, st: Dict,
              heads: int, slope: float) -> torch.Tensor:
    """``[N, H F]``: for each head the softmax over each receiver's
    in-edges of ``LeakyReLU(el_s + er_r)``, and the weighted sum of the
    senders' ``z``."""
    s, r, n = st["s"], st["r"], st["n"]
    e = F.leaky_relu(el[s] + er[r], slope)
    m = e.new_full((n, heads), -torch.inf).scatter_reduce(
        0, r[:, None].expand(-1, heads), e.detach(), "amax", include_self=True)
    p = torch.exp(e - m[r])
    alpha = p / p.new_zeros((n, heads)).index_add(0, r, p)[r]
    return _Attend.apply(alpha, z.contiguous(), st, heads)


def forward(params: Params, buffers: Params, x: torch.Tensor, st: Dict, *,
            num_layers: int, num_heads: int, slope: float, training: bool,
            precision: str = "f32") -> torch.Tensor:
    """Logits ``[N, C]`` of every node.  ``params`` and ``buffers`` are named
    as the program's ``state_dict`` (``convs.<i>.weight [in, H F]``,
    ``.res_weight``, ``.attn_l``/``.attn_r [H, F]``, ``norms.<i>.weight``,
    ``.bias``, ``bias``; ``norms.<i>.running_mean``, ``.running_var``,
    ``.num_batches_tracked``); while ``training`` the batch norm updates
    the running statistics in ``buffers``."""
    n = x.shape[0]
    h = x
    for i in range(num_layers):
        pre = f"convs.{i}."
        z = matmul(h, params[pre + "weight"], precision)
        zh = z.view(n, num_heads, -1)
        el = torch.sum(zh * params[pre + "attn_l"], dim=-1)
        er = torch.sum(zh * params[pre + "attn_r"], dim=-1)
        y = attention(z, el, er, st, num_heads, slope) + matmul(
            h, params[pre + "res_weight"], precision)
        if i < num_layers - 1:
            nm = f"norms.{i}."
            y = F.batch_norm(y, buffers[nm + "running_mean"], buffers[nm + "running_var"],
                             params[nm + "weight"], params[nm + "bias"],
                             training=training, momentum=0.1, eps=1e-5)
            if training:
                buffers[nm + "num_batches_tracked"] += 1
            y = torch.relu(y)
        h = y
    return h.view(n, num_heads, -1).mean(1) + params["bias"]


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


def train_job(state: Params, x: torch.Tensor, st: Dict, labels: torch.Tensor,
              train_idx: torch.Tensor, *, num_layers: int, num_heads: int, slope: float,
              lr: float, weight_decay: float, clip: Optional[float], epochs: int,
              snapshot: int, precision: str = "f32",
              loss_rows: Optional[torch.Tensor] = None,
              freeze_after: Optional[int] = None) -> Dict:
    """A training job of ``epochs`` full-batch steps from ``state`` (a
    ``state_dict``, copied: the floating-point entries that are not batch
    norm statistics train).  Returns the loss of every step's forward
    (before its update), the first step's effective gradient, and the
    parameters and the evaluation logits (running statistics) after
    ``snapshot`` steps and after the last.

    Planted faults, for the check's calibration: ``loss_rows`` replaces
    ``train_idx`` in the loss (a part of the batch left out);
    ``freeze_after`` leaves the state unchanged from that step on."""
    stats = ("running_mean", "running_var", "num_batches_tracked")
    p = {k: v.detach().clone().requires_grad_(True) for k, v in state.items()
         if not k.endswith(stats)}
    b = {k: v.detach().clone() for k, v in state.items() if k.endswith(stats)}
    opt = Adam(p, lr, weight_decay, clip)
    rows = train_idx if loss_rows is None else loss_rows
    kw = dict(num_layers=num_layers, num_heads=num_heads, slope=slope,
              precision=precision)

    def outputs():
        with torch.no_grad():
            logits = forward(p, b, x, st, training=False, **kw)
        return {k: v.detach().clone() for k, v in p.items()}, logits

    losses, first_grad, at_snapshot, frozen = [], None, None, None
    for step in range(epochs):
        if step == snapshot:
            at_snapshot = outputs()
        if freeze_after is not None and step >= freeze_after:
            # the state no longer moves, so neither does the loss
            if frozen is None:
                with torch.no_grad():
                    logits = forward(p, {k: v.clone() for k, v in b.items()}, x, st,
                                     training=True, **kw)
                    frozen = float(F.cross_entropy(logits[rows], labels[rows]))
            losses.append(frozen)
            continue
        logits = forward(p, b, x, st, training=True, **kw)
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
