"""Plain float32 reference of a DeeperGCN node classifier and of a whole
full-batch training job with it.  Plain torch only: it imports no JAX, no
``tpugraph`` and nothing of ``tpugraph_torch``.

Model: DeeperGCN (Li, Xiong, Thabet, Ghanem, *DeeperGCN: All You Need to
Train Deeper GCNs*, arXiv:2006.07739) as the authors' ogbn-arxiv example
builds it
(https://github.com/lightaime/deep_gcns_torch/tree/master/examples/ogb/ogbn_arxiv,
``--self_loop --num_layers 28 --block res+ --gcn_aggr softmax_sg --t
0.1``).  For ``L`` layers, ``N(v)`` the in-edges of ``v`` (one self-loop
among them) and ``eps = 1e-7``::

    h^0     = x W_in + b_in
    h^1     = GEN_0(h^0)
    h^{l+1} = GEN_l(ReLU(BN_{l-1}(h^l))) + h^l          l = 1 .. L-1
    logits  = ReLU(BN_{L-1}(h^L)) W_out + b_out
    GEN(x): mu_u = ReLU(x_u) + eps
            w_uv,c = softmax over u in N(v) of t mu_u,c  (per receiver and
                     channel, under no_grad: "softmax_sg")
            m_v,c = sum_u w_uv,c mu_u,c
            GEN(x) = (x + m) W + b

``BN`` is ``BatchNorm1d`` over the channels (batch statistics while
training, running statistics with momentum 0.1 for evaluation).

The aggregation comes in two forms, exact in real arithmetic:

* :func:`aggregate_literal` — the published ``scatter_softmax`` per
  (receiver, channel), each group's maximum subtracted, the weights under
  ``no_grad``; it holds an edges x channels tensor, so the CPU tests use it
  at small sizes;
* :func:`aggregate` — the card's: ``m = (A (e mu)) / (A e)`` with ``e =
  exp(t mu - S_c)`` detached and ``S_c`` each channel's maximum over the
  nodes, two sparse CSR products (cuSPARSE on the card) a layer, taken in
  float64 (float32 in and out).  A shift shared by the nodes leaves a row
  whose senders all lie far below the channel's maximum with weights under
  float32's range (``exp(-87)`` is its least normal number); in float64 a
  weight keeps its digits down to ``exp(-708)``, so every layer checks
  ``|t| (max_c - min_c) < 600`` (the smallest ``e mu`` then stays a normal
  float64 number) and raises rather than answer wrongly.  In training the
  batch norm bounds each input channel (``|BN(h)| <= gamma sqrt(N - 1) +
  |beta|``), well inside that.  The evaluation's forward, without
  gradient, takes the literal form: at the ogbn-arxiv stand-in's widths
  the running statistics after 3 steps have not settled, and a channel's
  ``t mu`` there spans 70 to 950, beyond one shared shift.

Departures from the example, each also in the configuration's ``assumed``:

* no dropout (the example: 0.5 after every block's ReLU and before the
  head), so the program and the reference compute the same arithmetic;
* the loss is the mean cross-entropy over the training nodes, the same
  function as the example's ``log_softmax`` and ``nll_loss``;
* the optimizer is the program's chain, optax's order: clip by the global
  norm (when ``clip``), the coupled decay ``g + weight_decay * w``, then
  Adam with torch's formula (the example: Adam, lr 0.01, no decay, no
  clipping).

``precision="tf32"`` rounds both operands of every dense matrix product
(forward and backward) to TF32 (10 mantissa bits, round to nearest even)
and accumulates in float32: what cuBLAS computes with TF32 allowed, a
precision below float32.  The sparse products stay float64.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, Optional

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

Params = Dict[str, torch.Tensor]

# the largest |t| (max - min) of a channel's t mu over the nodes that the
# card's form takes: its smallest product exp(-600) mu, mu >= eps, stays a
# normal float64 number
SPREAD_LIMIT = 600.0


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
    """The edges the model aggregates over: ``senders -> receivers``
    without their self-loops, then one self-loop a node (``--self_loop``);
    int64."""
    keep = senders != receivers
    loops = torch.arange(num_nodes, device=senders.device)
    return (torch.cat([senders[keep].long(), loops]),
            torch.cat([receivers[keep].long(), loops]))


def structure(senders: torch.Tensor, receivers: torch.Tensor, num_nodes: int) -> Dict:
    """The edge list and the float64 CSR tensors of ``A`` (rows receivers)
    and of ``A^T`` (rows senders), every weight 1."""
    s, r, n = senders.long(), receivers.long(), int(num_nodes)
    out = {"s": s, "r": r, "n": n}
    for tag, rows, cols in (("a", r, s), ("a_t", s, r)):
        perm = torch.sort(rows * n + cols, stable=True).indices
        crow = torch.zeros(n + 1, dtype=torch.int64, device=s.device)
        crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            out[tag] = torch.sparse_csr_tensor(
                crow, cols[perm], torch.ones(s.shape[0], dtype=torch.float64,
                                             device=s.device), (n, n))
    return out


class _Product(torch.autograd.Function):
    """``A @ v`` by the CSR of ``A``; backward ``A^T @ g`` by that of
    ``A^T``; float64."""

    @staticmethod
    def forward(ctx, v, st):
        ctx.st = st
        return st["a"] @ v

    @staticmethod
    def backward(ctx, g):
        return ctx.st["a_t"] @ g.contiguous(), None


def aggregate_literal(x: torch.Tensor, st: Dict, t: float, eps: float) -> torch.Tensor:
    """``m [N, D]``, the published aggregation: each edge's message ``mu_u
    = ReLU(x_u) + eps``, the softmax of ``t mu`` over each receiver's
    in-edges channel by channel (its maximum subtracted) under
    ``no_grad``, and the weighted sum of the messages."""
    s, r, n = st["s"], st["r"], st["n"]
    msg = (torch.relu(x) + eps)[s]
    with torch.no_grad():
        sc = t * msg
        idx = r[:, None].expand_as(sc)
        mx = sc.new_full((n, sc.shape[1]), -torch.inf).scatter_reduce(
            0, idx, sc, "amax", include_self=True)
        p = torch.exp(sc - mx[r])
        w = p / p.new_zeros((n, sc.shape[1])).index_add(0, r, p)[r]
    return msg.new_zeros((n, msg.shape[1])).index_add(0, r, w * msg)


def aggregate(x: torch.Tensor, st: Dict, t: float, eps: float) -> torch.Tensor:
    """``m [N, D]`` as ``(A (e mu)) / (A e)``, ``e = exp(t mu - S)`` under
    no gradient with ``S`` each channel's maximum of ``t mu`` over the
    nodes: the same function as :func:`aggregate_literal` (a receiver's
    weights share their shift), in two sparse products taken in float64
    and rounded once to ``x``'s dtype.  Raises where a channel's ``t mu``
    spans ``SPREAD_LIMIT`` or more."""
    mu = (torch.relu(x) + eps).double()
    with torch.no_grad():
        sc = t * mu
        top, low = sc.amax(0), sc.amin(0)
        spread = float((top - low).max())
        if not spread < SPREAD_LIMIT:
            raise RuntimeError(f"a channel's t mu spans {spread:.4g} >= {SPREAD_LIMIT}: "
                               "its smallest softmax weights would underflow")
        e = torch.exp(sc - top)
    m = _Product.apply(e * mu, st) / _Product.apply(e, st)
    return m.to(x.dtype)


def forward(params: Params, buffers: Params, x: torch.Tensor, st: Dict, *,
            num_layers: int, t: float, eps: float, training: bool,
            precision: str = "f32", literal: bool = False) -> torch.Tensor:
    """Logits ``[N, C]`` of every node.  ``params`` and ``buffers`` are named
    as the program's ``state_dict`` (``node_features_encoder.weight [H,
    D]``, ``.bias``; ``gcns.<i>.weight [H, H]`` (in, out), ``.bias``;
    ``norms.<i>.weight``, ``.bias``; ``node_pred_linear.weight [C, H]``,
    ``.bias``; ``norms.<i>.running_mean``, ``.running_var``,
    ``.num_batches_tracked``); while ``training`` the batch norm updates
    the running statistics in ``buffers``.  ``literal`` takes
    :func:`aggregate_literal` in place of :func:`aggregate`."""
    agg = aggregate_literal if literal else aggregate

    def norm(h, i):
        nm = f"norms.{i}."
        out = F.batch_norm(h, buffers[nm + "running_mean"], buffers[nm + "running_var"],
                           params[nm + "weight"], params[nm + "bias"], training=training,
                           momentum=0.1, eps=1e-5)
        if training:
            buffers[nm + "num_batches_tracked"] += 1
        return torch.relu(out)

    def gen(h, i):
        pre = f"gcns.{i}."
        return matmul(h + agg(h, st, t, eps), params[pre + "weight"], precision) \
            + params[pre + "bias"]

    h = matmul(x, params["node_features_encoder.weight"].t(), precision) \
        + params["node_features_encoder.bias"]
    h = gen(h, 0)
    for i in range(1, num_layers):
        h = gen(norm(h, i - 1), i) + h
    h = norm(h, num_layers - 1)
    return matmul(h, params["node_pred_linear.weight"].t(), precision) \
        + params["node_pred_linear.bias"]


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
              train_idx: torch.Tensor, *, num_layers: int, t: float, eps: float,
              lr: float, weight_decay: float, clip: Optional[float], epochs: int,
              snapshot: int, precision: str = "f32", literal: bool = False,
              loss_rows: Optional[torch.Tensor] = None,
              freeze_after: Optional[int] = None) -> Dict:
    """A training job of ``epochs`` full-batch steps from ``state`` (a
    ``state_dict``, copied: the floating-point entries that are not batch
    norm statistics train).  Returns the loss of every step's forward
    (before its update), the first step's effective gradient, and the
    parameters and the evaluation logits (running statistics) after
    ``snapshot`` steps and after the last.

    The evaluation's forwards take :func:`aggregate_literal`, whatever
    ``literal`` says for the training steps.

    Planted faults, for the check's calibration: ``loss_rows`` replaces
    ``train_idx`` in the loss (a part of the batch left out);
    ``freeze_after`` leaves the state unchanged from that step on."""
    stats = ("running_mean", "running_var", "num_batches_tracked")
    p = {k: v.detach().clone().requires_grad_(True) for k, v in state.items()
         if not k.endswith(stats)}
    b = {k: v.detach().clone() for k, v in state.items() if k.endswith(stats)}
    opt = Adam(p, lr, weight_decay, clip)
    rows = train_idx if loss_rows is None else loss_rows
    kw = dict(num_layers=num_layers, t=t, eps=eps, precision=precision, literal=literal)

    def outputs():
        # the literal form: running statistics that have not settled let a
        # channel's t mu span more than one shared shift holds
        with torch.no_grad():
            logits = forward(p, b, x, st, training=False, **dict(kw, literal=True))
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
