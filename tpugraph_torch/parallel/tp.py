"""Port of ``tpugraph/parallel/tp.py``: tensor parallelism, the weights of
the node encoder sharded on their output (column) dimension over a
``model`` axis.

``tpugraph`` annotates the shardings and lets XLA's SPMD partitioner
place the collectives.  Here the partitioning is written out, with the
same result (the loss, gradient and update of one device, the weights
still sharded after the step):

* :func:`tp_shardings` — ``tpugraph``'s rule, per named parameter: a 2-D
  weight splits its output dimension when ``n`` divides it, a 1-D one
  when ``n`` divides its length and the length is at least ``n``, and the
  rest (the small label heads) stay whole.  ``GraphConv``'s weights are
  ``[in, out]`` (output dimension 1, as flax's kernels); ``nn.Linear``'s
  are ``[out, in]`` (output dimension 0);
* :func:`shard_params_tp` — each rank keeps column block ``r`` of every
  split parameter (``NamedSharding(P(None, "model"))``'s layout), marked
  with the dimension it split (``param.tp_dim``);
* :func:`make_tp_node_train_step` — the full-batch node step over a COO
  ``SparseAdj``.  A split product computes only this rank's ``[N,
  out/n]`` block, and the COO aggregation, the self term and the bias run
  on that block (all are column-independent).  The blocks are joined by
  :func:`~tpugraph_torch.parallel.collectives.all_gather_cols`, and what
  follows runs replicated, so its gradient is the same on every rank and
  the join's backward keeps this rank's columns of it.  The replicated
  inputs of a split product (the layer input, the edge weights) go
  through :func:`~tpugraph_torch.parallel.collectives.copy_to_shards`,
  whose backward sums the ranks' partial gradients.  The optimizer steps
  elementwise on each shard; a global-norm clip sums the squared norms
  of the split parameters over the ranks and counts the whole ones once.

No flag of the CLI reaches this module, as in ``tpugraph``.  The step
runs the model deterministically (no dropout), as ``model.apply``
without an rng does there.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tpugraph_torch.core.graph import Graph
from tpugraph_torch.nn.encoders import GcnEncoderNode
from tpugraph_torch.nn.layers import (GraphConv, SparseAdj, fresh_batch_norm,
                                      normalize_embedding)
from tpugraph_torch.nn.losses import node_cross_entropy
from tpugraph_torch.ops.message import sddmm, spmm
from tpugraph_torch.parallel.collectives import (all_gather_cols, all_reduce_,
                                                 copy_to_shards)
from tpugraph_torch.parallel.mesh import Mesh, group_mesh
from tpugraph_torch.train.optim import ClippedOptimizer, build_optimizer


def _axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[mesh.axis_names.index(axis)]


def tp_shardings(model: nn.Module, mesh: Mesh,
                 axis: str = "model") -> Dict[str, Optional[int]]:
    """Every named parameter of ``model`` -> the dimension split over
    ``axis``, or ``None`` for a replicated one
    (``tpugraph/parallel/tp.py:25``)."""
    n = _axis_size(mesh, axis)
    specs: Dict[str, Optional[int]] = {}
    for mod_name, mod in model.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            out_dim = 0 if isinstance(mod, nn.Linear) else p.dim() - 1
            size = p.shape[out_dim] if p.dim() else 0
            split = (p.dim() == 2 and size % n == 0) or (
                p.dim() == 1 and size % n == 0 and size >= n)
            specs[f"{mod_name}.{name}" if mod_name else name] = (
                out_dim if split else None)
    return specs


def shard_params_tp(model: nn.Module, mesh: Mesh,
                    axis: str = "model") -> Dict[str, Optional[int]]:
    """Keep this rank's block of every parameter :func:`tp_shardings`
    splits, in place (``tpugraph/parallel/tp.py:46``); every parameter
    gets ``tp_dim``, the dimension split or ``None``.  Build the optimizer
    after this call.  Returns the specs."""
    specs = tp_shardings(model, mesh, axis)
    n, r = _axis_size(mesh, axis), mesh.rank
    with torch.no_grad():
        for name, p in model.named_parameters():
            dim = specs[name]
            if dim is not None:
                size = p.shape[dim] // n
                p.data = p.data.narrow(dim, r * size, size).clone()
            p.tp_dim = dim
    return specs


def gather_params_tp(model: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The whole parameters on the CPU, the split ones joined from every
    rank's block; the ranks of ``mesh`` call it together."""
    out = {}
    for name, p in model.named_parameters():
        t = p.detach()
        if _split(p):
            parts = [torch.empty_like(t) for _ in range(mesh.size)]
            dist.all_gather(parts, t.contiguous(), group=mesh.group)
            t = torch.cat(parts, dim=p.tp_dim)
        out[name] = t.cpu()
    return out


def _split(p: Optional[torch.Tensor]) -> bool:
    return p is not None and getattr(p, "tp_dim", None) is not None


def _product(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """``x @ w`` for a ``[in, out]`` weight, whole on every rank."""
    if not _split(w):
        return torch.matmul(x, w)
    return all_gather_cols(torch.matmul(copy_to_shards(x, group), w), group)


def _linear(lin: nn.Linear, x: torch.Tensor, group) -> torch.Tensor:
    """``lin(x)`` whole on every rank; a split ``lin`` computes its block
    of output features, then joins them."""
    if not _split(lin.weight):
        return lin(x)
    return all_gather_cols(
        nn.functional.linear(copy_to_shards(x, group), lin.weight, lin.bias),
        group)


def _conv(conv: GraphConv, x: torch.Tensor, adj: SparseAdj,
          group) -> torch.Tensor:
    """``GraphConv`` on a COO adjacency with its weights as
    :func:`shard_params_tp` left them; the output is whole."""
    weight = adj.weight
    if conv.att:
        x_att = _product(x, conv.att_weight, group)
        weight = weight * sddmm(adj.senders, adj.receivers, x_att, x_att)
    if not _split(conv.weight):
        y = torch.matmul(spmm(adj.senders, adj.receivers, weight, x), conv.weight)
        if conv.add_self:
            y = y + torch.matmul(x, conv.self_weight)
        if conv.bias is not None:
            y = y + conv.bias
    else:
        xs = copy_to_shards(x, group)
        y = spmm(adj.senders, adj.receivers, copy_to_shards(weight, group),
                 torch.matmul(xs, conv.weight))
        if conv.add_self:
            y = y + torch.matmul(xs, conv.self_weight)
        if conv.bias is not None:
            y = y + conv.bias
        y = all_gather_cols(y, group)
    if conv.normalize_embedding:
        y = normalize_embedding(y)
    return y


def tp_forward(model: GcnEncoderNode, x: torch.Tensor, adj: SparseAdj,
               mesh: Mesh) -> torch.Tensor:
    """``model(x, adj)[0]`` (the logits ``[N, C]``, whole on every rank)
    with the parameters :func:`shard_params_tp` split; the ranks of
    ``mesh`` call it together."""
    group, stack = mesh.group, model.stack
    x_all = []
    h = x
    for conv in [stack.conv_first, *stack.conv_block]:
        h = torch.relu(_conv(conv, h, adj, group))
        if stack.bn:
            h = fresh_batch_norm(h)
        x_all.append(h)
    h = _conv(stack.conv_last, h, adj, group)
    x_all.append(h)
    emb = torch.cat(x_all, dim=-1) if stack.concat else h
    for lin in model.pred_model.pred_hidden:
        emb = torch.relu(_linear(lin, emb, group))
    return _linear(model.pred_model.pred, emb, group)


def _sq_norm(mesh: Mesh) -> Callable:
    """The squared global norm of gradients of split and whole
    parameters: the split ones' sums added over the ranks."""

    def sq_norm(params, grads):
        parts = [torch.sum(g * g) for g in grads]
        split = sum((s for p, s in zip(params, parts) if _split(p)),
                    torch.zeros((), device=grads[0].device))
        whole = sum((s for p, s in zip(params, parts) if not _split(p)),
                    torch.zeros((), device=grads[0].device))
        return all_reduce_(split, mesh.group) + whole

    return sq_norm


def make_tp_node_train_step(model: GcnEncoderNode, opt, mesh: Mesh,
                            axis: str = "model",
                            class_weight: Optional[torch.Tensor] = None):
    """The full-batch node-classification step with tensor-parallel
    weights (``tpugraph/parallel/tp.py:54``): ``step(senders, receivers,
    weights, x, y, mask) -> loss``, every argument whole on every rank of
    ``mesh``.  Shard ``model`` with :func:`shard_params_tp` first and build
    ``opt`` (a ``torch.optim`` optimizer or
    :class:`~tpugraph_torch.train.optim.ClippedOptimizer`) over its
    parameters after that; a clipping chain gets the global norm over the
    shards."""
    if _axis_size(mesh, axis) != mesh.size:
        raise ValueError(f"the {axis!r} axis must span the mesh, shape "
                         f"{mesh.shape}")
    if isinstance(opt, ClippedOptimizer):
        opt.grad_sq_norm = _sq_norm(mesh)

    def step(senders, receivers, weights, x, y, mask) -> torch.Tensor:
        opt.zero_grad()
        logits = tp_forward(model, x, SparseAdj(senders, receivers, weights), mesh)
        loss = node_cross_entropy(logits, y, class_weight=class_weight,
                                  node_mask=mask)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def tp_fit(mesh: Optional[Mesh], model: GcnEncoderNode, g: Graph, x: np.ndarray,
           y: np.ndarray, mask: np.ndarray, steps: int, opt_cfg,
           axis: str = "model") -> Dict[str, Any]:
    """``steps`` updates of :func:`make_tp_node_train_step` of a copy of
    ``model``, sharded by :func:`shard_params_tp` (``opt_cfg`` an
    :class:`~tpugraph_torch.train.optim.OptimizerConfig`), on the whole
    graph and arrays: ``{"losses", "logits0"`` (the forward before the
    first step), ``"params"`` (:func:`gather_params_tp` after the last),
    ``"shard_shapes"`` (this rank's)``}``."""
    mesh = mesh or group_mesh(axis)
    dev = mesh.device
    model = copy.deepcopy(model).to(dev)
    shard_params_tp(model, mesh, axis)
    opt = build_optimizer(model.parameters(), opt_cfg)
    step = make_tp_node_train_step(model, opt, mesh, axis)
    s, r, w = (t.to(dev) for t in (g.senders.long(), g.receivers.long(),
                                   g.edge_weight))
    xt, yt, mt = (torch.from_numpy(np.asarray(a)).to(dev) for a in (x, y, mask))
    with torch.no_grad():
        logits0 = tp_forward(model, xt, SparseAdj(s, r, w), mesh).cpu().numpy()
    losses = [float(step(s, r, w, xt, yt, mt)) for _ in range(steps)]
    return {"losses": losses, "logits0": logits0,
            "params": gather_params_tp(model, mesh),
            "shard_shapes": {k: tuple(p.shape) for k, p in model.named_parameters()}}
