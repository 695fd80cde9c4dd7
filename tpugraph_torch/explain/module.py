"""Port of ``tpugraph/explain/module.py``: GNNExplainer mask optimization on
the COO edge list.

The mask lives on undirected edges: one logit per edge pair, read by both
directed copies, so the masked adjacency is symmetric by construction.
Loss = pred + size + lap + ent + feat_size with the reference's
coefficients; ``feat_ent`` is computed but not added, and the prediction
term reads the query's ground-truth label, as in the JAX module.  JAX's
``unconstrained`` option (unit base weights, no feature mask), which no
caller of ``tpugraph`` sets, is not ported.

The JAX module ``vmap``s one query's ``lax.scan`` of Adam steps over the
queries.  Here the query axis is written out: every state tensor has a
leading axis of Q queries, and one forward runs the frozen model on Q
disjoint copies of the graph (node ids offset by ``q * N_pad``, the
edge weights ``[Q * E_pad]``, each copy's features under its own
feature gate).  Adam is elementwise and the copies share no node, so
each query's step on the summed loss equals its step run alone.

``graph_mode`` explains whole-graph predictions: the loss reads the
softmax of the graph logits and has no Laplacian term
(``tpugraph/explain/module.py:175-178, 235-236``), and the Q queries may
be Q different graphs (a :class:`~tpugraph_torch.core.graph.BatchedGraphs`
of one edge budget, with features ``[Q, N_pad, D]``), run as Q disjoint
graphs in one forward of the graph classifier.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tpugraph_torch.core.graph import BatchedGraphs, Graph
from tpugraph_torch.nn.layers import SparseAdj


class ExplainConfig(NamedTuple):
    """Mask-optimization hyperparameters (``tpugraph/explain/module.py:38``;
    the reference's defaults).  The tile-space explainer reads the epochs,
    rate, activations, coefficients and ``mask_features``."""

    num_epochs: int = 100
    lr: float = 0.1
    mask_act: str = "sigmoid"   # sigmoid | ReLU | none
    mask_bias: bool = False
    use_sigmoid: bool = True
    coeff_size: float = 0.005
    coeff_feat_size: float = 1.0
    coeff_ent: float = 1.0
    coeff_feat_ent: float = 0.1  # computed, not added — reference parity
    coeff_lap: float = 1.0
    mask_features: bool = True
    marginalize: bool = False    # noise-marginalized feature masking
    seed_ensemble: int = 1       # >1: average masks over several init seeds
    log_mask_every: int = 0      # >0: record the masked weights every epoch


class MaskState(NamedTuple):
    """Learnable explainer parameters of Q queries."""

    edge_logits: torch.Tensor                   # float32[Q, P_pad]
    feat_logits: torch.Tensor                   # float32[Q, D]
    bias_logits: Optional[torch.Tensor] = None  # float32[Q, P_pad] if mask_bias


def init_masks(
    generator: torch.Generator,
    num_pairs: int,
    feat_dim: int,
    num_sub_nodes: torch.Tensor,
    cfg: ExplainConfig,
) -> MaskState:
    """Reference init (``tpugraph/explain/module.py:68``): edge mask
    N(1, sqrt(2) * sqrt(2 / 2n)) for a neighborhood of n nodes, feature
    mask 0.  One N(0, 1) draw of ``num_pairs`` from ``generator`` is
    scaled by each query's std, so a query's init does not depend on the
    others in its batch (JAX draws from a key per query; its keys cannot
    be replayed, so tests hand both sides one init).  The draw runs on the
    generator's device and moves to ``num_sub_nodes``'s: a CPU generator
    gives the card and the CPU the same init."""
    device = num_sub_nodes.device
    n = torch.clamp(num_sub_nodes.to(torch.float32), min=1.0)
    std = math.sqrt(2.0) * torch.sqrt(2.0 / (2.0 * n))
    z = torch.randn((num_pairs,), generator=generator,
                    device=generator.device).to(device)
    edge = 1.0 + std[:, None] * z
    feat = torch.zeros((n.shape[0], feat_dim), device=device)
    bias = torch.zeros_like(edge) if cfg.mask_bias else None
    return MaskState(edge, feat, bias)


def _act(x: torch.Tensor, mask_act: str) -> torch.Tensor:
    if mask_act == "sigmoid":
        return torch.sigmoid(x)
    if mask_act == "ReLU":
        return torch.relu(x)
    return x


def _binary_ent(p: torch.Tensor) -> torch.Tensor:
    return -p * torch.log(p + 1e-12) - (1 - p) * torch.log(1 - p + 1e-12)


def _at_pairs(values: torch.Tensor, pair: torch.Tensor) -> torch.Tensor:
    """``values [Q, P]`` at the pair ids of each edge: ``pair [E]`` shared
    by the queries, or ``pair [Q, E]`` one row a query (batched graphs)."""
    if pair.dim() == 1:
        return values[..., pair]
    return torch.gather(values, -1, pair.long())


def _feat_gate(state: MaskState, cfg: ExplainConfig) -> torch.Tensor:
    return (torch.sigmoid(state.feat_logits) if cfg.use_sigmoid
            else state.feat_logits)


GraphLike = Union[Graph, BatchedGraphs]


def masked_edge_weights(
    g: GraphLike,
    state: MaskState,
    cfg: ExplainConfig,
    edge_keep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``[Q, E_pad]`` masked weights ``A * act(mask) * (1 - I)``,
    restricted to each query's ``edge_keep [Q, E_pad]``
    (``tpugraph/explain/module.py:93``).  Both directions of an edge read
    its pair's logit; padding edges stay 0.  For batched graphs every
    array of ``g`` has the query axis in front."""
    pair = torch.clamp(g.edge_pair, max=state.edge_logits.shape[-1] - 1)
    gate = _at_pairs(_act(state.edge_logits, cfg.mask_act), pair)
    if cfg.mask_bias and state.bias_logits is not None:
        # jnp.clip's gradient: half at the bounds, where the bias starts
        b = state.bias_logits
        b6 = torch.minimum(torch.maximum(b * 6.0, b.new_zeros(())),
                           b.new_full((), 6.0))
        gate = gate + _at_pairs(b6 / 6.0, pair)
    w = g.edge_weight * gate
    w = torch.where(g.senders == g.receivers, torch.zeros_like(w), w)
    w = w * (g.edge_weight != 0)
    if edge_keep is not None:
        w = w * edge_keep.to(w.dtype)
    return w


def mask_density(
    g: GraphLike, state: MaskState, cfg: ExplainConfig,
    edge_keep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``[Q]`` sum(masked adj) / sum(adj) over each neighborhood
    (``tpugraph/explain/module.py:124``)."""
    w = masked_edge_weights(g, state, cfg, edge_keep)
    base = (g.edge_weight if edge_keep is None
            else g.edge_weight * edge_keep.to(g.edge_weight.dtype))
    return torch.sum(w, dim=-1) / torch.clamp(torch.sum(base, dim=-1),
                                              min=1e-12)


def explain_forward(
    model: torch.nn.Module,
    g: GraphLike,
    x: torch.Tensor,
    state: MaskState,
    cfg: ExplainConfig,
    node_idx: torch.Tensor,
    edge_keep: Optional[torch.Tensor],
    generator: Optional[torch.Generator] = None,
    graph_mode: bool = False,
    batch_rows: Optional[Tuple[int, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The frozen model on the masked graph of each query; returns the
    softmax at each query ``[Q, C]`` (of each graph's logits in
    ``graph_mode``) and the masked weights ``[Q, E_pad]``
    (``tpugraph/explain/module.py:138``).  ``x [N_pad, D]`` is shared, or
    ``x [Q, N_pad, D]`` holds each query's own features; with
    ``cfg.marginalize`` and a ``generator`` the masked-out features are
    replaced by noise ``z ~ N(-x, 1/2)`` drawn afresh on each call.
    ``batch_rows`` ``(Q_all, rows)`` says the Q queries are rows ``rows``
    of a batch of ``Q_all``: the noise is drawn for the whole batch and
    those rows kept, so each query gets the noise it gets in that batch."""
    w = masked_edge_weights(g, state, cfg, edge_keep)
    q, (n, d) = w.shape[0], x.shape[-2:]
    xx = x.expand(q, n, d)
    if cfg.mask_features:
        gate = _feat_gate(state, cfg)[:, None, :]
        if cfg.marginalize and generator is not None:
            q_all = q if batch_rows is None else batch_rows[0]
            noise = torch.randn((q_all, n, d), generator=generator,
                                device=x.device)
            if batch_rows is not None:
                noise = noise[batch_rows[1]]
            xx = x + (-x + 0.5 * noise) * (1.0 - gate)
        else:
            xx = x * gate
    off = torch.arange(q, device=x.device)[:, None] * n
    adj = SparseAdj((g.senders + off).reshape(-1),
                    (g.receivers + off).reshape(-1), w.reshape(-1))
    if graph_mode:
        ypred, _ = model(xx, adj)  # [Q, C]: a readout of each copy
        return torch.softmax(ypred, dim=-1), w
    ypred, _ = model(xx.reshape(q * n, d), adj)
    logits = ypred.reshape(q, n, -1)[torch.arange(q, device=x.device),
                                     node_idx]
    return torch.softmax(logits, dim=-1), w


def explain_loss(
    probs: torch.Tensor,
    w: torch.Tensor,
    g: GraphLike,
    state: MaskState,
    cfg: ExplainConfig,
    gt_label: torch.Tensor,
    pred_label_vec: Optional[torch.Tensor],
    edge_keep: Optional[torch.Tensor],
    num_sub_nodes: torch.Tensor,
    graph_mode: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The 5-term objective of each query, ``[Q]`` per term
    (``tpugraph/explain/module.py:176``): pred = -log p[gt]; size and the
    mean entropy of the edge gates over the neighborhood's directed
    edges (entropy over n_sub^2); feat_size; lap = 0.5 * sum_e w_e
    (y_s - y_r)^2 / n_sub^2 on the predicted labels, 0 in
    ``graph_mode``."""
    pred_loss = -torch.log(probs.gather(-1, gt_label[:, None])[:, 0] + 1e-12)

    gate_e = _act(state.edge_logits, cfg.mask_act)
    pair = torch.clamp(g.edge_pair, max=state.edge_logits.shape[-1] - 1)
    live = (g.edge_weight != 0).to(torch.float32)
    if edge_keep is not None:
        live = live * edge_keep.to(live.dtype)
    gate_on_edges = _at_pairs(gate_e, pair)
    size_loss = cfg.coeff_size * torch.sum(gate_on_edges * live, dim=-1)
    n2 = torch.clamp(num_sub_nodes.to(torch.float32) ** 2, min=1.0)
    mask_ent_loss = (cfg.coeff_ent
                     * torch.sum(_binary_ent(gate_on_edges) * live, dim=-1) / n2)

    feat_gate = _feat_gate(state, cfg)
    feat_size_loss = cfg.coeff_feat_size * torch.mean(feat_gate, dim=-1)
    feat_ent_loss = cfg.coeff_feat_ent * torch.mean(_binary_ent(feat_gate),
                                                    dim=-1)

    if graph_mode:
        lap_loss = torch.zeros_like(pred_loss)
    else:
        y = pred_label_vec.to(torch.float32)
        diff = y[g.senders] - y[g.receivers]
        lap_loss = cfg.coeff_lap * 0.5 * torch.sum(w * diff * diff, dim=-1) / n2

    total = pred_loss + size_loss + lap_loss + mask_ent_loss + feat_size_loss
    terms = {"pred": pred_loss, "size": size_loss, "ent": mask_ent_loss,
             "feat_size": feat_size_loss, "feat_ent": feat_ent_loss,
             "lap": lap_loss, "total": total}
    return total, terms


IntsLike = Union[Sequence[int], np.ndarray, torch.Tensor]


def run_mask_optimization(
    model: torch.nn.Module,
    g: GraphLike,
    x: torch.Tensor,
    node_idx: IntsLike,
    gt_label: IntsLike,
    pred_label_vec: Optional[torch.Tensor],
    edge_keep: Optional[torch.Tensor],
    num_sub_nodes: IntsLike,
    cfg: ExplainConfig,
    num_pairs: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    init_state: Optional[Tuple[Optional[np.ndarray], ...]] = None,
    noise_generator: Optional[torch.Generator] = None,
    graph_mode: bool = False,
    batch_rows: Optional[Tuple[int, Sequence[int]]] = None,
) -> Tuple[MaskState, Dict[str, np.ndarray]]:
    """``cfg.num_epochs`` Adam(lr) steps on the masks of Q queries at once
    (``tpugraph/explain/module.py:242``, vmapped over the queries there).

    ``node_idx``, ``gt_label`` and ``num_sub_nodes`` hold one entry a
    query, ``edge_keep`` is ``bool[Q, E_pad]`` (or ``None``: every edge),
    ``x [N_pad, D]`` and ``pred_label_vec [N_pad]`` are shared, and the
    model's parameters should not require grad.  ``g`` moves to ``x``'s
    device.  ``num_pairs`` defaults to ``E_pad``, as in the explainer.
    The initial state is ``init_state`` (numpy ``(edge_logits,
    feat_logits[, bias_logits])``, each with the query axis) when given,
    else :func:`init_masks` drawn from ``generator`` (on any device); the
    ``marginalize`` noise comes from ``noise_generator`` (default
    ``generator``), which must be on ``x``'s device, drawn for the batch
    ``batch_rows`` names (see :func:`explain_forward`).  Returns the final
    state and the per-epoch loss terms ``[Q, T]``, with ``density`` after
    each update and, when ``cfg.log_mask_every > 0``, ``masked_w [Q, T,
    E_pad]``.  ``graph_mode`` (see the module docstring) takes the
    graph classifier, ``g`` one graph or a :class:`BatchedGraphs` of the
    Q graphs with ``x [Q, N_pad, D]``, and no ``pred_label_vec``."""
    dev = x.device
    g = g.to(dev)
    node_idx = torch.as_tensor(np.asarray(node_idx), device=dev).long()
    gt_label = torch.as_tensor(np.asarray(gt_label), device=dev).long()
    num_sub = torch.as_tensor(np.asarray(num_sub_nodes), device=dev)
    if num_pairs is None:
        num_pairs = g.num_edges_padded
    if init_state is None:
        init = init_masks(generator, num_pairs, x.shape[-1], num_sub, cfg)
    else:
        init = MaskState(*(None if a is None
                           else torch.tensor(np.asarray(a, np.float32), device=dev)
                           for a in init_state))
    state = MaskState(*(None if t is None else torch.nn.Parameter(t.clone())
                        for t in init))
    opt = torch.optim.Adam([t for t in state if t is not None], lr=cfg.lr,
                           eps=1e-8)
    noise_gen = ((noise_generator or generator) if cfg.marginalize
                 else None)
    if batch_rows is not None:
        batch_rows = (int(batch_rows[0]),
                      torch.as_tensor(np.asarray(batch_rows[1]), device=dev).long())
    hist: Dict[str, list] = {}
    for _ in range(cfg.num_epochs):
        opt.zero_grad(set_to_none=True)
        probs, w = explain_forward(model, g, x, state, cfg, node_idx,
                                   edge_keep, noise_gen, graph_mode,
                                   batch_rows)
        total, terms = explain_loss(probs, w, g, state, cfg, gt_label,
                                    pred_label_vec, edge_keep, num_sub,
                                    graph_mode)
        total.sum().backward()
        opt.step()
        with torch.no_grad():
            terms["density"] = mask_density(g, state, cfg, edge_keep)
            if cfg.log_mask_every > 0:
                terms["masked_w"] = masked_edge_weights(g, state, cfg,
                                                        edge_keep)
        for k, v in terms.items():
            hist.setdefault(k, []).append(v.detach())
    history = {k: torch.stack(v, dim=1).cpu().numpy() for k, v in hist.items()}
    final = MaskState(*(None if t is None else t.detach() for t in state))
    return final, history
