"""Port of ``tpugraph/explain/bcsr_explain.py``: GNNExplainer mask
optimization in tile space, on the hand-written BCSR kernels.

The learnable edge mask is a logit per entry of the BCSR tiles,
symmetrized as ``(L + L_partner^T) / 2``; the masked adjacency
``W = base * act(sym) * (1 - I)`` (restricted to the query's k-hop
nodes) feeds the frozen model through ``bcsr_matvec_dw_pair``, whose
backward gives the mask gradient with the SDDMM kernel (B2) and ``dx``
with the SpMM kernel (B1).  Loss terms and init follow the JAX module;
the JAX ``lax.scan`` of Adam steps is a Python loop of
``torch.optim.Adam`` steps (same defaults and bias correction).
``spmm_dtype`` (e.g. ``torch.bfloat16``) is the dtype the kernels read
the masked tiles at; the mask logits, the loss and Adam stay float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpugraph_torch.explain.module import ExplainConfig, _act, _binary_ent
from tpugraph_torch.nn.layers import BCSRAdj
from tpugraph_torch.ops.bcsr import BCSR, BCSRTranspose, transpose_tiles


class BCSRMaskState(NamedTuple):
    """Learnable explainer parameters in tile space."""

    tile_logits: torch.Tensor  # float32[T, B, B]
    feat_logits: torch.Tensor  # float32[D]


def init_tile_masks(
    generator: torch.Generator,
    num_tiles: int,
    block: int,
    feat_dim: int,
    num_sub_nodes: int,
    device,
) -> BCSRMaskState:
    """Reference init: mask ~ N(1, sqrt(2) * sqrt(2 / 2n)), feature mask 0
    (``tpugraph/explain/bcsr_explain.py:52``; ``jax.random`` there, so the
    draws differ — tests hand both sides one init)."""
    n = max(float(num_sub_nodes), 1.0)
    std = math.sqrt(2.0) * math.sqrt(2.0 / (2.0 * n))
    noise = torch.randn((num_tiles, block, block), generator=generator,
                        device=device)
    return BCSRMaskState(1.0 + std * noise,
                         torch.zeros((feat_dim,), device=device))


def masked_tiles(
    base: BCSR,
    sym_partner: torch.Tensor,
    state: BCSRMaskState,
    cfg: ExplainConfig,
    node_keep: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """``(W, gate, keep)``: masked tiles ``base * act(sym(L)) * (1 - I)``
    (diagonal zeroed inside diagonal tiles), the gate, and the k-hop
    support restriction ``keep`` — the outer product of the row-block and
    column-block slices of ``node_keep`` (``:69``)."""
    L = state.tile_logits
    sym = 0.5 * (L + L[sym_partner].transpose(1, 2))
    gate = _act(sym, cfg.mask_act)
    is_diag = (base.row_of == base.col_blk).to(gate.dtype)[:, None, None]
    eye = torch.eye(base.block, dtype=gate.dtype, device=gate.device)
    w = base.tiles * gate * (1.0 - is_diag * eye)
    keep = None
    if node_keep is not None:
        nm = node_keep.to(w.dtype).reshape(-1, base.block)
        keep = nm[base.row_of.long()][:, :, None] * nm[base.col_blk.long()][:, None, :]
        w = w * keep
    return w, gate, keep


def bcsr_mask_density(base: BCSR, w_tiles: torch.Tensor) -> torch.Tensor:
    """sum(masked) / sum(adj)."""
    return torch.sum(w_tiles) / torch.clamp(torch.sum(base.tiles), min=1e-12)


def bcsr_explain_loss(
    probs: torch.Tensor,
    w_tiles: torch.Tensor,
    gate: torch.Tensor,
    base: BCSR,
    state: BCSRMaskState,
    cfg: ExplainConfig,
    gt_label: int,
    pred_label_vec: torch.Tensor,
    num_sub_nodes: int,
    keep: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The 5-term objective in tile space (``:109``): pred + size + lap +
    ent + feat_size; ``feat_ent`` is computed but not added."""
    pred_loss = -torch.log(probs[gt_label] + 1e-12)

    support = (base.tiles != 0).to(gate.dtype)
    if keep is not None:
        support = support * keep
    size_loss = cfg.coeff_size * torch.sum(gate * support)
    n2 = max(float(num_sub_nodes) ** 2, 1.0)
    mask_ent_loss = cfg.coeff_ent * torch.sum(_binary_ent(gate) * support) / n2

    feat_gate = (torch.sigmoid(state.feat_logits) if cfg.use_sigmoid
                 else state.feat_logits)
    feat_size_loss = cfg.coeff_feat_size * torch.mean(feat_gate)
    feat_ent_loss = cfg.coeff_feat_ent * torch.mean(_binary_ent(feat_gate))

    # entry (i, j) of tile t couples receiver row_of[t]*B+i with
    # sender col_blk[t]*B+j
    yb = pred_label_vec.to(torch.float32).reshape(-1, base.block)
    y_row = yb[base.row_of.long()]
    y_col = yb[base.col_blk.long()]
    diff = y_col[:, None, :] - y_row[:, :, None]
    lap_loss = cfg.coeff_lap * 0.5 * torch.sum(w_tiles * diff * diff) / n2

    total = pred_loss + size_loss + lap_loss + mask_ent_loss + feat_size_loss
    terms = {"pred": pred_loss, "size": size_loss, "ent": mask_ent_loss,
             "feat_size": feat_size_loss, "feat_ent": feat_ent_loss,
             "lap": lap_loss, "total": total}
    return total, terms


def bcsr_mask_loss(
    model: torch.nn.Module,
    base: BCSR,
    tp: BCSRTranspose,
    sym_partner: torch.Tensor,
    x: torch.Tensor,
    state: BCSRMaskState,
    cfg: ExplainConfig,
    node_idx: int,
    gt_label: int,
    pred_label_vec: torch.Tensor,
    num_sub_nodes: int,
    node_keep: Optional[torch.Tensor] = None,
    spmm_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One evaluation of the objective: masked tiles, the frozen model's
    forward on them, and :func:`bcsr_explain_loss` (the ``loss_fn`` of
    ``run_bcsr_mask_optimization``, ``:204``).  The transposed masked
    tiles are computed once for all layers and carry no gradient.

    ``spmm_dtype`` casts the tiles the kernels read (``:215``): B1 and B2
    read ``m.tiles`` at it through ``BCSRAdj.spmm_dtype``, and the
    transposed tiles are the transpose of the cast tiles, which the
    float32 ``keep`` of the transpose plan widens back to float32, as in
    ``tpugraph``.  The loss terms read the float32 tiles."""
    w_tiles, gate, keep = masked_tiles(base, sym_partner, state, cfg,
                                       node_keep)
    xx = x
    if cfg.mask_features:
        feat_gate = (torch.sigmoid(state.feat_logits) if cfg.use_sigmoid
                     else state.feat_logits)
        xx = x * feat_gate
    masked = dataclasses.replace(base, tiles=w_tiles)
    w_run = w_tiles.detach()
    if spmm_dtype is not None:
        w_run = w_run.to(spmm_dtype)
    masked_t = BCSR(
        tiles=transpose_tiles(w_run, tp), col_blk=tp.col_blk,
        row_ptr=tp.row_ptr, row_of=tp.row_of, num_nodes=tp.num_nodes,
        block=tp.block, longest_list=tp.longest_list,
    )
    ypred, _ = model(xx, BCSRAdj(masked, masked_t, tp, spmm_dtype=spmm_dtype))
    probs = torch.softmax(ypred[node_idx], dim=-1)
    total, terms = bcsr_explain_loss(
        probs, w_tiles, gate, base, state, cfg, gt_label, pred_label_vec,
        num_sub_nodes, keep=keep)
    terms["density"] = bcsr_mask_density(base, w_tiles)
    return total, terms


def run_bcsr_mask_optimization(
    model: torch.nn.Module,
    base: BCSR,
    tp: BCSRTranspose,
    sym_partner: torch.Tensor,
    x: torch.Tensor,
    node_idx: int,
    gt_label: int,
    pred_label_vec: torch.Tensor,
    num_sub_nodes: int,
    cfg: ExplainConfig,
    generator: Optional[torch.Generator] = None,
    node_keep: Optional[torch.Tensor] = None,
    init_state: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    spmm_dtype: Optional[torch.dtype] = None,
) -> Tuple[BCSRMaskState, torch.Tensor, Dict[str, np.ndarray]]:
    """``cfg.num_epochs`` Adam steps on the tile-space mask (``:169``);
    ``spmm_dtype`` as in :func:`bcsr_mask_loss`.

    The initial state is ``init_state`` (numpy ``(tile_logits,
    feat_logits)``) when given, else :func:`init_tile_masks` with
    ``generator``.  The model's parameters should not require grad.
    Returns the final state, the final masked tiles and the per-epoch
    loss-term history."""
    device = x.device
    if init_state is None:
        init = init_tile_masks(generator, base.num_tiles, base.block,
                               x.shape[-1], num_sub_nodes, device)
    else:
        init = BCSRMaskState(*(torch.tensor(np.asarray(a, np.float32),
                                            device=device)
                               for a in init_state))
    state = BCSRMaskState(torch.nn.Parameter(init.tile_logits.clone()),
                          torch.nn.Parameter(init.feat_logits.clone()))
    opt = torch.optim.Adam(list(state), lr=cfg.lr)
    hist: Dict[str, list] = {}
    for _ in range(cfg.num_epochs):
        opt.zero_grad(set_to_none=True)
        total, terms = bcsr_mask_loss(
            model, base, tp, sym_partner, x, state, cfg, node_idx, gt_label,
            pred_label_vec, num_sub_nodes, node_keep, spmm_dtype)
        total.backward()
        opt.step()
        for k, v in terms.items():
            hist.setdefault(k, []).append(v.detach())
    history = {k: torch.stack(v).cpu().numpy() for k, v in hist.items()}
    with torch.no_grad():
        final = BCSRMaskState(state.tile_logits.detach(),
                              state.feat_logits.detach())
        w_tiles, _, _ = masked_tiles(base, sym_partner, final, cfg, node_keep)
    return final, w_tiles, history


def tiles_to_edge_weights(
    m: BCSR,
    tiles: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
) -> np.ndarray:
    """Host-side per-directed-edge values read out of tile space (``:255``):
    edge s -> r sits at (r % B, s % B) of the first tile at block
    (r // B, s // B)."""
    tiles = np.asarray(tiles)
    b = m.block
    n_blocks = m.num_row_blocks
    row = np.asarray(m.row_of).astype(np.int64)
    col = np.asarray(m.col_blk).astype(np.int64)
    tile_key = row * n_blocks + col
    lut = np.full(n_blocks * n_blocks, -1, dtype=np.int64)
    rev = np.argsort(tile_key, kind="stable")[::-1]
    lut[tile_key[rev]] = rev
    edge_key = (receivers // b).astype(np.int64) * n_blocks + senders // b
    t_idx = lut[edge_key]
    ok = t_idx >= 0
    out = np.zeros(len(senders), dtype=np.float32)
    out[ok] = tiles[t_idx[ok], receivers[ok] % b, senders[ok] % b]
    return out
