"""Port of ``tpugraph/explain/explainer.py``: the tile-space explanation
engine (``explain_nodes_bcsr``) over a trained model and its cg bundle.

The full graph is packed once into BCSR (plus its transpose plan and
symmetry partners) and moved to the device; every query then restricts
the mask to its k-hop nodes with a node mask, so nothing is repacked per
query.  Results keep the reference's dense ``masked_adj`` contract
(ascending-neighbor sub-adjacency) and its ``.npy`` file names.
Single-device only: the ``mesh`` query sharding is not ported.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tpugraph_torch._device import DeviceLike, default_device
from tpugraph_torch.core.graph import Graph, graph_from_dense
from tpugraph_torch.core.khop import khop_subgraph
from tpugraph_torch.explain.bcsr_explain import (
    run_bcsr_mask_optimization,
    tiles_to_edge_weights,
)
from tpugraph_torch.explain.module import ExplainConfig
from tpugraph_torch.ops.bcsr import (
    bcsr_from_coo,
    bcsr_sym_partner,
    bcsr_transpose_plan,
)


class Explainer:
    """Per-checkpoint explanation engine (``tpugraph/explain/explainer.py:51``).

    Args:
      model: a :class:`tpugraph_torch.nn.GcnEncoderNode`; it is moved to
        ``device``, loaded with ``params`` (a ``state_dict``) when given,
        and frozen.
      adj/feat/label/pred: the cg bundle — ``adj [B, N, N]``,
        ``feat [B, N, D]``, ``label [B, N]``, ``pred [B, N, C]``.
      n_hops: neighborhood radius (the number of GC layers).
      device: ``None`` = CUDA; raises without it.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        params: Optional[Dict[str, torch.Tensor]],
        adj: np.ndarray,
        feat: np.ndarray,
        label: np.ndarray,
        pred: np.ndarray,
        n_hops: int = 3,
        graph_idx: int = 0,
        cfg: ExplainConfig = ExplainConfig(),
        logdir: Optional[str] = None,
        print_training: bool = False,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.device = default_device(device)
        self.model = model.to(self.device)
        if params is not None:
            self.model.load_state_dict(params)
        self.model.eval()
        self.model.requires_grad_(False)
        self.adj = np.asarray(adj)
        self.feat = np.asarray(feat, dtype=np.float32)
        self.label = np.asarray(label)
        self.pred = np.asarray(pred)
        self.n_hops = n_hops
        self.graph_idx = graph_idx
        self.cfg = cfg
        self.logdir = logdir
        self.print_training = print_training
        self.seed = seed
        self._graphs: Dict[int, Graph] = {}
        self._bcsr_pack_cache: Dict = {}
        # the kernels' tile dtype (run_bcsr_mask_optimization's spmm_dtype);
        # private, as tpugraph's Explainer exposes no such option
        self._spmm_dtype: Optional[torch.dtype] = None

    def _graph(self, graph_idx: int) -> Graph:
        if graph_idx not in self._graphs:
            self._graphs[graph_idx] = graph_from_dense(self.adj[graph_idx])
        return self._graphs[graph_idx]

    def _densify_mask(self, g: Graph, w: np.ndarray,
                      neighbors: np.ndarray) -> np.ndarray:
        """Dense ``[n_sub, n_sub]`` masked sub-adjacency in ascending
        neighbor order (``dense[r, s] = w(s -> r)``)."""
        neighbors = np.asarray(neighbors)
        n_sub = len(neighbors)
        pos = np.full((g.num_nodes_padded,), -1, dtype=np.int64)
        pos[neighbors] = np.arange(n_sub)
        s = pos[g.senders.numpy()]
        r = pos[g.receivers.numpy()]
        keep = (w != 0) & (s >= 0) & (r >= 0)
        dense = np.zeros((n_sub, n_sub), dtype=np.float32)
        dense[r[keep], s[keep]] = w[keep]
        return dense

    def _save_npy(self, masked_adj: np.ndarray, node_idx: int,
                  prefix: str = "", graph_idx: Optional[int] = None) -> None:
        """``masked_adj_<prefix>node_idx_<n>graph_idx_<g>.npy`` in
        ``logdir`` (nothing without a logdir)."""
        if self.logdir is None:
            return
        os.makedirs(self.logdir, exist_ok=True)
        gi = self.graph_idx if graph_idx is None else graph_idx
        fname = f"masked_adj_{prefix}node_idx_{node_idx}graph_idx_{gi}.npy"
        with open(os.path.join(self.logdir, fname), "wb") as f:
            np.save(f, masked_adj)

    def _bcsr_pack(self, graph_idx: int, block: int):
        """Cached full-graph pack per (graph_idx, block): host BCSR, its
        device copy, transpose plan, symmetry partners, padded features
        and predicted labels."""
        key = (int(graph_idx), int(block))
        hit = self._bcsr_pack_cache.get(key)
        if hit is not None:
            return hit
        g = self._graph(graph_idx)
        m = bcsr_from_coo(g.senders.numpy(), g.receivers.numpy(),
                          g.edge_weight.numpy(), g.num_nodes_padded,
                          block=block)
        tp = bcsr_transpose_plan(m)
        partner = torch.from_numpy(bcsr_sym_partner(m)).long()
        x = np.zeros((m.num_nodes, self.feat.shape[-1]), dtype=np.float32)
        x[: self.feat.shape[1]] = self.feat[graph_idx]
        pred_vec = np.zeros((m.num_nodes,), dtype=np.int32)
        pl = np.argmax(self.pred[graph_idx], axis=-1)
        pred_vec[: pl.shape[0]] = pl
        dev = self.device
        hit = (g, m, m.to(dev), tp.to(dev), partner.to(dev),
               torch.from_numpy(x).to(dev), torch.from_numpy(pred_vec).to(dev))
        self._bcsr_pack_cache[key] = hit
        return hit

    def explain_node_bcsr(self, node_idx: int, graph_idx: int = 0,
                          block: int = 128) -> Dict:
        """One query on the tile-space path (see :meth:`explain_nodes_bcsr`)."""
        return self.explain_nodes_bcsr([node_idx], graph_idx=graph_idx,
                                       block=block)[0]

    def explain_nodes_bcsr(
        self,
        node_indices: Sequence[int],
        graph_idx: int = 0,
        block: int = 128,
        mesh=None,
    ) -> List[Dict]:
        """Tile-space GNNExplainer for each query node in turn
        (``tpugraph/explain/explainer.py:373``).  Every query starts from
        the same mask init (seeded by ``seed``).  Returns per query
        ``node_idx``, ``node_idx_new``, ``neighbors``, the dense
        ``masked_adj``, the loss-term ``history`` and ``feat_mask``."""
        if mesh is not None:
            raise NotImplementedError("mesh query sharding is not ported yet")
        g, m_host, m, tp, partner, x, pred_vec = self._bcsr_pack(
            graph_idx, block)
        s = g.senders.numpy()
        r = g.receivers.numpy()
        labels = self.label[graph_idx]

        results = []
        t0 = time.time()
        for node_idx in node_indices:
            nb = khop_subgraph(g, int(node_idx), self.n_hops)
            keep_np, num_sub, new_index = nb.node_mask, nb.num_nodes, nb.new_index
            keep = np.zeros((m.num_nodes,), dtype=np.float32)
            keep[: keep_np.shape[0]] = keep_np
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            state, w_tiles, hist = run_bcsr_mask_optimization(
                self.model, m, tp, partner, x,
                node_idx=int(node_idx), gt_label=int(labels[node_idx]),
                pred_label_vec=pred_vec, num_sub_nodes=num_sub,
                cfg=self.cfg, generator=gen,
                node_keep=torch.from_numpy(keep).to(self.device),
                spmm_dtype=self._spmm_dtype,
            )
            w_edges = tiles_to_edge_weights(m_host, w_tiles.cpu().numpy(), s, r)
            neighbors = np.nonzero(keep_np)[0]
            results.append({
                "node_idx": int(node_idx),
                "node_idx_new": int(new_index),
                "neighbors": neighbors,
                "masked_adj": self._densify_mask(g, w_edges, neighbors),
                "history": hist,
                "feat_mask": torch.sigmoid(state.feat_logits).cpu().numpy(),
            })
        if self.print_training:
            print(f"bcsr-explained {len(node_indices)} nodes "
                  f"({m.num_tiles} tiles of {block}^2) in "
                  f"{time.time() - t0:.2f}s")
        return results
