"""Port of ``tpugraph/explain/explainer.py``: the explanation engine over
a trained model and its cg bundle, on two paths.

* COO (``explain_nodes_batch``, ``explain``, ``explain_nodes_gnn_stats``):
  every query's mask optimization at once, one batched forward over Q
  copies of the graph a step (:mod:`tpugraph_torch.explain.module`),
  each query restricted to the live edges of its k-hop neighborhood.
* Tile space (``explain_nodes_bcsr``): the full graph is packed once into
  BCSR (plus its transpose plan and symmetry partners) and moved to the
  device; every query then restricts the mask to its k-hop nodes with a
  node mask, so nothing is repacked per query.
* Graph mode (``graph_mode=True``, a graph classifier over a graph cg
  bundle): ``explain(graph_mode=True)`` / ``_explain_graph`` and
  ``explain_graphs`` learn a mask over every edge of each graph on the
  COO path, all the graphs of a call in one batched forward a step, and
  ``explain_graph_bcsr`` learns it in tile space on B1/B2.

* Baselines (``model="grad"`` or ``"att"`` in ``explain`` and
  ``explain_nodes_gnn_stats``, ``model="grad"`` in graph mode): the
  model's dense path on each query's dense sub-adjacency
  (:mod:`tpugraph_torch.explain.baselines`), every query of a stats run in
  one mapped call.
* Alignment (``explain_nodes``): the first two COO explanations denoised
  and aligned by :func:`tpugraph_torch.explain.align.align_explanations`.

Results keep the reference's dense ``masked_adj`` contract
(ascending-neighbor sub-adjacency) and its ``.npy`` file names.
The stats run draws its precision-recall curve and the alignment its
two subgraphs under ``logdir`` (:mod:`tpugraph_torch.viz.graphs`).
``mesh`` (``explain_nodes_batch``, ``explain_nodes_bcsr``,
``explain_nodes_gnn_stats``) shards the queries over the ranks of a
``torch.distributed`` group, every query's result the single-device
one, gathered on the mesh's first rank.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpugraph_torch._device import DeviceLike, default_device
from tpugraph_torch.core.graph import Graph, batch_graphs, graph_from_dense
from tpugraph_torch.core.khop import extract_dense_subgraph, khop_subgraph
from tpugraph_torch.data.pipeline import to_numpy_array
from tpugraph_torch.explain import baselines
from tpugraph_torch.explain.align import align_explanations
from tpugraph_torch.explain.bcsr_explain import (
    run_bcsr_mask_optimization,
    tiles_to_edge_weights,
)
from tpugraph_torch.explain.groundtruth import explanation_auc
from tpugraph_torch.explain.module import (
    ExplainConfig,
    init_masks,
    masked_edge_weights,
    run_mask_optimization,
)
from tpugraph_torch.ops.bcsr import (
    bcsr_from_coo,
    bcsr_sym_partner,
    bcsr_transpose_plan,
)
from tpugraph_torch.parallel.collectives import gather_to_first
from tpugraph_torch.parallel.mesh import Mesh
from tpugraph_torch.viz.graphs import denoise_graph, log_graph, plot_pr_curve


def _gather_queries(arrays: Dict[str, np.ndarray], mesh: Mesh
                    ) -> Optional[Dict[str, np.ndarray]]:
    """Each rank's float32 per-query arrays (query axis first, one shape on
    every rank) joined in rank order on the mesh's first rank; ``None`` on
    the others."""
    out = {k: gather_to_first(torch.from_numpy(np.ascontiguousarray(a))
                              .to(mesh.device), mesh.group)
           for k, a in arrays.items()}
    if mesh.rank != 0:
        return None
    return {k: t.cpu().numpy() for k, t in out.items()}


class Explainer:
    """Per-checkpoint explanation engine (``tpugraph/explain/explainer.py:51``).

    Args:
      model: a :class:`tpugraph_torch.nn.GcnEncoderNode` (a
        :class:`tpugraph_torch.nn.GcnEncoderGraph` in ``graph_mode``); it
        is moved to ``device``, loaded with ``params`` (a ``state_dict``)
        when given, and frozen.
      adj/feat/label/pred: the cg bundle — ``adj [B, N, N]``,
        ``feat [B, N, D]``, ``label [B, N]``, ``pred [B, N, C]``; in
        ``graph_mode`` ``label [B]`` and ``pred [1, B, C]``.
      n_hops: neighborhood radius (the number of GC layers).
      graph_mode: explain whole-graph predictions; ``graph_idx`` names
        the graph in the ``.npy`` files of single explanations.
      dataset: names the motif ground truth of the AUC.
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
        graph_mode: bool = False,
        graph_idx: int = 0,
        cfg: ExplainConfig = ExplainConfig(),
        logdir: Optional[str] = None,
        dataset: str = "syn1",
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
        self.graph_mode = graph_mode
        self.graph_idx = graph_idx
        self.cfg = cfg
        self.logdir = logdir
        self.dataset = dataset
        self.print_training = print_training
        self.seed = seed
        self.align_steps = 1000
        self.last_alignment: Optional[Dict[str, np.ndarray]] = None
        self._graphs: Dict[int, Graph] = {}
        self._bcsr_pack_cache: Dict = {}
        # the kernels' tile dtype (run_bcsr_mask_optimization's spmm_dtype);
        # private, as tpugraph's Explainer exposes no such option
        self._spmm_dtype: Optional[torch.dtype] = None

    def _graph(self, graph_idx: int) -> Graph:
        if graph_idx not in self._graphs:
            self._graphs[graph_idx] = graph_from_dense(self.adj[graph_idx])
        return self._graphs[graph_idx]

    def _padded_feat(self, graph_idx: int, g: Graph) -> np.ndarray:
        n_pad = g.num_nodes_padded
        f = np.zeros((n_pad, self.feat.shape[-1]), dtype=np.float32)
        f[: self.feat.shape[1]] = self.feat[graph_idx]
        return f

    def _pred_labels(self, graph_idx: int, g: Graph) -> np.ndarray:
        out = np.zeros((g.num_nodes_padded,), dtype=np.int32)
        pl = np.argmax(self.pred[graph_idx], axis=-1)
        out[: pl.shape[0]] = pl
        return out

    def extract_neighborhood(self, node_idx: int, graph_idx: int = 0):
        """``(node_idx_new, sub_adj, sub_feat, sub_label, neighbors)``
        (reference ``explain.py:492-501``)."""
        return extract_dense_subgraph(self.adj[graph_idx],
                                      self.feat[graph_idx],
                                      self.label[graph_idx], node_idx,
                                      self.n_hops)

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

    def explain_nodes_batch(
        self,
        node_indices: Sequence[int],
        graph_idx: int = 0,
        mesh: Optional[Mesh] = None,
        init_state: Optional[Tuple[Optional[np.ndarray], ...]] = None,
    ) -> Optional[List[Dict]]:
        """Every query's COO mask optimization at once
        (``tpugraph/explain/explainer.py:173``): Q copies of the graph in
        one forward a step.  Returns per query ``node_idx``,
        ``node_idx_new``, ``neighbors``, the dense ``masked_adj``, the
        loss-term ``history`` and ``feat_mask``.  With
        ``cfg.seed_ensemble = k`` the masked weights are the mean of k runs
        seeded ``seed + 7919 * s``; the history and ``feat_mask`` are the
        first run's.  ``init_state`` (numpy ``(edge_logits [Q, E_pad],
        feat_logits [Q, D], bias_logits or None)``) replaces the first
        run's seeded mask init, as :func:`run_mask_optimization` takes
        it.

        With ``mesh`` (a 1-D :class:`~tpugraph_torch.parallel.mesh.Mesh`,
        called on every rank of it) the queries are padded with the last
        one to a multiple of ``mesh.size`` and rank ``r`` optimizes the
        contiguous block ``r`` of them.  Its init is its rows of the whole
        batch's init (drawn as one device draws it, or of ``init_state``)
        and its ``marginalize`` noise its rows of the whole batch's, so
        each query's result is the single-device one.  The mesh's first
        rank gathers the edge weights, histories and feature masks and
        returns the results; every other rank returns ``None``."""
        dev = self.device
        g = self._graph(graph_idx)
        g_dev = g.to(dev)
        x = torch.from_numpy(self._padded_feat(graph_idx, g)).to(dev)
        pred_vec = torch.from_numpy(self._pred_labels(graph_idx, g)).to(dev)
        labels_pad = np.zeros((g.num_nodes_padded,), dtype=np.int64)
        lab = self.label[graph_idx]
        labels_pad[: lab.shape[0]] = lab
        idx = np.asarray(node_indices, dtype=np.int64)
        nq = len(idx)
        rows = np.arange(nq)
        if mesh is not None:
            per = -(-nq // mesh.size)
            rows = np.minimum(np.arange(mesh.rank * per, (mesh.rank + 1) * per),
                              nq - 1)
        nbs = [khop_subgraph(g, int(i), self.n_hops) for i in idx]
        edge_keep = torch.from_numpy(np.stack([nbs[q].edge_mask for q in rows])).to(dev)
        num_sub = np.asarray([nb.num_nodes for nb in nbs])

        def run(seed, init=None):
            # the whole batch's mask init from a CPU generator (so the card
            # explains from the CPU's init), then this call's rows; the
            # marginalize noise from one on the device
            if init is None:
                init = init_masks(torch.Generator().manual_seed(seed),
                                  g.num_edges_padded, x.shape[-1],
                                  torch.from_numpy(num_sub), self.cfg)
            init = tuple(None if a is None else np.asarray(a)[rows] for a in init)
            state, hist = run_mask_optimization(
                self.model, g_dev, x, idx[rows], labels_pad[idx[rows]], pred_vec,
                edge_keep, num_sub[rows], self.cfg, init_state=init,
                noise_generator=torch.Generator(device=dev).manual_seed(seed),
                batch_rows=None if mesh is None else (nq, rows))
            with torch.no_grad():
                w = masked_edge_weights(g_dev, state, self.cfg, edge_keep)
            return state, w.cpu().numpy(), hist

        t0 = time.time()
        state, w_all, hist = run(self.seed, init_state)
        if self.cfg.seed_ensemble > 1:
            acc = w_all.astype(np.float64)
            for s in range(1, self.cfg.seed_ensemble):
                acc += run(self.seed + 7919 * s)[1]
            w_all = (acc / self.cfg.seed_ensemble).astype(np.float32)
        feat_mask = torch.sigmoid(state.feat_logits).cpu().numpy()
        if mesh is not None:
            got = _gather_queries({"w": w_all, "feat": feat_mask, **hist}, mesh)
            if got is None:
                return None
            w_all, feat_mask = got.pop("w"), got.pop("feat")
            hist = got
        if self.print_training:
            print(f"explained {nq} nodes in {time.time() - t0:.2f}s "
                  f"({self.cfg.num_epochs} epochs each, batched"
                  + (f", {mesh.size}-rank query sharding" if mesh else "")
                  + ")")
        results = []
        for q, (node_idx, nb) in enumerate(zip(idx, nbs)):
            neighbors = np.nonzero(nb.node_mask)[0]
            results.append({
                "node_idx": int(node_idx),
                "node_idx_new": nb.new_index,
                "neighbors": neighbors,
                "masked_adj": self._densify_mask(g, w_all[q], neighbors),
                "history": {k: v[q] for k, v in hist.items()},
                "feat_mask": feat_mask[q],
            })
        return results

    def _baseline_masks(self, model: str, node_indices: Sequence[int],
                        graph_idx: int):
        """The grad or att baseline of every query's dense neighborhood in
        one mapped call (grad at the query's predicted label); returns the
        masks, the queries' subgraph indices and their neighbors."""
        neigh = [self.extract_neighborhood(int(i), graph_idx)
                 for i in node_indices]
        starts = [nb[0] for nb in neigh]
        sub_adjs = [nb[1] for nb in neigh]
        sub_feats = [nb[2] for nb in neigh]
        if model == "grad":
            pred_labels = [int(np.argmax(self.pred[graph_idx][nb[4]], axis=1)[nb[0]])
                           for nb in neigh]
            masks = baselines.grad_saliency_batch(
                self.model, sub_adjs, sub_feats, starts, pred_labels)
        else:
            masks = baselines.attention_saliency_batch(self.model, sub_adjs,
                                                       sub_feats)
        return masks, starts, [nb[4] for nb in neigh]

    def explain(self, node_idx: int, graph_idx: int = 0,
                graph_mode: bool = False, model: str = "exp") -> np.ndarray:
        """One node's dense masked sub-adjacency, or with ``graph_mode``
        (or an explainer built in graph mode) graph ``graph_idx``'s
        (``tpugraph/explain/explainer.py:605``): the GNNExplainer mask
        (``model="exp"``) or the ``grad``/``att`` baseline on the dense
        neighborhood, saved as ``.npy`` (a graph's grad baseline is not
        saved, as in ``tpugraph``)."""
        if graph_mode or self.graph_mode:
            return self._explain_graph(graph_idx, model=model)
        if model in ("grad", "att"):
            masked_adj = self._baseline_masks(model, [node_idx], graph_idx)[0][0]
        else:
            masked_adj = self.explain_nodes_batch([node_idx],
                                                  graph_idx)[0]["masked_adj"]
        self._save_npy(masked_adj, node_idx)
        return masked_adj

    def explain_nodes_gnn_stats(self, node_indices: Sequence[int],
                                graph_idx: int = 0, model: str = "exp",
                                mesh: Optional[Mesh] = None) -> Optional[Dict]:
        """Explain many nodes, save each mask and score them against the
        motif ground truth (``tpugraph/explain/explainer.py:697``): returns
        ``masked_adjs``, ``results``, ``auc`` (``None`` when the labels
        hold one class) and the ``real``/``pred`` arrays, and writes
        ``pr/auc_<dataset>_<model>.txt`` under ``logdir``.  ``model`` is
        ``exp`` (the batched COO explain) or a baseline, ``grad`` or
        ``att``, of every query in one mapped call.  With both label
        classes present it also draws the precision-recall curve to
        ``pr/pr_<dataset>_<model>.png``.  ``mesh`` shards the ``exp``
        queries (:meth:`explain_nodes_batch`; the ranks after the mesh's
        first return ``None``); the baselines ignore it, as in
        ``tpugraph``."""
        if model == "exp":
            results = self.explain_nodes_batch(node_indices, graph_idx,
                                               mesh=mesh)
            if results is None:
                return None
        else:
            masks, starts, neighbors = self._baseline_masks(
                model, node_indices, graph_idx)
            results = [{"node_idx": int(i), "node_idx_new": st,
                        "neighbors": nb, "masked_adj": ma}
                       for i, st, nb, ma in zip(node_indices, starts,
                                                neighbors, masks)]
        masked_adjs = [r["masked_adj"] for r in results]
        starts = [r["node_idx_new"] for r in results]
        for r in results:
            self._save_npy(r["masked_adj"], r["node_idx"])
        auc = None
        try:
            auc, real_all, pred_all = explanation_auc(masked_adjs, starts,
                                                      self.dataset)
        except ValueError:
            real_all = pred_all = None
        if self.logdir is not None:
            os.makedirs(os.path.join(self.logdir, "pr"), exist_ok=True)
            with open(os.path.join(self.logdir, "pr",
                                   f"auc_{self.dataset}_{model}.txt"), "w") as f:
                f.write(f"dataset: {self.dataset}, model: {model}, auc: {auc}\n")
            if real_all is not None:
                plot_pr_curve(real_all, pred_all, f"pr_{self.dataset}_{model}",
                              outdir=os.path.join(self.logdir, "pr"))
        return {"masked_adjs": masked_adjs, "results": results, "auc": auc,
                "real": real_all, "pred": pred_all}

    def explain_nodes(self, node_indices: Sequence[int], graph_idx: int = 0,
                      init_state: Optional[Tuple[Optional[np.ndarray], ...]] = None
                      ) -> List[np.ndarray]:
        """Explain several nodes on the COO path (``init_state`` as in
        :meth:`explain_nodes_batch`), save each mask, then align the first
        two explanations (``tpugraph/explain/explainer.py:777``): each is
        denoised at threshold 0.1 to its largest component, and
        :func:`align_explanations` runs ``align_steps`` steps on the
        device.  Sets ``last_alignment`` (``P``, ``aligned_adj``,
        ``aligned_feat``) and, under ``logdir``, draws the two denoised
        subgraphs (``align_ref_node_<i>_0.pdf``, ``align_cur_node_<j>_0.pdf``)
        and writes ``aligned_adj.npy``; returns without aligning when a
        query is not in its largest component."""
        results = self.explain_nodes_batch(node_indices, graph_idx,
                                           init_state=init_state)
        masked_adjs = [r["masked_adj"] for r in results]
        for r in results:
            self._save_npy(r["masked_adj"], r["node_idx"])
        if len(node_indices) < 2:
            return masked_adjs

        def denoised(res):
            G = denoise_graph(res["masked_adj"], res["node_idx_new"],
                              feat=self.feat[graph_idx][res["neighbors"]],
                              threshold=0.1)
            feat = np.array([G.feat[u] for u in G.nodes()])
            # list.index raises ValueError when the query fell out of the
            # largest component, as in tpugraph
            return feat, to_numpy_array(G), G.nodes().index(res["node_idx_new"])

        try:
            ref_feat, ref_adj, ref_c = denoised(results[0])
            cur_feat, cur_adj, cur_c = denoised(results[1])
        except ValueError:
            return masked_adjs
        P, aligned_adj, aligned_feat = align_explanations(
            ref_feat, ref_adj, ref_c, cur_feat, cur_adj, cur_c,
            num_steps=self.align_steps, device=self.device)
        self.last_alignment = {"P": P, "aligned_adj": aligned_adj,
                               "aligned_feat": aligned_feat}
        if self.logdir is not None:
            for tag, res in (("align_ref", results[0]), ("align_cur", results[1])):
                G = denoise_graph(res["masked_adj"], res["node_idx_new"],
                                  threshold=0.1)
                if G.number_of_nodes():
                    log_graph(G, f"{tag}_node_{res['node_idx']}",
                              outdir=self.logdir)
            os.makedirs(self.logdir, exist_ok=True)
            np.save(os.path.join(self.logdir, "aligned_adj.npy"), aligned_adj)
        return masked_adjs

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
        if not self.graph_mode:
            # the Laplacian term's labels; graph mode has no such term
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
        mesh: Optional[Mesh] = None,
        init_state: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None,
    ) -> Optional[List[Dict]]:
        """Tile-space GNNExplainer for each query node in turn
        (``tpugraph/explain/explainer.py:373``).  Every query starts from
        the same mask init, drawn from a CPU generator seeded ``seed`` (so
        the card explains from the CPU's init), or from its entry of
        ``init_state`` (numpy ``(tile_logits, feat_logits)``, one a
        query).  Returns per query ``node_idx``, ``node_idx_new``,
        ``neighbors``, the dense ``masked_adj``, the loss-term ``history``
        and ``feat_mask``.

        With ``mesh`` (a 1-D :class:`~tpugraph_torch.parallel.mesh.Mesh`,
        called on every rank of it) the queries go in rounds of
        ``mesh.size``, rank ``r`` taking query ``r`` of each round (a short
        last round repeats the last query, whose results are dropped), each
        on the rank's own copy of the pack with the sequential path's seed,
        so each result is the sequential one.  Each rank reads its masked
        tiles out as edge weights before anything moves; the mesh's first
        rank gathers the edge weights, histories and feature masks and
        returns the results, every other rank returns ``None``."""
        g, m_host, m, tp, partner, x, pred_vec = self._bcsr_pack(
            graph_idx, block)
        s = g.senders.numpy()
        r = g.receivers.numpy()
        labels = self.label[graph_idx]
        nq = len(node_indices)
        mine = list(range(nq))
        if mesh is not None:
            mine = [min(k * mesh.size + mesh.rank, nq - 1)
                    for k in range(-(-nq // mesh.size))]

        t0 = time.time()
        nbs, out = {}, {"w": [], "feat": []}
        for q in mine:
            node_idx = int(node_indices[q])
            nb = nbs[q] = khop_subgraph(g, node_idx, self.n_hops)
            keep = np.zeros((m.num_nodes,), dtype=np.float32)
            keep[: nb.node_mask.shape[0]] = nb.node_mask
            state, w_tiles, hist = run_bcsr_mask_optimization(
                self.model, m, tp, partner, x,
                node_idx=node_idx, gt_label=int(labels[node_idx]),
                pred_label_vec=pred_vec, num_sub_nodes=nb.num_nodes,
                cfg=self.cfg,
                generator=torch.Generator().manual_seed(self.seed),
                node_keep=torch.from_numpy(keep).to(self.device),
                init_state=None if init_state is None else init_state[q],
                spmm_dtype=self._spmm_dtype,
            )
            out["w"].append(tiles_to_edge_weights(m_host, w_tiles.cpu().numpy(), s, r))
            out["feat"].append(torch.sigmoid(state.feat_logits).cpu().numpy())
            for k, v in hist.items():
                out.setdefault(k, []).append(v)
        got = {k: np.stack(v) for k, v in out.items()}
        if mesh is not None:
            got = _gather_queries(got, mesh)
            if got is None:
                return None
            # rank order (rank-major) back to query order (round-major)
            got = {k: v.reshape((mesh.size, -1) + v.shape[1:]).swapaxes(0, 1)
                   .reshape((-1,) + v.shape[1:])[:nq] for k, v in got.items()}
        w_all, feat_mask = got.pop("w"), got.pop("feat")
        if self.print_training:
            print(f"bcsr-explained {nq} nodes ({m.num_tiles} tiles of "
                  f"{block}^2"
                  + (f", {mesh.size}-rank query sharding" if mesh else "")
                  + f") in {time.time() - t0:.2f}s")
        results = []
        for q, node_idx in enumerate(node_indices):
            nb = nbs[q] if q in nbs else khop_subgraph(g, int(node_idx),
                                                        self.n_hops)
            neighbors = np.nonzero(nb.node_mask)[0]
            results.append({
                "node_idx": int(node_idx),
                "node_idx_new": int(nb.new_index),
                "neighbors": neighbors,
                "masked_adj": self._densify_mask(g, w_all[q], neighbors),
                "history": {k: v[q] for k, v in got.items()},
                "feat_mask": feat_mask[q],
            })
        return results

    def explain_graph_bcsr(self, graph_idx: int, block: int = 128,
                           init_state: Optional[Tuple[np.ndarray, np.ndarray]] = None
                           ) -> Dict:
        """Whole-graph explanation in tile space
        (``tpugraph/explain/explainer.py:511``): the mask covers every edge
        of graph ``graph_idx`` and the loss reads its graph logits; the
        frozen classifier runs on B1 forward and backward and the mask
        gradient on B2.  The init comes from a CPU generator seeded with
        ``seed`` (so the card explains from the CPU's init), or is
        ``init_state`` (numpy ``(tile_logits, feat_logits)``).  Returns
        ``graph_idx``, ``neighbors``, the dense ``masked_adj`` over the
        graph's nodes, the loss-term ``history`` and ``feat_mask``."""
        g, m_host, m, tp, partner, x, pred_vec = self._bcsr_pack(graph_idx, block)
        node_keep = np.zeros((m.num_nodes,), np.float32)
        node_keep[: g.num_nodes_padded] = g.node_mask.numpy()
        gt = int(np.asarray(self.label[graph_idx]).flat[0])
        t0 = time.time()
        state, w_tiles, hist = run_bcsr_mask_optimization(
            self.model, m, tp, partner, x, node_idx=0, gt_label=gt,
            pred_label_vec=pred_vec, num_sub_nodes=g.n_node, cfg=self.cfg,
            generator=torch.Generator().manual_seed(self.seed),
            node_keep=torch.from_numpy(node_keep).to(self.device),
            init_state=init_state, spmm_dtype=self._spmm_dtype, graph_mode=True)
        w_edges = tiles_to_edge_weights(m_host, w_tiles.cpu().numpy(),
                                        g.senders.numpy(), g.receivers.numpy())
        if self.print_training:
            print(f"bcsr-explained graph {graph_idx} ({m.num_tiles} tiles of "
                  f"{block}^2) in {time.time() - t0:.2f}s")
        neighbors = np.nonzero(node_keep)[0]
        return {
            "graph_idx": int(graph_idx),
            "node_idx": int(graph_idx),
            "node_idx_new": 0,
            "neighbors": neighbors,
            "masked_adj": self._densify_mask(g, w_edges, neighbors),
            "history": hist,
            "feat_mask": torch.sigmoid(state.feat_logits).cpu().numpy(),
        }

    def _graph_masks(self, idxs: List[int],
                     init_state: Optional[Tuple[np.ndarray, np.ndarray]]
                     ) -> List[np.ndarray]:
        """The COO graph-mode mask optimization of graphs ``idxs`` at once
        (``tpugraph/explain/explainer.py:645, 838``): the graphs padded to
        one edge budget, Q disjoint graphs in one forward a step, each
        graph's dense ``[N, N]`` mask.  Graph ``i``'s mask init is drawn
        over its own edge budget from a CPU generator seeded ``seed + i``
        (the rest of the batch budget is never read), so its result does
        not depend on the other graphs of the call; ``init_state``
        (numpy ``(edge_logits [Q, E_pad], feat_logits [Q, D])`` over the
        batch budget) replaces it."""
        dev = self.device
        nnz = [int((self.adj[i] != 0).sum()) for i in idxs]
        e_pad = max(8, ((max(nnz) + 7) // 8) * 8)
        graphs = [graph_from_dense(self.adj[i], num_edges_padded=e_pad)
                  for i in idxs]
        x = np.stack([self._padded_feat(i, g) for i, g in zip(idxs, graphs)])
        n_nodes = [g.n_node for g in graphs]
        if init_state is None:
            edge = np.ones((len(idxs), e_pad), np.float32)
            for k, (i, e) in enumerate(zip(idxs, nnz)):
                own = ((max(e, 1) + 7) // 8) * 8
                init = init_masks(torch.Generator().manual_seed(self.seed + i),
                                  own, x.shape[-1], torch.tensor([n_nodes[k]]),
                                  self.cfg)
                edge[k, :own] = init.edge_logits[0].numpy()
            init_state = (edge, np.zeros((len(idxs), x.shape[-1]), np.float32))
        bg = batch_graphs(graphs).to(dev)
        state, _ = run_mask_optimization(
            self.model, bg, torch.from_numpy(x).to(dev), np.zeros(len(idxs)),
            np.asarray([int(self.label[i]) for i in idxs]), None, None,
            n_nodes, self.cfg, init_state=init_state,
            noise_generator=torch.Generator(device=dev).manual_seed(self.seed),
            graph_mode=True)
        with torch.no_grad():
            w = masked_edge_weights(bg, state, self.cfg).cpu().numpy()
        return [self._densify_mask(g, w[k], np.arange(g.n_node))
                for k, g in enumerate(graphs)]

    def _explain_graph(self, graph_idx: int, model: str = "exp",
                       init_state: Optional[Tuple[np.ndarray, np.ndarray]] = None
                       ) -> np.ndarray:
        """Graph ``graph_idx``'s dense masked adjacency, saved as ``.npy``
        (``tpugraph/explain/explainer.py:645``); with ``model="grad"`` the
        gradient baseline on the graph's dense ``[:n, :n]`` block, unsaved
        (any other model is the GNNExplainer mask)."""
        if model == "grad":
            n = self._graph(graph_idx).n_node
            pred_label = int(np.argmax(self.pred[0][graph_idx]))
            return baselines.grad_saliency(
                self.model, self.adj[graph_idx][:n, :n],
                self.feat[graph_idx][:n], 0, pred_label, graph_mode=True)
        dense = self._graph_masks([int(graph_idx)], init_state)[0]
        self._save_npy(dense, 0)
        return dense

    def explain_graphs(self, graph_indices: Sequence[int],
                       init_state: Optional[Tuple[np.ndarray, np.ndarray]] = None
                       ) -> List[np.ndarray]:
        """Several graphs' masks in one batched optimization, each saved as
        ``.npy`` under its own graph index
        (``tpugraph/explain/explainer.py:838``); one graph goes through
        :meth:`_explain_graph`.  With ``cfg.marginalize`` the feature noise
        is drawn for the whole batch at once."""
        idxs = [int(gi) for gi in graph_indices]
        if not idxs:
            return []
        if len(idxs) == 1:
            return [self._explain_graph(idxs[0], init_state=init_state)]
        t0 = time.time()
        out = self._graph_masks(idxs, init_state)
        if self.print_training:
            print(f"explained {len(idxs)} graphs in {time.time() - t0:.2f}s "
                  f"({self.cfg.num_epochs} epochs each, batched)")
        for i, dense in zip(idxs, out):
            self._save_npy(dense, 0, graph_idx=i)
        return out
