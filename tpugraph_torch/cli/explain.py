"""Explainer entry point (port of ``tpugraph/cli/explain.py``).

Usage:
  python -m tpugraph_torch.cli.explain --dataset=syn1           # AUC over nodes 400:700:5
  python -m tpugraph_torch.cli.explain --dataset=syn1 --explain-node=301 [--bcsr]
  python -m tpugraph_torch.cli.explain --dataset=syn1 --explainer-model=grad
  python -m tpugraph_torch.cli.explain --dataset=syn1 --multinode-class=0
  python -m tpugraph_torch.cli.explain --bmname=SYNBENCH --graph-mode   # graphs 1-4
  python -m tpugraph_torch.cli.explain --bmname=SYNBENCH --graph-idx=0
  python -m tpugraph_torch.cli.explain --bmname=SYNBENCH --multigraph-class=0

``--dataset`` is any of syn1–syn5; the model (GCN or ``--method att``,
with or without batch norm) is rebuilt from the checkpoint's ``meta``.
``--explain-node`` explains one node on the COO path, or in tile space
with ``--bcsr``; without it the 60 stats nodes are explained together on
the COO path and scored against the dataset's motifs.
``--explainer-model grad|att`` replaces the GNNExplainer mask of both by
the gradient or attention baseline on the dense neighborhood (``att``
needs an attention checkpoint).  ``--multinode-class c`` explains the
first 5 nodes of class ``c`` and aligns the first two explanations
(``--align-steps``), writing ``aligned_adj.npy``.  Graph mode
(``--graph-mode``, ``--graph-idx`` or ``--multigraph-class``) explains a
graph classifier's predictions over its graph cg bundle: graphs 1-4, one
graph, or the first 31 graphs of a class, on the COO path; it ignores
``--explainer-model``, as ``tpugraph``'s does.  A DiffPool
(``soft-assign``) checkpoint cannot be explained, as in ``tpugraph``.

Renders land under ``<logdir>/<prefix>_explain[_suffix]``, as
``tpugraph``'s do: one node's subgraph as ``node_<n>_0.pdf`` (the
summary's ``viz``), with ``--log-mask-every k`` on the COO path the mask
heatmaps ``mask_masked_adj_<epoch>.png`` every k epochs
(``mask_heatmaps``); graph mode's ``graph_<i>_0.pdf`` (``viz``, a
list); the stats run's first four subgraphs
(``graph_<dataset>_<model>_<node>_0.pdf``), its PR curve
(``pr/pr_<dataset>_<model>.png``) and, for ``exp``, the TensorBoard
scalars ``optimization/<term>_loss`` of the first node, its mask
``mask_adj_0.png`` and feature mask ``mask_feat_mask_0.png`` (with
``--log-mask-every``, each node's heatmaps too); the alignment's two
subgraphs.

``--mesh N`` shards the explainer's queries over ``N`` spawned ranks, as
``tpugraph``'s does over a device mesh: the COO queries of
``--explain-node`` and of the stats run, or with ``--bcsr`` the
tile-space query (NCCL with one CUDA card a rank, fewer cards than ranks
raising before anything is written, or gloo CPU processes with
``--platform cpu``).  Every query's mask is the single-device one.  Rank
0 writes every file and the summary, which gains ``"mesh_devices": N``;
the other ranks return an empty dict.  The baselines, the alignment and
graph mode take no mesh, as in ``tpugraph``, and run on rank 0 alone.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict

import numpy as np
import torch.distributed as dist

from tpugraph_torch.cli.config import (SELF_LOOP_METHODS, Config, check_ported,
                                       cli_device, parse_explain_args, rank_backend,
                                       rank_count)
from tpugraph_torch.cli.tasks import is_writer
from tpugraph_torch.explain.explainer import Explainer
from tpugraph_torch.explain.module import ExplainConfig
from tpugraph_torch.nn import GcnEncoderGraph, GcnEncoderNode
from tpugraph_torch.parallel.mesh import make_mesh
from tpugraph_torch.train.checkpoint import (gen_explainer_prefix, gen_prefix,
                                             load_checkpoint)
from tpugraph_torch.utils.tb_writer import SummaryWriter
from tpugraph_torch.viz.graphs import denoise_graph, log_graph, save_matrix_image


def _unexplainable(method: str) -> str:
    return (f"explaining a {method} checkpoint (--method {method}) is not supported: "
            "the explainer masks GcnEncoderNode's edge weights")


def build_explainer(cfg: Config) -> Explainer:
    """An :class:`Explainer` over the checkpoint ``cfg`` names, on
    ``--platform``'s device, logging under
    ``<logdir>/<prefix>_explain[_suffix]`` (``tpugraph/cli/explain.py:27``);
    a rank after the first of a group neither logs nor prints."""
    check_ported(cfg)
    device = cli_device(cfg)
    prefix = gen_prefix(cfg.name, cfg.method, cfg.hidden_dim, cfg.output_dim,
                        cfg.bias, cfg.name_suffix)
    if cfg.method in SELF_LOOP_METHODS:
        raise NotImplementedError(_unexplainable(cfg.method))
    ckpt = load_checkpoint(cfg.ckptdir, prefix)
    cg = ckpt["cg"]
    if cg is None:
        raise ValueError(f"checkpoint {prefix} has no cg bundle")
    # the trained model's options come from its meta (tpugraph reads them
    # from the flags, which must then repeat the training's)
    meta = ckpt["meta"] or {}
    model_type = meta.get("model_type", cfg.method)
    if model_type in SELF_LOOP_METHODS:
        raise NotImplementedError(_unexplainable(model_type))
    graph_mode = (cfg.graph_mode or cfg.multigraph_class >= 0
                  or cfg.graph_idx >= 0)
    if graph_mode and model_type == "soft-assign":
        raise ValueError(
            f"checkpoint {prefix} holds a DiffPool (soft-assign) model; the "
            "graph-mode explainer rebuilds GcnEncoderGraph only, as "
            "tpugraph's does (train --method base or att to explain)")
    common = dict(
        input_dim=int(cg["feat"].shape[2]),
        hidden_dim=cfg.hidden_dim,
        embedding_dim=cfg.output_dim,
        label_dim=int(cg["pred"].shape[2]),
        num_layers=cfg.num_gc_layers,
        bn=bool(meta.get("bn", cfg.bn)),
        use_bias=cfg.bias,
        att=model_type == "att",
        device=device,
    )
    if graph_mode:
        model = GcnEncoderGraph(**common)
    else:
        model = GcnEncoderNode(**common,
                               add_self=bool(meta.get("add_self", False)))
    logdir = None
    if is_writer():
        logdir = os.path.join(cfg.logdir,
                              gen_explainer_prefix(prefix, cfg.explainer_suffix))
        os.makedirs(logdir, exist_ok=True)
    ecfg = ExplainConfig(
        num_epochs=cfg.explainer_epochs,
        lr=cfg.explainer_lr,
        mask_act=cfg.mask_act,
        mask_bias=cfg.mask_bias,
        seed_ensemble=cfg.seed_ensemble,
        marginalize=cfg.marginalize,
        log_mask_every=cfg.log_mask_every,
    )
    return Explainer(
        model,
        ckpt["params"],
        adj=cg["adj"],
        feat=cg["feat"],
        label=cg["label"],
        pred=cg["pred"],
        n_hops=cfg.num_gc_layers,
        graph_mode=graph_mode,
        graph_idx=max(cfg.graph_idx, 0),
        cfg=ecfg,
        logdir=logdir,
        dataset=cfg.name,
        print_training=logdir is not None,
        seed=cfg.seed,
        device=device,
    )


def _mask_heatmaps(ex: Explainer, r: Dict, every: int, name: str) -> int:
    """Heatmaps of a result's masked adjacency every ``every`` mask epochs
    (``tpugraph/cli/explain.py:135-153``); the count drawn."""
    w_hist = np.asarray(r["history"]["masked_w"])
    g = ex._graph(0)
    for ep in range(0, w_hist.shape[0], every):
        save_matrix_image(ex._densify_mask(g, w_hist[ep], r["neighbors"]),
                          name, outdir=ex.logdir, epoch=ep)
    return len(range(0, w_hist.shape[0], every))


def main(argv=None) -> Dict:
    """Run the explainer on ``argv`` (``sys.argv`` when ``None``); returns
    the summary it prints (rank 0's with ``--mesh N``; the other ranks
    return an empty dict)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = parse_explain_args(argv)
    check_ported(cfg)
    cli_device(cfg)  # an unusable --platform raises before anything is written
    n = rank_count(cfg, explain=True)
    if n > 1 and not dist.is_initialized():
        from tpugraph_torch.parallel.launch import run_ranks

        return run_ranks(main, n, rank_backend(cfg), argv)
    mesh = make_mesh(n) if n > 1 else None
    ex = build_explainer(cfg)
    sharded = (cfg.explainer_model == "exp" and not ex.graph_mode
               and (cfg.explain_node is not None or cfg.multinode_class < 0))
    if not is_writer() and not sharded:
        return {}
    summary = {"dataset": cfg.name, "mode": "graph" if ex.graph_mode else "node"}
    if mesh is not None:
        summary["mesh_devices"] = n
    if cfg.explain_node is not None:
        if cfg.explainer_model != "exp":
            masked_adj = ex.explain(cfg.explain_node, model=cfg.explainer_model)
            new_idx = ex.extract_neighborhood(cfg.explain_node)[0]
        else:
            if cfg.use_bcsr:
                rs = ex.explain_nodes_bcsr([cfg.explain_node],
                                           block=cfg.bcsr_block, mesh=mesh)
            else:
                rs = ex.explain_nodes_batch([cfg.explain_node], mesh=mesh)
            if rs is None:
                return {}
            r = rs[0]
            masked_adj, new_idx = r["masked_adj"], r["node_idx_new"]
            ex._save_npy(masked_adj, cfg.explain_node)
            if cfg.log_mask_every > 0 and "masked_w" in r["history"]:
                summary["mask_heatmaps"] = _mask_heatmaps(
                    ex, r, cfg.log_mask_every, "mask/masked_adj")
        summary["explain_node"] = cfg.explain_node
        summary["mask_shape"] = list(masked_adj.shape)
        G = denoise_graph(masked_adj, new_idx, threshold_num=12)
        summary["viz"] = log_graph(G, f"node_{cfg.explain_node}", outdir=ex.logdir)
    elif ex.graph_mode:
        if cfg.multigraph_class >= 0:
            labels = np.asarray(ex.label).reshape(-1)
            graph_indices = [i for i, lab in enumerate(labels)
                             if lab == cfg.multigraph_class][:31]
            masked = ex.explain_graphs(graph_indices)
            summary["graph_indices"] = graph_indices
        elif cfg.graph_idx == -1:
            graph_indices = [1, 2, 3, 4]
            masked = ex.explain_graphs(graph_indices)
            summary["graph_indices"] = graph_indices
        else:
            masked_adj = ex.explain(node_idx=0, graph_idx=cfg.graph_idx,
                                    graph_mode=True)
            graph_indices, masked = [cfg.graph_idx], [masked_adj]
            summary["graph_idx"] = cfg.graph_idx
            summary["mask_shape"] = list(masked_adj.shape)
        viz = []
        for gi, ma in zip(graph_indices, masked):
            G = denoise_graph(ma, 0, threshold_num=20, max_component=False)
            if G.number_of_nodes():
                viz.append(log_graph(G, f"graph_{gi}", outdir=ex.logdir))
        summary["viz"] = viz
    elif cfg.multinode_class >= 0:
        labels = np.asarray(ex.label[0])
        node_indices = [i for i, lab in enumerate(labels)
                        if lab == cfg.multinode_class][:5]
        ex.align_steps = cfg.align_steps
        ex.explain_nodes(node_indices)
        summary["num_nodes_explained"] = len(node_indices)
        summary["aligned"] = ex.last_alignment is not None
    else:
        node_indices = list(range(400, 700, 5))
        res = ex.explain_nodes_gnn_stats(node_indices,
                                         model=cfg.explainer_model, mesh=mesh)
        if res is None:
            return {}
        summary["num_nodes_explained"] = len(node_indices)
        summary["auc"] = res["auc"]
        if cfg.log_mask_every > 0:
            summary["mask_heatmaps"] = sum(
                _mask_heatmaps(ex, r, cfg.log_mask_every,
                               f"mask/masked_adj_node{r['node_idx']}")
                for r in res["results"] if "masked_w" in r.get("history", {}))
        for r in res["results"][:4]:
            G = denoise_graph(r["masked_adj"], r["node_idx_new"], threshold_num=20)
            log_graph(G, f"graph_{cfg.name}_{cfg.explainer_model}_{r['node_idx']}",
                      outdir=ex.logdir)
        if cfg.explainer_model == "exp" and res["results"]:
            # tpugraph writes every history term, and its 2-D masked_w (with
            # --log-mask-every) fails float(); the port writes the 1-D terms
            writer = SummaryWriter(ex.logdir)
            for term, values in res["results"][0].get("history", {}).items():
                values = np.asarray(values)
                if values.ndim == 1:
                    for epoch, v in enumerate(values.tolist()):
                        writer.add_scalar(f"optimization/{term}_loss", v, epoch)
            writer.close()
            r0 = res["results"][0]
            save_matrix_image(r0["masked_adj"], "mask/adj", outdir=ex.logdir)
            if "feat_mask" in r0:
                save_matrix_image(r0["feat_mask"][None], "mask/feat_mask",
                                  outdir=ex.logdir)
    print(json.dumps(summary, indent=2, default=float))
    return summary


if __name__ == "__main__":
    main()
