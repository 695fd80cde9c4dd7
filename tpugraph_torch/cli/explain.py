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
No graph renders, heatmaps or TensorBoard events are written yet
(ROADMAP section 1 item 10), and the summary has no key for them.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from tpugraph_torch.cli.config import (Config, check_ported, cli_device,
                                       parse_explain_args)
from tpugraph_torch.explain.explainer import Explainer
from tpugraph_torch.explain.module import ExplainConfig
from tpugraph_torch.nn import GcnEncoderGraph, GcnEncoderNode
from tpugraph_torch.train.checkpoint import (gen_explainer_prefix, gen_prefix,
                                             load_checkpoint)


def build_explainer(cfg: Config) -> Explainer:
    """An :class:`Explainer` over the checkpoint ``cfg`` names, on
    ``--platform``'s device, logging under
    ``<logdir>/<prefix>_explain[_suffix]`` (``tpugraph/cli/explain.py:27``)."""
    check_ported(cfg)
    device = cli_device(cfg)
    prefix = gen_prefix(cfg.name, cfg.method, cfg.hidden_dim, cfg.output_dim,
                        cfg.bias, cfg.name_suffix)
    ckpt = load_checkpoint(cfg.ckptdir, prefix)
    cg = ckpt["cg"]
    if cg is None:
        raise ValueError(f"checkpoint {prefix} has no cg bundle")
    # the trained model's options come from its meta (tpugraph reads them
    # from the flags, which must then repeat the training's)
    meta = ckpt["meta"] or {}
    model_type = meta.get("model_type", cfg.method)
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
        print_training=True,
        seed=cfg.seed,
        device=device,
    )


def main(argv=None) -> Dict:
    """Run the explainer on ``argv`` (``sys.argv`` when ``None``); returns
    the summary it prints."""
    cfg = parse_explain_args(argv)
    ex = build_explainer(cfg)
    summary = {"dataset": cfg.name, "mode": "graph" if ex.graph_mode else "node"}
    if cfg.explain_node is not None:
        if cfg.explainer_model != "exp":
            masked_adj = ex.explain(cfg.explain_node, model=cfg.explainer_model)
        else:
            if cfg.use_bcsr:
                r = ex.explain_node_bcsr(cfg.explain_node, block=cfg.bcsr_block)
            else:
                r = ex.explain_nodes_batch([cfg.explain_node])[0]
            masked_adj = r["masked_adj"]
            ex._save_npy(masked_adj, cfg.explain_node)
        summary["explain_node"] = cfg.explain_node
        summary["mask_shape"] = list(masked_adj.shape)
    elif ex.graph_mode:
        if cfg.multigraph_class >= 0:
            labels = np.asarray(ex.label).reshape(-1)
            graph_indices = [i for i, lab in enumerate(labels)
                             if lab == cfg.multigraph_class][:31]
            ex.explain_graphs(graph_indices)
            summary["graph_indices"] = graph_indices
        elif cfg.graph_idx == -1:
            graph_indices = [1, 2, 3, 4]
            ex.explain_graphs(graph_indices)
            summary["graph_indices"] = graph_indices
        else:
            masked_adj = ex.explain(node_idx=0, graph_idx=cfg.graph_idx,
                                    graph_mode=True)
            summary["graph_idx"] = cfg.graph_idx
            summary["mask_shape"] = list(masked_adj.shape)
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
                                         model=cfg.explainer_model)
        summary["num_nodes_explained"] = len(node_indices)
        summary["auc"] = res["auc"]
    print(json.dumps(summary, indent=2, default=float))
    return summary


if __name__ == "__main__":
    main()
