"""Port of ``tpugraph/cli/tasks.py``: build the dataset and the model,
train, then save the checkpoint with the dense cg bundle.

syn1–syn5 node classification and ``--bmname`` graph classification on a
TU-format dataset (``benchmark_task``), on one device; the other tasks
(cross-validation, ``--pkl``, enron, ppi) raise by name
(:func:`tpugraph_torch.cli.config.check_ported`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from tpugraph_torch.cli.config import Config, check_ported, cli_device
from tpugraph_torch.core.graph import Graph, graph_from_edge_list
from tpugraph_torch.data import GENERATORS, ConstFeatureGen, preprocess_input_graph
from tpugraph_torch.data.pipeline import prepare_data
from tpugraph_torch.data.readers import read_graphfile
from tpugraph_torch.data.shapes import SimpleGraph
from tpugraph_torch.nn import GcnEncoderGraph, GcnEncoderNode, SoftPoolingGcnEncoder
from tpugraph_torch.train.checkpoint import (gen_prefix, load_checkpoint,
                                             save_checkpoint)
from tpugraph_torch.train.loop import (TrainConfig, train_graph_classifier,
                                       train_node_classifier)


def padded_features(G: SimpleGraph, g: Graph) -> np.ndarray:
    """``[N_pad, D]`` features in ``G.nodes()`` order
    (``tpugraph/cli/tasks.py:18``)."""
    nodes = G.nodes()
    d = G.feat[nodes[-1]].shape[0]
    feat = np.zeros((g.num_nodes_padded, d), dtype=np.float32)
    for i, u in enumerate(nodes):
        feat[i] = G.feat[u]
    return feat


def train_config(cfg: Config) -> TrainConfig:
    """The fields of ``TrainConfig`` the loops read
    (``tpugraph/cli/tasks.py:29``)."""
    return TrainConfig(
        num_epochs=cfg.num_epochs,
        lr=cfg.lr,
        clip=cfg.clip,
        weight_decay=cfg.weight_decay,
        train_ratio=cfg.train_ratio,
        batch_size=cfg.batch_size,
        eval_every=cfg.eval_every,
        opt=cfg.opt,
        opt_scheduler=cfg.opt_scheduler,
        opt_decay_step=cfg.opt_decay_step,
        opt_decay_rate=cfg.opt_decay_rate,
        opt_restart=cfg.opt_restart,
        use_bcsr=cfg.use_bcsr,
        bcsr_block=cfg.bcsr_block,
        bcsr_format=cfg.bcsr_format,
    )


def build_node_model(cfg: Config, input_dim: int, num_classes: int,
                     device=None) -> GcnEncoderNode:
    """``GcnEncoderNode`` at the configured widths, its parameters drawn
    from a generator seeded with ``cfg.seed`` (``tpugraph/cli/tasks.py:50``;
    JAX draws them from ``PRNGKey(seed)``)."""
    return GcnEncoderNode(
        input_dim=input_dim,
        hidden_dim=cfg.hidden_dim,
        embedding_dim=cfg.output_dim,
        label_dim=num_classes,
        num_layers=cfg.num_gc_layers,
        bn=cfg.bn,
        dropout=cfg.dropout,
        use_bias=cfg.bias,
        att=(cfg.method == "att"),
        generator=torch.Generator().manual_seed(cfg.seed),
        device=device,
    )


def run_node_task(cfg: Config, G: SimpleGraph, labels, log_fn=None) -> Dict:
    """Padded graph, training on ``--platform``'s device, and the
    checkpoint with the dense cg bundle, the optimizer state and ``meta``
    (``tpugraph/cli/tasks.py:64-176``, single device).  ``--resume``
    starts from the checkpoint's ``params.pt`` (or ``tpugraph``'s
    ``params.msgpack``) and ``opt_state.pt`` when it has one, trains
    ``--epochs`` more and overwrites it."""
    device = cli_device(cfg)
    num_classes = int(max(labels)) + 1
    index = {u: i for i, u in enumerate(G.nodes())}
    g = graph_from_edge_list(G.number_of_nodes(),
                             [(index[u], index[v]) for u, v in G.edges()])
    feat = padded_features(G, g)
    model = build_node_model(cfg, feat.shape[1], num_classes, device)
    prefix = gen_prefix(cfg.name, cfg.method, cfg.hidden_dim, cfg.output_dim,
                        cfg.bias, cfg.name_suffix)
    init_params = init_opt = None
    if cfg.resume:
        ck = load_checkpoint(cfg.ckptdir, prefix)
        init_params, init_opt = ck["params"], ck["opt_state"]
    out = train_node_classifier(model, g, feat, labels, train_config(cfg),
                                seed=cfg.seed, log_fn=log_fn, device=device,
                                init_params=init_params,
                                init_opt_state=init_opt)
    data = preprocess_input_graph(G, labels)
    n_real = data["adj"].shape[1]
    cg = {
        "adj": data["adj"],
        "feat": data["feat"],
        "label": data["labels"],
        "pred": out["ypred"][:, :n_real],
        "train_idx": out["train_idx"],
    }
    path = save_checkpoint(
        cfg.ckptdir,
        prefix,
        out["params"],
        cg_dict=cg,
        opt_state=out["opt_state"],
        meta={
            "model_type": cfg.method,
            "task": "node",
            "input_dim": feat.shape[1],
            "num_classes": num_classes,
            "num_gc_layers": cfg.num_gc_layers,
            "hidden_dim": cfg.hidden_dim,
            "output_dim": cfg.output_dim,
            "bn": cfg.bn,
            "result_train": {k: v for k, v in out["result_train"].items()
                             if k != "conf_mat"},
            "result_test": {k: v for k, v in out["result_test"].items()
                            if k != "conf_mat"},
        },
    )
    out["ckpt_path"] = path
    out["cg"] = cg
    return out


def syn_task(cfg: Config, log_fn=None) -> Dict:
    """syn1–syn5 node classification (``tpugraph/cli/tasks.py:179``):
    constant features, but syn2's own Gaussian community features."""
    gen = GENERATORS[cfg.dataset]
    if cfg.dataset == "syn2":
        G, labels, _ = gen(seed=cfg.seed)
    else:
        const_feat = ConstFeatureGen(np.ones(cfg.input_dim, dtype=np.float32))
        G, labels, _ = gen(feature_generator=const_feat, seed=cfg.seed)
    return run_node_task(cfg, G, labels, log_fn=log_fn)


def build_graph_model(cfg: Config, train_b, num_classes: int, device=None):
    """``SoftPoolingGcnEncoder`` for ``--method soft-assign``, else
    ``GcnEncoderGraph`` (attention with ``--method att``), at the
    configured widths and the batcher's input widths, its parameters drawn
    from a generator seeded with ``cfg.seed`` (``tpugraph/cli/tasks.py:
    246-274``; JAX draws them from ``PRNGKey(seed)``)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    if cfg.method == "soft-assign":
        return SoftPoolingGcnEncoder(
            max_num_nodes=train_b.max_num_nodes,
            input_dim=train_b.feat_dim,
            hidden_dim=cfg.hidden_dim,
            embedding_dim=cfg.output_dim,
            label_dim=num_classes,
            num_layers=cfg.num_gc_layers,
            assign_hidden_dim=cfg.hidden_dim,
            assign_ratio=cfg.assign_ratio,
            num_pooling=cfg.num_pool,
            bn=cfg.bn,
            dropout=cfg.dropout,
            assign_input_dim=train_b.assign_feat_dim,
            use_bias=cfg.bias,
            generator=gen,
            device=device,
        )
    return GcnEncoderGraph(
        input_dim=train_b.feat_dim,
        hidden_dim=cfg.hidden_dim,
        embedding_dim=cfg.output_dim,
        label_dim=num_classes,
        num_layers=cfg.num_gc_layers,
        bn=cfg.bn,
        dropout=cfg.dropout,
        use_bias=cfg.bias,
        att=(cfg.method == "att"),
        generator=gen,
        device=device,
    )


def benchmark_task(cfg: Config, log_fn=None, feat: str = "node-label") -> Dict:
    """TU-format graph classification (``tpugraph/cli/tasks.py:220``): read
    ``<datadir>/<bmname>`` (graphs over ``--max-nodes`` dropped), node
    features from the one-hot node labels (``feat="node-label"``, when the
    dataset has them), from ``_node_attributes`` (``"node-feat"``) or
    constant, the seeded shuffle and split, training on ``--platform``'s
    device, and the checkpoint with the graph cg bundle and ``meta``."""
    device = cli_device(cfg)
    graphs = read_graphfile(cfg.datadir, cfg.bmname, max_nodes=cfg.max_nodes)
    if feat == "node-feat" and "feat_dim" in graphs[0].graph:
        pass  # the reader attached them
    elif feat == "node-label" and 0 in graphs[0].node_label:
        for G in graphs:
            G.feat = {u: np.asarray(lab, dtype=np.float32)
                      for u, lab in G.node_label.items()}
    else:
        const = ConstFeatureGen(np.ones(cfg.input_dim, dtype=np.float32))
        for G in graphs:
            const.gen_node_features(G)
    num_classes = max(G.graph["label"] for G in graphs) + 1
    train_b, val_b, test_b = prepare_data(
        graphs, train_ratio=cfg.train_ratio, test_ratio=cfg.test_ratio,
        features=cfg.feature_type, max_nodes=cfg.max_nodes,
        rng=np.random.default_rng(cfg.seed))
    model = build_graph_model(cfg, train_b, num_classes, device)
    out = train_graph_classifier(
        model, train_b, train_config(cfg), val_batcher=val_b,
        test_batcher=test_b,
        linkpred=(cfg.method == "soft-assign" and cfg.linkpred),
        seed=cfg.seed, log_fn=log_fn, device=device)
    prefix = gen_prefix(cfg.name, cfg.method, cfg.hidden_dim, cfg.output_dim,
                        cfg.bias, cfg.name_suffix)
    out["ckpt_path"] = save_checkpoint(
        cfg.ckptdir,
        prefix,
        out["params"],
        cg_dict=out["cg"],
        meta={
            "model_type": cfg.method,
            "task": "graph",
            "input_dim": train_b.feat_dim,
            "assign_input_dim": train_b.assign_feat_dim,
            "max_num_nodes": train_b.max_num_nodes,
            "num_classes": int(num_classes),
            "num_gc_layers": cfg.num_gc_layers,
            "hidden_dim": cfg.hidden_dim,
            "output_dim": cfg.output_dim,
            "bn": cfg.bn,
            "best_val": out["best_val"],
            "test_result": out["test_result"],
        },
    )
    return out


def run_task(cfg: Config, log_fn=None) -> Dict:
    """The task ``cfg`` names (``tpugraph/cli/tasks.py:482``): ``--bmname``
    graph classification or syn1–syn5; unported flags raise by name."""
    check_ported(cfg)
    if cfg.bmname is not None:
        return benchmark_task(cfg, log_fn=log_fn)
    if cfg.dataset in GENERATORS:
        return syn_task(cfg, log_fn=log_fn)
    raise ValueError(f"unknown dataset {cfg.dataset!r}")
