"""Port of ``tpugraph/cli/tasks.py``: build the dataset and the model,
train, then save the checkpoint with the dense cg bundle.

Every single-device task of ``tpugraph``: syn1–syn5, ``ppi_essential``
(class-weighted), ``enron`` (the slices' disjoint union) and
``enron_multigraph`` (the slices as one stack) node classification;
``--bmname`` graph classification on a TU-format dataset
(``benchmark_task``), its 10-fold cross-validation
(``benchmark_task_val``, which no flag reaches, as in ``tpugraph``) and
``--pkl`` graph classification on pickled networkx graphs, read without
networkx (:func:`tpugraph_torch.data.readers.load_graph_pickle`).

``--halo N`` trains a node task on ``N`` node shards
(:func:`~tpugraph_torch.train.loop.train_node_classifier_halo`) and
``--dp N`` splits graph classification's batches over ``N`` ranks.  Called
outside a process group, such a task spawns its ranks
(:func:`~tpugraph_torch.parallel.launch.run_ranks`) and returns rank 0's
result; in a group, rank 0 alone writes the checkpoint.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

import torch.distributed as dist

from tpugraph_torch.cli.config import (Config, check_ported, cli_device,
                                       rank_backend)
from tpugraph_torch.core.graph import Graph, graph_from_edge_list, graph_from_edges
from tpugraph_torch.data import GENERATORS, ConstFeatureGen, preprocess_input_graph
from tpugraph_torch.data.pipeline import GraphBatcher, prepare_data, to_numpy_array
from tpugraph_torch.data.readers import (ENRON_LABELS, disjoint_union_all,
                                         load_enron_slices, load_graph_pickle,
                                         read_biosnap, read_graphfile)
from tpugraph_torch.data.shapes import SimpleGraph
from tpugraph_torch.nn import (DeeperGcnEncoderNode, GatEncoderNode, GcnEncoderGraph,
                               GcnEncoderNode, SoftPoolingGcnEncoder)
from tpugraph_torch.train.checkpoint import (gen_prefix, load_checkpoint,
                                             save_checkpoint)
from tpugraph_torch.train.loop import (TrainConfig, train_graph_classifier,
                                       train_node_classifier,
                                       train_node_classifier_halo)
from tpugraph_torch.train.multigraph import train_node_classifier_multigraph


def is_writer() -> bool:
    """Whether this process writes the outputs: rank 0 of a process group,
    or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _spawned(cfg: Config, n: int, fn, *args):
    """``fn(*args)`` in ``n`` new ranks when ``n > 1`` and no process group
    is active (rank 0's result); ``None`` otherwise, and the caller runs
    in this process."""
    if n <= 1 or dist.is_initialized():
        return None
    from tpugraph_torch.parallel.launch import run_ranks

    return run_ranks(fn, n, rank_backend(cfg), *args)


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
                     device=None):
    """``GcnEncoderNode`` at the configured widths, its parameters drawn
    from a generator seeded with ``cfg.seed`` (``tpugraph/cli/tasks.py:50``;
    JAX draws them from ``PRNGKey(seed)``); for ``--method gat`` the port's
    :class:`GatEncoderNode`: ``--num-gc-layers`` layers of ``--num-heads``
    heads ``--hidden-dim`` wide, ``--dropout`` after the hidden ones; for
    ``--method deepergcn`` the port's :class:`DeeperGcnEncoderNode`:
    ``--num-gc-layers`` res+ GENConv blocks ``--hidden-dim`` wide, ``t``
    0.1, ``--dropout`` after each block's ReLU."""
    if cfg.method == "gat":
        return GatEncoderNode(
            input_dim=input_dim, head_dim=cfg.hidden_dim, label_dim=num_classes,
            num_layers=cfg.num_gc_layers, num_heads=cfg.num_heads,
            dropout=cfg.dropout,
            generator=torch.Generator().manual_seed(cfg.seed), device=device)
    if cfg.method == "deepergcn":
        return DeeperGcnEncoderNode(
            input_dim=input_dim, hidden_dim=cfg.hidden_dim, label_dim=num_classes,
            num_layers=cfg.num_gc_layers, dropout=cfg.dropout,
            generator=torch.Generator().manual_seed(cfg.seed), device=device)
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


def _edges_in_order(G: SimpleGraph):
    index = {u: i for i, u in enumerate(G.nodes())}
    return [(index[u], index[v]) for u, v in G.edges()]


def node_task_model(cfg: Config, G: SimpleGraph, labels, device):
    """The node task's model on ``device``, its graph in ``G.nodes()``
    order and its padded features, as :func:`run_node_task` builds them."""
    g = graph_from_edge_list(G.number_of_nodes(), _edges_in_order(G))
    feat = padded_features(G, g)
    return build_node_model(cfg, feat.shape[1], int(max(labels)) + 1, device), g, feat


def run_node_task(cfg: Config, G: SimpleGraph, labels,
                  class_weight: Optional[np.ndarray] = None, log_fn=None) -> Dict:
    """Padded graph, training on ``--platform``'s device (the loss weighed
    by ``class_weight`` when given), and the checkpoint with the dense cg
    bundle, the optimizer state and ``meta``
    (``tpugraph/cli/tasks.py:64-176``).  ``--resume`` starts from the
    checkpoint's ``params.pt`` (or ``tpugraph``'s ``params.msgpack``) and
    ``opt_state.pt`` when it has one, trains ``--epochs`` more and
    overwrites it.  ``--halo N`` trains on ``N`` node shards, in ``N``
    ranks it spawns when no group is active."""
    check_ported(cfg)
    spawned = _spawned(cfg, cfg.halo_devices, run_node_task, cfg, G, labels,
                       class_weight)
    if spawned is not None:
        return spawned
    device = cli_device(cfg)
    num_classes = int(max(labels)) + 1
    model, g, feat = node_task_model(cfg, G, labels, device)
    prefix = gen_prefix(cfg.name, cfg.method, cfg.hidden_dim, cfg.output_dim,
                        cfg.bias, cfg.name_suffix)
    if cfg.halo_devices > 1:
        out = train_node_classifier_halo(
            model, g, feat, labels, train_config(cfg), n_dev=cfg.halo_devices,
            overlap=cfg.halo_overlap, class_weight=class_weight,
            seed=cfg.seed, log_fn=log_fn)
    else:
        init_params = init_opt = None
        if cfg.resume:
            ck = load_checkpoint(cfg.ckptdir, prefix)
            init_params, init_opt = ck["params"], ck["opt_state"]
        out = train_node_classifier(model, g, feat, labels, train_config(cfg),
                                    seed=cfg.seed, log_fn=log_fn, device=device,
                                    init_params=init_params,
                                    init_opt_state=init_opt,
                                    class_weight=class_weight)
    data = preprocess_input_graph(G, labels)
    n_real = data["adj"].shape[1]
    cg = {
        "adj": data["adj"],
        "feat": data["feat"],
        "label": data["labels"],
        "pred": out["ypred"][:, :n_real],
        "train_idx": out["train_idx"],
    }
    path = None if not is_writer() else save_checkpoint(
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
            "num_heads": cfg.num_heads,
            "result_train": {k: v for k, v in out["result_train"].items()
                             if k != "conf_mat"},
            "result_test": {k: v for k, v in out["result_test"].items()
                            if k != "conf_mat"},
        },
    )
    out["ckpt_path"] = path
    out["cg"] = cg
    return out


def node_task_data(cfg: Config) -> Tuple[SimpleGraph, np.ndarray, Optional[np.ndarray]]:
    """The graph, labels and loss class weight of ``cfg``'s single-graph
    node task: syn1–syn5 with constant features, but syn2's own Gaussian
    community features (``tpugraph/cli/tasks.py:179``); Enron's roles over
    the disjoint union of the 10 pickled slices (``:190``); ppi_essential,
    read from ``<datadir>/ppi_essential``, with the class weight ``[1, 5]``
    (``:202``)."""
    if cfg.dataset in GENERATORS:
        gen = GENERATORS[cfg.dataset]
        if cfg.dataset == "syn2":
            G, labels, _ = gen(seed=cfg.seed)
        else:
            const_feat = ConstFeatureGen(np.ones(cfg.input_dim, dtype=np.float32))
            G, labels, _ = gen(feature_generator=const_feat, seed=cfg.seed)
        return G, np.asarray(labels), None
    if cfg.dataset == "enron":
        G = disjoint_union_all(load_enron_slices(cfg.datadir, input_dim=cfg.input_dim))
        return G, np.array([ENRON_LABELS[G.attrs.get(u, {}).get("role", "None")]
                            for u in G.nodes()]), None
    if cfg.dataset == "ppi_essential":
        G = read_biosnap(os.path.join(cfg.datadir, "ppi_essential"),
                         "hi-union-ppi.tsv", "G-HumanEssential.tsv",
                         feat_file="G-MtfPathways_gene-motifs.csv")
        return (G, np.array([G.attrs[u]["label"] for u in G.nodes()]),
                np.array([1.0, 5.0], np.float32))
    raise ValueError(f"unknown dataset {cfg.dataset!r}")


def node_task(cfg: Config, log_fn=None) -> Dict:
    """:func:`run_node_task` on :func:`node_task_data`."""
    G, labels, class_weight = node_task_data(cfg)
    return run_node_task(cfg, G, labels, class_weight=class_weight, log_fn=log_fn)


def enron_multigraph_task(cfg: Config, log_fn=None) -> Dict:
    """Enron as the 10 slices trained together by one model
    (``tpugraph/cli/tasks.py:321``): every slice padded to the largest
    node id (added nodes have no features, as in ``tpugraph``, whose
    feature read then fails) and to one edge budget, and the checkpoint
    with the stacked cg bundle."""
    device = cli_device(cfg)
    G_list = load_enron_slices(cfg.datadir, input_dim=cfg.input_dim)
    max_id = max(max(G.nodes()) for G in G_list) + 1
    e_pad = max(((2 * G.number_of_edges() + 7) // 8) * 8 for G in G_list)
    labels, graphs, feats = [], [], []
    for G in G_list:
        G.add_nodes_from(range(max_id))
        labels.append([ENRON_LABELS[G.attrs.get(u, {}).get("role", "None")]
                       for u in G.nodes()])
        s, r = [], []
        for u, v in _edges_in_order(G):
            s.append(u)
            r.append(v)
            if u != v:
                s.append(v)
                r.append(u)
        g = graph_from_edges(np.asarray(s, np.int32), np.asarray(r, np.int32),
                             G.number_of_nodes(), num_edges_padded=e_pad)
        graphs.append(g)
        feats.append(padded_features(G, g))
    model = build_node_model(cfg, feats[0].shape[1], max(ENRON_LABELS.values()) + 1,
                             device)
    out = train_node_classifier_multigraph(model, graphs, np.stack(feats),
                                           np.asarray(labels), train_config(cfg),
                                           seed=cfg.seed, log_fn=log_fn,
                                           device=device)
    n_real = int(graphs[0].n_node)
    cg = {
        "adj": np.stack([to_numpy_array(G).astype(np.float32) for G in G_list]),
        "feat": np.stack(feats)[:, :n_real],
        "label": np.asarray(labels),
        "pred": out["ypred"][:, :n_real],
        "train_idx": out["train_idx"],
    }
    prefix = gen_prefix(cfg.name, cfg.method, cfg.hidden_dim, cfg.output_dim,
                        cfg.bias, cfg.name_suffix)
    out["ckpt_path"] = save_checkpoint(cfg.ckptdir, prefix, out["params"], cg_dict=cg,
                                       meta={"model_type": cfg.method,
                                             "task": "node_multigraph"})
    out["cg"] = cg
    return out


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
    device (with ``--dp N`` on ``N`` ranks, spawned when no group is
    active), and the checkpoint with the graph cg bundle and ``meta``."""
    spawned = _spawned(cfg, cfg.dp_devices, benchmark_task, cfg, None, feat)
    if spawned is not None:
        return spawned
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
    mesh = None
    if cfg.dp_devices > 1:
        from tpugraph_torch.parallel.mesh import make_mesh

        mesh = make_mesh(cfg.dp_devices)
    out = train_graph_classifier(
        model, train_b, train_config(cfg), val_batcher=val_b,
        test_batcher=test_b,
        linkpred=(cfg.method == "soft-assign" and cfg.linkpred),
        seed=cfg.seed, log_fn=log_fn, mesh=mesh, device=device)
    prefix = gen_prefix(cfg.name, cfg.method, cfg.hidden_dim, cfg.output_dim,
                        cfg.bias, cfg.name_suffix)
    out["ckpt_path"] = None if not is_writer() else save_checkpoint(
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


def _const_features(cfg: Config, graphs) -> None:
    const = ConstFeatureGen(np.ones(cfg.input_dim, dtype=np.float32))
    for G in graphs:
        const.gen_node_features(G)


def pkl_task(cfg: Config, log_fn=None) -> Dict:
    """Graph classification from a pickled ``(graphs, labels[,
    test_graphs, test_labels])`` bundle of networkx graphs
    (``tpugraph/cli/tasks.py:375``): constant features where a graph has
    none, unnormalized batches padded to the largest graph, no
    checkpoint."""
    device = cli_device(cfg)
    data = load_graph_pickle(os.path.join(cfg.datadir, cfg.pkl_fname))
    graphs, labels = data[0], data[1]
    test_graphs = data[2] if len(data) > 2 else []
    test_labels = data[3] if len(data) > 3 else []
    for i, G in enumerate(graphs):
        G.graph["label"] = labels[i]
    for i, G in enumerate(test_graphs):
        G.graph["label"] = test_labels[i]
    _const_features(cfg, [G for G in list(graphs) + list(test_graphs)
                          if G.nodes()[0] not in G.feat])
    max_nodes = max(G.number_of_nodes() for G in list(graphs) + list(test_graphs))
    train_b = GraphBatcher(graphs, normalize=False, max_num_nodes=max_nodes,
                           features=cfg.feature_type)
    test_b = (GraphBatcher(test_graphs, normalize=False, max_num_nodes=max_nodes,
                           features=cfg.feature_type) if test_graphs else None)
    num_classes = int(max(G.graph["label"] for G in graphs)) + 1
    model = GcnEncoderGraph(
        input_dim=train_b.feat_dim, hidden_dim=cfg.hidden_dim,
        embedding_dim=cfg.output_dim, label_dim=num_classes,
        num_layers=cfg.num_gc_layers, bn=cfg.bn, dropout=cfg.dropout,
        use_bias=cfg.bias, generator=torch.Generator().manual_seed(cfg.seed),
        device=device)
    return train_graph_classifier(model, train_b, train_config(cfg),
                                  test_batcher=test_b, seed=cfg.seed,
                                  log_fn=log_fn, device=device)


def benchmark_task_val(cfg: Config, log_fn=None, feat: str = "node-label",
                       n_splits: int = 10) -> Dict:
    """``n_splits``-fold cross-validated graph classification
    (``tpugraph/cli/tasks.py:424``): the folds of one seeded permutation,
    fold ``i`` validating a model trained on the rest with seed ``seed +
    i``; returns the mean validation accuracy at each evaluation
    (``val_acc_mean``), its best value and where it is."""
    device = cli_device(cfg)
    graphs = read_graphfile(cfg.datadir, cfg.bmname, max_nodes=cfg.max_nodes)
    if feat == "node-label" and graphs[0].nodes()[0] in graphs[0].node_label:
        for G in graphs:
            G.feat = {u: np.asarray(lab, dtype=np.float32)
                      for u, lab in G.node_label.items()}
    else:
        _const_features(cfg, graphs)
    num_classes = max(G.graph["label"] for G in graphs) + 1
    order = np.random.default_rng(cfg.seed).permutation(len(graphs))
    folds = np.array_split(order, n_splits)
    max_nodes = cfg.max_nodes or max(G.number_of_nodes() for G in graphs)
    all_vals = []
    for i in range(n_splits):
        train_idx = np.concatenate([folds[j] for j in range(n_splits) if j != i])
        train_b = GraphBatcher([graphs[k] for k in train_idx], normalize=False,
                               max_num_nodes=max_nodes)
        val_b = GraphBatcher([graphs[k] for k in folds[i]], normalize=False,
                             max_num_nodes=max_nodes)
        model = GcnEncoderGraph(
            input_dim=train_b.feat_dim, hidden_dim=cfg.hidden_dim,
            embedding_dim=cfg.output_dim, label_dim=num_classes,
            num_layers=cfg.num_gc_layers, bn=cfg.bn, dropout=cfg.dropout,
            use_bias=cfg.bias,
            generator=torch.Generator().manual_seed(cfg.seed + i), device=device)
        out = train_graph_classifier(model, train_b, train_config(cfg),
                                     val_batcher=val_b, seed=cfg.seed + i,
                                     log_fn=log_fn, device=device)
        all_vals.append(out["history"]["val_acc"])
    lens = min(len(v) for v in all_vals)
    mean_vals = np.mean([v[:lens] for v in all_vals], axis=0)
    return {"val_acc_mean": mean_vals.tolist(),
            "best_val_acc": float(np.max(mean_vals)),
            "best_epoch_idx": int(np.argmax(mean_vals))}


def run_task(cfg: Config, log_fn=None) -> Dict:
    """The task ``cfg`` names (``tpugraph/cli/tasks.py:482``): ``--bmname``
    graph classification, ``--pkl``, syn1–syn5, enron, enron_multigraph or
    ppi_essential; ``--mesh`` raises by name."""
    check_ported(cfg)
    if cfg.bmname is not None:
        return benchmark_task(cfg, log_fn=log_fn)
    if cfg.pkl_fname is not None:
        return pkl_task(cfg, log_fn=log_fn)
    if cfg.dataset == "enron_multigraph":
        return enron_multigraph_task(cfg, log_fn=log_fn)
    return node_task(cfg, log_fn=log_fn)
