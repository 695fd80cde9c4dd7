"""Port of ``tpugraph/cli/config.py``: one dataclass of every knob with the
reference's defaults, and the argparse layers of the trainer and the
explainer.

The flags are ``tpugraph``'s.  ``--platform`` picks the device: unset
means the CUDA card, ``cpu`` the CPU.  ``--halo N`` and ``--dp N`` run
on ``N`` ranks, as does the explainer's ``--mesh N`` (:func:`rank_count`;
NCCL with a card a rank, or gloo with ``--platform cpu``).
There is no compile cache: PyTorch runs eagerly.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import torch

from tpugraph_torch._device import default_device


@dataclasses.dataclass
class Config:
    # io (reference configs.py:6-13, 75-80)
    dataset: str = "syn1"
    bmname: Optional[str] = None
    pkl_fname: Optional[str] = None
    datadir: str = "data"
    logdir: str = "log"
    ckptdir: str = "ckpt"

    # model (reference configs.py:86-99)
    method: str = "base"          # base | att | soft-assign | gat | deepergcn
    num_heads: int = 3            # --method gat: attention heads a layer
    input_dim: int = 10
    hidden_dim: int = 20
    output_dim: int = 20
    num_classes: int = 2
    num_gc_layers: int = 3
    bn: bool = False
    dropout: float = 0.0
    bias: bool = True
    name_suffix: str = ""

    # diffpool (reference configs.py:15-22, 101)
    assign_ratio: float = 0.1
    num_pool: int = 1
    linkpred: bool = False

    # optimization (reference configs.py:81-92)
    opt: str = "adam"
    opt_scheduler: str = "none"
    opt_restart: int = 200
    opt_decay_step: int = 100
    opt_decay_rate: float = 0.1
    lr: float = 0.001
    clip: float = 2.0
    batch_size: int = 20
    num_epochs: int = 1000
    train_ratio: float = 0.8
    test_ratio: float = 0.1
    weight_decay: float = 0.005
    max_nodes: int = 100
    feature_type: str = "default"

    # explainer (reference explainer_main.py:143-167)
    explainer_epochs: int = 100
    explainer_lr: float = 0.1
    mask_act: str = "sigmoid"     # sigmoid | ReLU | none
    mask_bias: bool = False
    explain_node: Optional[int] = None
    graph_mode: bool = False
    graph_idx: int = -1
    multigraph_class: int = -1
    multinode_class: int = -1
    align_steps: int = 1000
    explainer_suffix: str = ""
    seed_ensemble: int = 1  # >1: average masks over several init seeds
    marginalize: bool = False    # noise-marginalized feature masking
    log_mask_every: int = 0      # >0: mask/masked-adj heatmaps every k epochs
    explainer_model: str = "exp"  # exp | grad | att (set by the explain CLI)

    # runtime
    resume: bool = False
    seed: int = 0
    eval_every: int = 25
    platform: Optional[str] = None  # None = the CUDA card, "cpu" = the CPU
    num_devices: int = 0            # 0 = all visible
    use_bcsr: bool = False          # block-sparse aggregation (B1/B3/B7)
    bcsr_block: int = 128
    bcsr_format: str = "auto"       # auto | tiles | packets
    dp_devices: int = 1             # >1: data-parallel graph training
    halo_devices: int = 1           # >1: node-partitioned halo training
    halo_overlap: str = "auto"      # halo exchange/compute overlap policy
    mesh_devices: int = 1           # >1: shard explainer queries over a mesh

    @property
    def name(self) -> str:
        return self.bmname if self.bmname is not None else self.dataset


def _add_common(p: argparse.ArgumentParser) -> None:
    d = Config()
    p.add_argument("--dataset", default=d.dataset)
    p.add_argument("--bmname", default=None)
    p.add_argument("--pkl", dest="pkl_fname", default=None)
    p.add_argument("--datadir", default=d.datadir)
    p.add_argument("--logdir", default=d.logdir)
    p.add_argument("--ckptdir", default=d.ckptdir)
    p.add_argument("--method", default=d.method,
                   help="base | att | soft-assign | gat | deepergcn (the port's "
                        "own multi-head GAT and DeeperGCN node classifiers; node "
                        "tasks only)")
    p.add_argument("--num-heads", dest="num_heads", type=int, default=d.num_heads,
                   help="--method gat: heads a layer, --hidden-dim wide each")
    p.add_argument("--input-dim", "--input_dim", dest="input_dim", type=int,
                   default=d.input_dim)
    p.add_argument("--hidden-dim", "--hidden_dim", dest="hidden_dim", type=int,
                   default=d.hidden_dim)
    p.add_argument("--output-dim", "--output_dim", dest="output_dim", type=int,
                   default=d.output_dim)
    p.add_argument("--num-classes", "--num_classes", dest="num_classes", type=int,
                   default=d.num_classes)
    p.add_argument("--num-gc-layers", "--num_gc_layers", dest="num_gc_layers",
                   type=int, default=d.num_gc_layers)
    p.add_argument("--bn", action="store_true", default=d.bn)
    p.add_argument("--dropout", type=float, default=d.dropout)
    p.add_argument("--nobias", dest="bias", action="store_false", default=d.bias)
    p.add_argument("--name-suffix", dest="name_suffix", default=d.name_suffix)
    p.add_argument("--max-nodes", "--max_nodes", dest="max_nodes", type=int,
                   default=d.max_nodes)
    p.add_argument("--batch-size", "--batch_size", dest="batch_size", type=int,
                   default=d.batch_size)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--platform", default=None,
                   help="unset: the CUDA card; cpu: the CPU")
    p.add_argument("--bcsr", dest="use_bcsr", action="store_true",
                   default=d.use_bcsr,
                   help="aggregate on the block-sparse kernels instead of "
                        "the COO edge list")
    p.add_argument("--bcsr-block", dest="bcsr_block", type=int,
                   default=d.bcsr_block)
    p.add_argument("--bcsr-format", dest="bcsr_format",
                   choices=("auto", "tiles", "packets"),
                   default=d.bcsr_format,
                   help="block-sparse format: tiles (B1) or edge packets "
                        "(B7); auto weighs pack and training time at the "
                        "card's rates (tiles on the CPU)")
    p.add_argument("--dp", dest="dp_devices", type=int, default=d.dp_devices,
                   help="data-parallel graph training over N devices")


def parse_train_args(argv=None) -> Config:
    d = Config()
    p = argparse.ArgumentParser(description="tpugraph_torch trainer")
    _add_common(p)
    p.add_argument("--epochs", dest="num_epochs", type=int, default=d.num_epochs)
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--clip", type=float, default=d.clip)
    p.add_argument("--train-ratio", "--train_ratio", dest="train_ratio",
                   type=float, default=d.train_ratio)
    p.add_argument("--test-ratio", "--test_ratio", dest="test_ratio",
                   type=float, default=d.test_ratio)
    p.add_argument("--weight-decay", "--weight_decay", dest="weight_decay",
                   type=float, default=d.weight_decay)
    p.add_argument("--opt", default=d.opt)
    p.add_argument("--opt-scheduler", dest="opt_scheduler", default=d.opt_scheduler)
    p.add_argument("--opt-restart", dest="opt_restart", type=int, default=d.opt_restart)
    p.add_argument("--opt-decay-step", dest="opt_decay_step", type=int,
                   default=d.opt_decay_step)
    p.add_argument("--opt-decay-rate", dest="opt_decay_rate", type=float,
                   default=d.opt_decay_rate)
    p.add_argument("--feature", dest="feature_type", default=d.feature_type)
    p.add_argument("--assign-ratio", dest="assign_ratio", type=float,
                   default=d.assign_ratio)
    p.add_argument("--num-pool", dest="num_pool", type=int, default=d.num_pool)
    p.add_argument("--linkpred", action="store_true", default=d.linkpred)
    p.add_argument("--eval-every", dest="eval_every", type=int, default=d.eval_every)
    p.add_argument("--resume", action="store_true", default=False,
                   help="continue from the existing checkpoint")
    p.add_argument("--halo", dest="halo_devices", type=int,
                   default=d.halo_devices,
                   help="node-partitioned halo training over N devices")
    p.add_argument("--halo-overlap", dest="halo_overlap",
                   choices=("auto", "on", "off"), default=d.halo_overlap)
    return _to_config(p.parse_args(argv))


def parse_explain_args(argv=None) -> Config:
    d = Config()
    p = argparse.ArgumentParser(description="tpugraph_torch explainer")
    _add_common(p)
    p.add_argument("--epochs", dest="explainer_epochs", type=int,
                   default=d.explainer_epochs)
    p.add_argument("--lr", dest="explainer_lr", type=float, default=d.explainer_lr)
    p.add_argument("--mask-act", dest="mask_act", default=d.mask_act)
    p.add_argument("--mask-bias", dest="mask_bias", action="store_true",
                   default=d.mask_bias)
    p.add_argument("--explain-node", dest="explain_node", type=int, default=None)
    p.add_argument("--graph-mode", dest="graph_mode", action="store_true",
                   default=d.graph_mode)
    p.add_argument("--graph-idx", dest="graph_idx", type=int, default=d.graph_idx)
    p.add_argument("--multigraph-class", dest="multigraph_class", type=int,
                   default=d.multigraph_class)
    p.add_argument("--multinode-class", dest="multinode_class", type=int,
                   default=d.multinode_class)
    p.add_argument("--align-steps", dest="align_steps", type=int,
                   default=d.align_steps)
    p.add_argument("--explainer-suffix", dest="explainer_suffix",
                   default=d.explainer_suffix)
    p.add_argument("--explainer-model", dest="explainer_model",
                   default=d.explainer_model, help="exp | grad | att")
    p.add_argument("--seed-ensemble", dest="seed_ensemble", type=int,
                   default=d.seed_ensemble,
                   help=">1 averages edge gates over several mask-init seeds")
    p.add_argument("--marginalize", action="store_true",
                   default=d.marginalize,
                   help="noise-marginalized feature masking")
    p.add_argument("--log-mask-every", dest="log_mask_every", type=int,
                   default=d.log_mask_every,
                   help=">0: write mask heatmaps every k optimization epochs")
    p.add_argument("--mesh", dest="mesh_devices", type=int,
                   default=d.mesh_devices,
                   help="shard explainer queries over a mesh of N devices")
    return _to_config(p.parse_args(argv))


def _to_config(ns: argparse.Namespace) -> Config:
    cfg = Config()
    for f in dataclasses.fields(Config):
        if hasattr(ns, f.name):
            setattr(cfg, f.name, getattr(ns, f.name))
    return cfg


# the node classifiers that train on the self-looped COO adjacency alone
SELF_LOOP_METHODS = ("gat", "deepergcn")


def check_ported(cfg: Config) -> None:
    """Raise ``NotImplementedError`` before anything runs for ``--resume``
    with ``--halo N > 1``, which ``tpugraph`` rejects only once a
    checkpoint has loaded (``tpugraph/cli/tasks.py:109``), and for
    ``--method gat`` or ``deepergcn`` anywhere but single-device node
    classification on the COO edge list."""
    if cfg.resume and cfg.halo_devices > 1:
        raise NotImplementedError(
            "--resume is not supported with --halo; restart or use the "
            "single-device path")
    if cfg.method in SELF_LOOP_METHODS:
        graph_task = (cfg.bmname is not None or cfg.pkl_fname is not None
                      or cfg.dataset == "enron_multigraph")
        if graph_task or cfg.use_bcsr or cfg.halo_devices > 1:
            raise NotImplementedError(
                f"--method {cfg.method} trains single-graph node tasks on one device "
                "over the COO edge list: no --bmname/--pkl/enron_multigraph, --bcsr "
                "or --halo")


def rank_count(cfg: Config, explain: bool = False) -> int:
    """The ranks ``cfg``'s task runs on: for the explainer (``explain``)
    ``--mesh``; for the trainer ``--dp`` for ``--bmname`` graph
    classification, ``--halo`` for the single-graph node tasks (where
    ``tpugraph`` reads each), else 1."""
    if explain:
        return cfg.mesh_devices
    if cfg.bmname is not None:
        return cfg.dp_devices
    if cfg.pkl_fname is not None or cfg.dataset == "enron_multigraph":
        return 1
    return cfg.halo_devices


def rank_backend(cfg: Config) -> str:
    """``gloo`` for CPU ranks (``--platform cpu``), else ``nccl``: a rank a
    card, never fewer cards than ranks
    (:func:`tpugraph_torch.parallel.launch.run_ranks`)."""
    return "gloo" if cli_device(cfg).type == "cpu" else "nccl"


def cli_device(cfg: Config) -> torch.device:
    """``--platform``: unset is the CUDA card (raising without one), ``cpu``
    the CPU; any other value raises."""
    if cfg.platform is None:
        return default_device(None)
    if cfg.platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"--platform {cfg.platform!r}: leave it unset for the "
                     "CUDA card or pass --platform cpu")
