"""Port of ``tpugraph/train/loop.py``: full-batch node classification on
the COO edge list and on the static-weight aggregation formats, and
minibatch graph classification on dense batched adjacencies
(:func:`train_graph_classifier`).

The JAX loop fuses epochs into one ``lax.scan`` per device call; here it
is an eager Python loop, one optimizer step per epoch, with the same node
split RNG and the same per-epoch metrics (loss and accuracies of the
training-mode forward, before the update).  ``log_fn`` sees the metrics
every 25 epochs and after the last, the JAX loop's ``scan_chunk``
cadence.  While a ``torch.profiler`` records, each node epoch and each
graph minibatch step is a named region of its trace (``train_epoch``,
``train_step``); with no profiler the annotation does nothing.  The node
trainer also marks ``train.pack`` (what ``pack_s`` times, with
``train.pack.choose``, ``train.pack.host`` and ``train.pack.upload``
inside), ``train.inputs``, in each epoch ``train.forward``,
``train.backward`` and ``train.optimizer``, and the closing
``train.eval``; ``GraphConv`` marks its adjacency products.

A model with ``self_loops`` (:class:`~tpugraph_torch.nn.GatEncoderNode`,
:class:`~tpugraph_torch.nn.DeeperGcnEncoderNode`, which the JAX package
does not have) always trains on COO: ``build_adjacency`` gives it the live
edges with one self-loop a node and their CSR on every device.

``use_bcsr=False`` (the default, as in JAX) aggregates over the padded
COO edge list (``SparseAdj``, ``tpugraph/train/loop.py:476-477``), which
``build_adjacency`` gives its CSR on the card (``ops/coo_kernels.py:
edge_csr``, a device sort), so each product there is the CSR kernel; the
CPU, like JAX, gathers and sums by segment.  ``use_bcsr=True`` picks the format
as ``tpugraph/train/loop.py:316-475`` does (:func:`resolve_bcsr_format`):

* ``bcsr_format="packets"`` — edge packets at ``packet_geom``, kernel B7;
* ``bcsr_resident="on"`` — column-stacked tiles (``stack=1``, padded to
  64), int8 when every weight is an integer in [-127, 127] and bf16
  otherwise, kernel B4;
* an attention model — f32 tiles and their transpose plan, the scores by
  B2 and the aggregation over the score-scaled tiles by B1
  (``tpugraph/train/loop.py:442-453``);
* otherwise dense f32 tiles, kernel B1, or B3 with ``bcsr_k_pack > 1``
  (``-1`` picks it from the tile counts).

``"auto"`` applies where the adjacency goes to the CUDA card: a graph
whose mean tile occupancy is under 1% is low-locality, and there
``bcsr_format="auto"`` weighs pack time against steady state at the
card's own rates (:func:`resolve_bcsr_format`, ``TPUGRAPH_RATES``
overrides them) and ``bcsr_resident="auto"`` takes the resident format
where the block suits the tensor cores.  On the CPU ``"auto"`` is tiles
with resident off, as the JAX package's is off the TPU.

With ``dropout``, the masks come from a ``torch.Generator`` on the
device seeded with ``seed + 1`` (JAX: ``PRNGKey(seed + 1)``, whose stream
torch cannot replay); evaluation runs without dropout.

Across the ranks of a process group (:mod:`tpugraph_torch.parallel`):
:func:`train_node_classifier_halo` trains on node shards with the halo
exchange (``--halo N``), and :func:`train_graph_classifier` with a
``mesh`` splits each batch over the ranks (``--dp N``).  Each runs in
every rank and returns the same result in each.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpugraph_torch._device import DeviceLike, default_device
from tpugraph_torch.core.graph import Graph, graph_from_edges
from tpugraph_torch.nn.layers import (Adjacency, BCSRAdj, PacketAdj,
                                      SparseAdj, StackedAdj)
from tpugraph_torch.nn.losses import (link_prediction_loss, node_cross_entropy,
                                      softmax_cross_entropy)
from tpugraph_torch.ops import packets_kernels
from tpugraph_torch.ops.bcsr import (bcsr_from_coo, bcsr_transpose_host,
                                     bcsr_transpose_plan, choose_k_pack_counts,
                                     coo_tile_counts)
from tpugraph_torch.ops.coo_kernels import edge_csr
from tpugraph_torch.ops.packets import pack_edges, pack_edges_transpose
from tpugraph_torch.ops.resident_kernels import stack_bcsr
from tpugraph_torch.train.metrics import eval_graph_preds, eval_node
from tpugraph_torch.train.optim import OptimizerConfig, build_optimizer
from tpugraph_torch.utils.profiling import trace_annotation


_RESIDENT_K_PACK = 64  # stacks padded to this multiple (tpugraph/train/loop.py:429)
LOG_EVERY = 25  # epochs between log_fn calls: tpugraph's scan_chunk default


@dataclasses.dataclass
class TrainConfig:
    """The ``tpugraph`` ``TrainConfig`` fields this path reads
    (``tpugraph/train/loop.py:35``), with its defaults: ``use_bcsr=False``
    trains on the COO edge list, ``True`` on one of the block-sparse
    formats below.  ``packet_compute_dtype`` is the port's own:
    B7's compute dtype on the packet path (``None``: bf16 on a CUDA
    device, f32 on the CPU, the JAX package's accelerator/interpret
    default).

    ``batch_size`` and ``eval_every`` are read by the graph classifier
    only, the ``opt*`` fields by the node trainer only (graph
    classification keeps Adam at 0.001, as ``tpugraph``'s does).

    ``bcsr_block`` is the BCSR tile size (128 or 256 in use, as in
    ``tpugraph``).  On the CPU any size runs.  On the card the tile
    kernels B1/B3 need ``bcsr_block % 64 == 0``, and the resident format
    (int8/bf16 tiles on the tensor cores) needs ``bcsr_block % 128 == 0``;
    their wrappers raise otherwise."""

    num_epochs: int = 1000
    lr: float = 0.001
    clip: float = 2.0
    weight_decay: float = 0.005
    train_ratio: float = 0.8
    batch_size: int = 20
    eval_every: int = 25  # graph classification: epochs between evaluations
    opt: str = "adam"
    opt_scheduler: str = "none"
    opt_decay_step: int = 100
    opt_decay_rate: float = 0.1
    opt_restart: int = 200
    use_bcsr: bool = False
    bcsr_block: int = 128
    bcsr_k_pack: int = 0  # 0 off, >1 fixed, -1 chosen from the tile counts
    packet_geom: Tuple[int, int, int] = (512, 256, 128)  # block_r, block_c, K
    bcsr_format: str = "auto"    # "tiles", "packets" or "auto"
    bcsr_resident: str = "auto"  # "on", "off" or "auto"
    packet_compute_dtype: Optional[torch.dtype] = None


def _opt_config(cfg: TrainConfig) -> OptimizerConfig:
    """The optimizer chain ``cfg`` names (``tpugraph/train/loop.py:83``)."""
    return OptimizerConfig(
        opt=cfg.opt,
        lr=cfg.lr,
        scheduler=cfg.opt_scheduler,
        decay_step=cfg.opt_decay_step,
        decay_rate=cfg.opt_decay_rate,
        restart=cfg.opt_restart,
        weight_decay=cfg.weight_decay,
        clip=cfg.clip,
    )


# Rates of the format rule, measured on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit by chip_smoke.py's lowloc phase (PERF.md section 5):
# one forward+backward aggregation pair at D = 128 on the 65,536-node
# power-law graph (2,097,152 edges, block 256), and the pack of A and A^T
# with the upload, per 256^2 int8 tile (resident) or per edge (packets).
# Override any subset with
#   TPUGRAPH_RATES="res_edges_per_s=6.8e8,pkt_edges_per_s=4.7e9,
#                   res_pack_s_per_tile=1.5e-4,pkt_pack_s_per_edge=5e-7"
# or pin TrainConfig.bcsr_format.
_RATE_DEFAULTS = {
    "res_edges_per_s": 6.8e8,       # resident-stacked kernel B4, a pair
    "pkt_edges_per_s": 4.7e9,       # edge-packet kernel B7, a pair
    "res_pack_s_per_tile": 1.5e-4,  # int8 tiles, stack and upload
    "pkt_pack_s_per_edge": 5e-7,    # packets of A and A^T and upload
}
_SPMM_PAIRS_PER_EPOCH = 3  # a 3-layer encoder: one pair a layer
_LOW_LOCALITY_DENSITY = 0.01  # tile occupancy under which a graph is low-locality
_PACKETS_DENSITY = 3e-3      # occupancy under which packets are a candidate
_RESIDENT_BLOCK = 128        # the tensor-core phase's block multiple


def _format_rates() -> Dict[str, float]:
    """The card's rates, overridden by ``TPUGRAPH_RATES`` (comma-separated
    ``key=value`` pairs; an unknown key raises)
    (``tpugraph/train/loop.py:115``)."""
    out = dict(_RATE_DEFAULTS)
    for part in os.environ.get("TPUGRAPH_RATES", "").split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in out:
            raise ValueError(f"TPUGRAPH_RATES: unknown key {k!r} "
                             f"(valid: {sorted(out)})")
        out[k] = float(v)
    return out


def resolve_bcsr_format(cfg: TrainConfig, n_live: int, t_probe: int,
                        density: float, low_locality: bool,
                        on_card: bool, att: bool = False) -> str:
    """The aggregation format by total time, pack plus training
    (``tpugraph/train/loop.py:137``).  An attention model or
    ``bcsr_resident="on"`` forces ``"tiles"``; an explicit ``bcsr_format``
    wins next.  ``"auto"`` is ``"tiles"`` unless ``on_card`` and the graph
    is low-locality with a tile occupancy under 3e-3; then it compares the
    resident tiles' pack (``t_probe`` tiles at ``cfg.bcsr_block``, the
    per-256^2-tile rate scaled by ``(block / 256)^2``) and
    ``3 * num_epochs`` aggregation pairs against the packets', at the
    rates of :func:`_format_rates`, and prints its decision."""
    if att or cfg.bcsr_resident == "on":
        return "tiles"
    fmt = cfg.bcsr_format
    if fmt != "auto":
        return fmt
    if not (on_card and low_locality and density < _PACKETS_DENSITY):
        return "tiles"
    r = _format_rates()
    pairs = _SPMM_PAIRS_PER_EPOCH * cfg.num_epochs
    pack_s_per_tile = r["res_pack_s_per_tile"] * (cfg.bcsr_block / 256.0) ** 2
    est_tiles = (pack_s_per_tile * t_probe
                 + pairs * n_live / r["res_edges_per_s"])
    est_pkt = (r["pkt_pack_s_per_edge"] * n_live
               + pairs * n_live / r["pkt_edges_per_s"])
    fmt = "packets" if est_pkt < est_tiles else "tiles"
    print(f"tpugraph_torch: bcsr_format auto -> {fmt} (est total tiles "
          f"{est_tiles:.3g}s vs packets {est_pkt:.3g}s for {cfg.num_epochs} "
          "epochs; H100-measured rates, TPUGRAPH_RATES overrides)", flush=True)
    return fmt


def choose_format(s_np: np.ndarray, r_np: np.ndarray, w_np: np.ndarray,
                  n_pad: int, cfg: TrainConfig, on_card: bool,
                  att: bool = False) -> str:
    """The block-sparse format :func:`build_adjacency` packs the edges in
    (``tpugraph/train/loop.py:356-397``): ``"packets"``, ``"resident"``,
    ``"tiles_att"`` (an attention model's tiles and transpose plan) or
    ``"tiles"``.  ``on_card``: the adjacency goes to the CUDA card, where
    the ``"auto"`` settings read the graph's locality and the resident
    format needs ``bcsr_block % 128 == 0`` (the card's own gate: it has
    no VMEM window to fit)."""
    block = cfg.bcsr_block
    n_live = int((w_np != 0).sum())
    t_probe, density = 1, 1.0
    if on_card and "auto" in (cfg.bcsr_resident, cfg.bcsr_format):
        # mean tile occupancy, a host-side O(E) count
        # (tpugraph/train/loop.py:356-371)
        cnt = coo_tile_counts(s_np, r_np, n_pad, block=block, weights=w_np)
        t_probe = max(int(cnt.sum()), 1)
        density = n_live / (t_probe * block ** 2)
    low_locality = density < _LOW_LOCALITY_DENSITY
    fmt = resolve_bcsr_format(cfg, n_live, t_probe, density, low_locality,
                              on_card, att=att)
    if fmt not in ("tiles", "packets"):
        raise ValueError(f"unknown bcsr_format {fmt!r}")
    if fmt == "packets":
        return fmt
    if att:
        return "tiles_att"
    if cfg.bcsr_resident == "on" or (
            cfg.bcsr_resident == "auto" and on_card and low_locality
            and block % _RESIDENT_BLOCK == 0):
        return "resident"
    return "tiles"


def self_loop_adjacency(g: Graph, device: torch.device) -> Tuple[SparseAdj, int]:
    """The adjacency a model with ``self_loops`` aggregates over, as DGL's
    ogbn-arxiv GAT example builds it (``remove_self_loop().add_self_loop()``)
    and DeeperGCN's ``--self_loop`` adds them: the live edges
    (weight not 0) that are not self-loops, then one self-loop for each of
    the ``g.n_node`` real nodes, all weights 1, with the :class:`EdgeCSR`
    built on ``device``.  Padding nodes are left out, so the node count it
    needs is ``g.n_node``."""
    with trace_annotation("train.pack.host"):
        keep = (g.edge_weight != 0) & (g.senders != g.receivers)
        loops = torch.arange(g.n_node, dtype=torch.int64)
        s = torch.cat([g.senders[keep].long(), loops])
        r = torch.cat([g.receivers[keep].long(), loops])
    with trace_annotation("train.pack.upload"):
        s, r = s.to(device), r.to(device)
        return (SparseAdj(s, r, torch.ones(s.shape[0], device=device),
                          edge_csr(s, r, g.n_node)), g.n_node)


def build_adjacency(g: Graph, cfg: TrainConfig, device: torch.device,
                    att: bool = False, self_loops: bool = False) -> Tuple[Adjacency, int]:
    """Pack ``g`` in the format ``cfg`` selects and move it to ``device``
    (``tpugraph/train/loop.py:316-477``); returns the adjacency and the
    padded node count it needs (a multiple of the block for the tile
    formats).  Without ``use_bcsr`` it is the COO edge list itself, with
    its CSR built on the card after the upload (the CPU runs the gather
    path, which needs none); packets carry B7's row schedules, built on
    the card after the upload (:func:`packets_kernels.schedule`);
    otherwise :func:`choose_format` picks the format (``att``: an
    attention model, which takes f32 tiles with a transpose plan).  A
    model that asks for ``self_loops`` (GAT, DeeperGCN) takes
    :func:`self_loop_adjacency` and raises with ``use_bcsr``."""
    if self_loops:
        if cfg.use_bcsr:
            raise ValueError("a self-looped model trains on the COO edge list's CSR: "
                             "use_bcsr is not supported")
        return self_loop_adjacency(g, device)
    if not cfg.use_bcsr:
        with trace_annotation("train.pack.upload"):
            s = g.senders.to(device, torch.int64)
            r = g.receivers.to(device, torch.int64)
            csr = (edge_csr(s, r, g.num_nodes_padded) if device.type == "cuda"
                   else None)
            return (SparseAdj(s, r, g.edge_weight.to(device), csr),
                    g.num_nodes_padded)
    s_np = g.senders.numpy()
    r_np = g.receivers.numpy()
    w_np = g.edge_weight.numpy()
    n_pad = g.num_nodes_padded
    block = cfg.bcsr_block
    with trace_annotation("train.pack.choose"):
        fmt = choose_format(s_np, r_np, w_np, n_pad, cfg,
                            torch.device(device).type == "cuda", att)
    if fmt == "packets":
        br, bc, kk = cfg.packet_geom
        with trace_annotation("train.pack.host"):
            p = pack_edges(s_np, r_np, w_np, n_pad, block_r=br, block_c=bc,
                           k=kk)
            p_t = pack_edges_transpose(s_np, r_np, w_np, n_pad, block_r=br,
                                       block_c=bc, k=kk)
        with trace_annotation("train.pack.upload"):
            p, p_t = p.to(device), p_t.to(device)
            if p.w.device.type == "cuda":  # B7's row schedules, once a job
                for q in (p, p_t):
                    packets_kernels.schedule(q)
            return PacketAdj(p, p_t, cfg.packet_compute_dtype), p.num_nodes
    if fmt == "resident":
        with trace_annotation("train.pack.host"):
            integral = bool(np.all(w_np == np.rint(w_np))
                            and np.abs(w_np).max(initial=0) <= 127)
            tdt = torch.int8 if integral else torch.bfloat16
            if not integral:
                print("tpugraph_torch: the resident path quantizes "
                      "non-integral adjacency weights to bf16 tiles (use "
                      "bcsr_resident='off' for exact f32-tile aggregation)",
                      flush=True)
            m = bcsr_from_coo(s_np, r_np, w_np, n_pad, block=block,
                              tile_dtype=tdt)
            st = stack_bcsr(m, stack=1, k_pack=_RESIDENT_K_PACK)
            del m
            m_t = bcsr_transpose_host(s_np, r_np, w_np, n_pad, block=block,
                                      tile_dtype=tdt)
            st_t = stack_bcsr(m_t, stack=1, k_pack=_RESIDENT_K_PACK)
            del m_t
        with trace_annotation("train.pack.upload"):
            st, st_t = st.to(device), st_t.to(device)
        return StackedAdj(st, st_t), st.num_nodes
    if fmt == "tiles_att":
        with trace_annotation("train.pack.host"):
            m = bcsr_from_coo(s_np, r_np, w_np, n_pad, block=block)
            tp = bcsr_transpose_plan(m)
        with trace_annotation("train.pack.upload"):
            return BCSRAdj(m.to(device), None, tp=tp.to(device)), m.num_nodes
    with trace_annotation("train.pack.host"):
        if cfg.bcsr_k_pack < 0:
            kp = choose_k_pack_counts(coo_tile_counts(
                s_np, r_np, n_pad, block=block, weights=w_np))
        else:
            kp = cfg.bcsr_k_pack
        prt = kp if kp > 1 else None
        m = bcsr_from_coo(s_np, r_np, w_np, n_pad, block=block,
                          pad_rows_to=prt)
        m_t = bcsr_transpose_host(s_np, r_np, w_np, n_pad, block=block,
                                  pad_rows_to=prt)
    with trace_annotation("train.pack.upload"):
        m, m_t = m.to(device), m_t.to(device)
    return BCSRAdj(m, m_t, k_pack=kp if kp > 1 else 0), m.num_nodes


def split_nodes(num_nodes: int, train_ratio: float,
                rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Shuffled node-level train/test split (``tpugraph/train/loop.py:269``)."""
    idx = np.arange(num_nodes)
    rng.shuffle(idx)
    num_train = int(num_nodes * train_ratio)
    return idx[:num_train], idx[num_train:]


def train_node_classifier(
    model: torch.nn.Module,
    g: Graph,
    feat: np.ndarray,
    labels: np.ndarray,
    cfg: TrainConfig,
    seed: int = 0,
    log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
    init_params: Optional[Dict[str, torch.Tensor]] = None,
    device: DeviceLike = None,
    init_opt_state: Optional[Dict[str, Any]] = None,
    class_weight: Optional[np.ndarray] = None,
) -> Dict[str, Any]:
    """Full-batch node classification on one padded graph
    (``tpugraph/train/loop.py:279``).

    ``model`` is a :class:`tpugraph_torch.nn.GcnEncoderNode`, a
    :class:`~tpugraph_torch.nn.GatEncoderNode` or a
    :class:`~tpugraph_torch.nn.DeeperGcnEncoderNode`; it moves to
    ``device`` (``None`` = CUDA) and trains in place, starting from
    ``init_params`` (a ``state_dict``) and ``init_opt_state`` (the
    optimizer's ``state_dict``, its update count included) when given,
    one optimizer update an epoch.  ``feat`` is
    ``float32[N_pad, D]``, ``labels`` ``int[N_real]``.  ``log_fn(epoch,
    {"loss", "train_acc", "test_acc"})`` is called every ``LOG_EVERY``
    epochs and after the last (each call waits for the device).  Returns params
    (the ``state_dict``), ``ypred [1, N_pad, C]``, the split, the metric
    history, train/test results (``ypred`` holds ``N_real`` rows for a
    model with ``self_loops``, which has no padding nodes), the seconds of
    the epoch loop (``"elapsed"``) and of packing and uploading the adjacency
    (``"pack_s"``), the packed adjacency (``"adj"``) and the optimizer's
    ``state_dict`` (``"opt_state"``).  ``class_weight [C]`` weighs each
    node's cross-entropy by its label's weight (ppi's ``[1, 5]``).  A
    model with
    ``dropout`` draws its masks from a generator on ``device`` seeded with
    ``seed + 1``.
    """
    device = default_device(device)
    rng = np.random.default_rng(seed)
    n_real = g.n_node
    train_idx, test_idx = split_nodes(n_real, cfg.train_ratio, rng)

    with trace_annotation("train.pack"):
        t_pack = time.perf_counter()
        sp, n_new = build_adjacency(
            g, cfg, device, att=bool(getattr(model, "att", False)),
            self_loops=bool(getattr(model, "self_loops", False)))
        pack_s = time.perf_counter() - t_pack

    with trace_annotation("train.inputs"):
        feat_pad = np.zeros((n_new, feat.shape[1]), dtype=np.float32)
        k = min(feat.shape[0], n_new)
        feat_pad[:k] = feat[:k]
        labels_pad = np.zeros((n_new,), dtype=np.int64)
        labels_pad[:n_real] = np.asarray(labels)
        train_mask = np.zeros((n_new,), dtype=np.float32)
        train_mask[train_idx] = 1.0
        test_mask = np.zeros((n_new,), dtype=np.float32)
        test_mask[test_idx] = 1.0

        x = torch.from_numpy(feat_pad).to(device)
        y = torch.from_numpy(labels_pad).to(device)
        train_mask_d = torch.from_numpy(train_mask).to(device)
        test_mask_d = torch.from_numpy(test_mask).to(device)
        cw = (None if class_weight is None else
              torch.as_tensor(np.asarray(class_weight, dtype=np.float32),
                              device=device))

        model.to(device)
        if init_params is not None:
            model.load_state_dict(init_params)
        model.train()
        opt = build_optimizer(model.parameters(), _opt_config(cfg))
        if init_opt_state is not None:
            opt.load_state_dict(init_opt_state)

    def acc(correct, mask):
        return torch.sum(correct * mask) / torch.clamp(torch.sum(mask), min=1.0)

    drop_gen = None
    if getattr(model, "dropout", 0.0) > 0.001:
        drop_gen = torch.Generator(device=device).manual_seed(seed + 1)
    hist: Dict[str, List[torch.Tensor]] = {"loss": [], "train_acc": [],
                                           "test_acc": []}
    begin = time.perf_counter()
    for epoch in range(1, cfg.num_epochs + 1):
        with trace_annotation("train_epoch"):
            with trace_annotation("train.forward"):
                logits, _ = model(x, sp, dropout_gen=drop_gen)
                loss = node_cross_entropy(logits, y, class_weight=cw,
                                          node_mask=train_mask_d)
            with trace_annotation("train.backward"):
                opt.zero_grad()
                loss.backward()
            with trace_annotation("train.optimizer"):
                opt.step()
            with torch.no_grad():
                correct = (torch.argmax(logits, dim=-1) == y).float()
                hist["loss"].append(loss.detach())
                hist["train_acc"].append(acc(correct, train_mask_d))
                hist["test_acc"].append(acc(correct, test_mask_d))
        if log_fn is not None and (epoch % LOG_EVERY == 0
                                   or epoch == cfg.num_epochs):
            log_fn(epoch, {k: v[-1].item() for k, v in hist.items()})
    history = {k: (torch.stack(v).tolist() if v else [])
               for k, v in hist.items()}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - begin

    with trace_annotation("train.eval"):
        model.eval()
        with torch.no_grad():
            logits, _ = model(x, sp)
        ypred = logits.cpu().numpy()[None]  # [1, N_pad, C]
        result_train, result_test = eval_node(
            ypred[:, :n_real], np.asarray(labels)[None], train_idx, test_idx)
    return {
        "params": model.state_dict(),
        "ypred": ypred,
        "train_idx": train_idx,
        "test_idx": test_idx,
        "history": history,
        "result_train": result_train,
        "result_test": result_test,
        "elapsed": elapsed,
        "pack_s": pack_s,
        "adj": sp,
        "opt_state": opt.state_dict(),
    }


def train_node_classifier_halo(
    model: torch.nn.Module,
    g: Graph,
    feat: np.ndarray,
    labels: np.ndarray,
    cfg: TrainConfig,
    n_dev: int,
    axis="data",
    overlap: str = "auto",
    partition: str = "locality",
    class_weight: Optional[np.ndarray] = None,
    seed: int = 0,
    log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
    mesh=None,
) -> Dict[str, Any]:
    """Full-batch node classification on ``n_dev`` node shards with the
    halo exchange, run in every rank of a process group
    (``tpugraph/train/loop.py:539``; ``--halo N``).

    The node split comes from ``np.random.default_rng(seed)`` as on one
    device; ``partition="locality"`` relabels the nodes by
    :func:`~tpugraph_torch.parallel.spmd.locality_partition` first
    (``"none"`` keeps their order); the plan is
    :func:`~tpugraph_torch.parallel.spmd.build_halo`'s, on tiles with
    ``cfg.use_bcsr`` (B1, and B2 for an attention model), split where
    ``overlap`` says (:func:`~tpugraph_torch.parallel.spmd.resolve_halo_overlap`).
    Each rank keeps its shard of the features, labels and masks and trains
    ``model`` (already initialized, the same on every rank) with the
    halo step, whose gradient is ``n_dev`` times the single-device one, as
    ``tpugraph``'s.  ``mesh`` defaults to the group's (1-D on ``axis``, or
    2-D ``(2, n_dev / 2)`` for a pair of axis names).  The loss is
    recorded every epoch and the accuracies (and ``log_fn``) every
    ``cfg.eval_every`` epochs and after the last.  Dropout raises, as in
    ``tpugraph`` (the step draws no masks).  Returns
    :func:`train_node_classifier`'s dict, ``ypred`` over the original
    node ids, plus ``n_dev`` and ``halo_size``."""
    from tpugraph_torch.parallel import collectives
    from tpugraph_torch.parallel.mesh import group_mesh
    from tpugraph_torch.parallel.spmd import (build_halo, locality_partition,
                                              make_halo_forward,
                                              make_halo_train_step)

    if getattr(model, "dropout", 0.0) > 0.001:
        raise NotImplementedError(
            "halo training is deterministic (no dropout rng); set dropout=0 "
            "or use the single-device path")
    mesh = mesh or group_mesh(axis)
    if mesh.size != n_dev:
        raise ValueError(f"n_dev={n_dev}, but the mesh has {mesh.size} ranks")
    device, rank = mesh.device, mesh.rank
    rng = np.random.default_rng(seed)
    n_real = g.n_node
    old_n = g.num_nodes_padded
    train_idx, test_idx = split_nodes(n_real, cfg.train_ratio, rng)

    s, r, w = g.senders.numpy(), g.receivers.numpy(), g.edge_weight.numpy()
    live = w != 0
    if partition == "locality":
        perm, inv = locality_partition(s[live], r[live], old_n, n_dev,
                                       weights=w[live])
    elif partition == "none":
        perm = inv = np.arange(((old_n + n_dev - 1) // n_dev) * n_dev)
    else:
        raise ValueError(f"partition must be 'locality'/'none': {partition}")
    n_pad = len(perm)
    g2 = graph_from_edges(inv[s[live]].astype(np.int32),
                          inv[r[live]].astype(np.int32), n_pad,
                          edge_weight=w[live])
    plan = build_halo(g2, mesh, bcsr=cfg.use_bcsr, block=cfg.bcsr_block,
                      overlap=overlap, att=bool(getattr(model, "att", False)))
    ns = plan.shard_size
    n_total = ns * n_dev
    if partition == "locality" and n_total != n_pad:
        # the shards must be the partition's: a padding rule that grew the
        # graph past ns * n_dev would shift every node off its shard
        raise AssertionError(f"halo plan covers {n_total} nodes, the "
                             f"locality partition {n_pad}")

    def shard(payload: np.ndarray, dtype) -> torch.Tensor:
        """This rank's rows of ``payload`` relabelled and padded to
        ``n_total`` (``tpugraph/train/loop.py:620-626``)."""
        src = np.zeros((n_pad,) + payload.shape[1:], payload.dtype)
        src[: payload.shape[0]] = payload
        full = np.zeros((n_total,) + payload.shape[1:], payload.dtype)
        full[:n_pad] = src[perm]
        return torch.from_numpy(full[rank * ns:(rank + 1) * ns]).to(device, dtype)

    labels_pad = np.zeros((old_n,), np.int64)
    labels_pad[:n_real] = np.asarray(labels)
    tr_mask = np.zeros((old_n,), np.float32)
    tr_mask[train_idx] = 1.0
    te_mask = np.zeros((old_n,), np.float32)
    te_mask[test_idx] = 1.0
    x = shard(np.asarray(feat, np.float32), torch.float32)
    y = shard(labels_pad, torch.int64)
    tr_m = shard(tr_mask, torch.float32)
    te_m = shard(te_mask, torch.float32)
    cw = (None if class_weight is None else
          torch.as_tensor(np.asarray(class_weight, np.float32), device=device))

    model.to(device)
    model.train()
    opt = build_optimizer(model.parameters(), _opt_config(cfg))
    step = make_halo_train_step(model, opt, mesh, plan, cw, device)
    fwd = make_halo_forward(model, mesh, plan, device)

    def accs() -> Tuple[float, float]:
        correct = (torch.argmax(fwd(x), dim=-1) == y).float()
        sums = torch.stack([torch.sum(correct * tr_m), torch.sum(tr_m),
                            torch.sum(correct * te_m), torch.sum(te_m)])
        c_tr, n_tr, c_te, n_te = collectives.all_reduce_(sums, mesh.group).tolist()
        return c_tr / max(n_tr, 1.0), c_te / max(n_te, 1.0)

    losses: List[torch.Tensor] = []
    history: Dict[str, List[float]] = {"loss": [], "train_acc": [], "test_acc": []}
    begin = time.time()
    for ep in range(cfg.num_epochs):
        with trace_annotation("train_epoch"):
            losses.append(step(x, y, tr_m))
        if (ep + 1) % cfg.eval_every == 0 or ep + 1 == cfg.num_epochs:
            tr_a, te_a = accs()
            history["train_acc"].append(tr_a)
            history["test_acc"].append(te_a)
            if log_fn is not None:
                log_fn(ep + 1, {"loss": float(losses[-1]), "train_acc": tr_a,
                                "test_acc": te_a})
    history["loss"] = torch.stack(losses).tolist() if losses else []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.time() - begin

    # every rank's logits, back in the original node ids
    logits = collectives.all_gather_rows(fwd(x), mesh.group).cpu().numpy()
    ypred = logits[inv[:old_n]][None]  # [1, N_pad_old, C]
    result_train, result_test = eval_node(
        ypred[:, :n_real], np.asarray(labels)[None], train_idx, test_idx)
    return {
        "params": model.state_dict(),
        "opt_state": opt.state_dict(),
        "ypred": ypred,
        "train_idx": train_idx,
        "test_idx": test_idx,
        "history": history,
        "result_train": result_train,
        "result_test": result_test,
        "elapsed": elapsed,
        "n_dev": n_dev,
        "halo_size": plan.halo_size,
    }


def train_graph_classifier(
    model: torch.nn.Module,
    train_batcher,
    cfg: TrainConfig,
    val_batcher=None,
    test_batcher=None,
    linkpred: bool = False,
    seed: int = 0,
    log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
    max_eval_examples: Optional[int] = 100,
    mesh=None,
    init_params: Optional[Dict[str, torch.Tensor]] = None,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Minibatch graph classification (``tpugraph/train/loop.py:699``):
    Adam at lr 0.001 with ``cfg.clip`` and no weight decay (the
    reference's fixed choice for this task), batches of
    ``cfg.batch_size`` graphs in the order of ``np.random.default_rng(seed)``,
    and every ``cfg.eval_every`` epochs (and after the last) the accuracy
    on the first ``max_eval_examples`` training graphs and on all of the
    validation and test graphs, with best-validation tracking.

    ``model`` is a :class:`~tpugraph_torch.nn.GcnEncoderGraph` or a
    :class:`~tpugraph_torch.nn.SoftPoolingGcnEncoder` (which also gets
    each batch's ``assign_feats``); it moves to ``device`` (``None`` =
    CUDA) and trains in place from ``init_params`` (a ``state_dict``)
    when given.  ``linkpred`` adds ``link_prediction_loss`` of the first
    assignment tensor.  ``log_fn(epoch, scalars)`` sees each evaluation.
    A model with ``dropout`` draws its masks from a generator on
    ``device`` seeded with ``seed + 1``.  Returns the ``state_dict``, the
    history (``loss`` every epoch; the accuracies at each evaluation),
    ``best_val``, ``test_result``, the cg bundle of the last epoch (its
    first 20 batches and the logits of its first 5) and the seconds of
    the epoch loop.

    With ``mesh`` (a :class:`~tpugraph_torch.parallel.mesh.Mesh`; every
    rank runs this function), each batch is split over the ranks by
    :func:`~tpugraph_torch.parallel.spmd.make_dp_graph_train_step`, whose
    update is the single-device one (``tpugraph/train/loop.py:756-770``);
    ``device`` defaults to the mesh's, and ``cfg.batch_size`` must divide
    by the mesh size."""
    if mesh is not None:
        if cfg.batch_size % mesh.size != 0:
            raise ValueError(
                f"batch_size {cfg.batch_size} must divide by the "
                f"{mesh.size}-device mesh for data parallelism")
        device = mesh.device if device is None else device
    device = default_device(device)
    rng = np.random.default_rng(seed)
    uses_assign = linkpred or getattr(model, "assign_hidden_dim", None) is not None
    model.to(device)
    if init_params is not None:
        model.load_state_dict(init_params)
    opt = build_optimizer(model.parameters(), OptimizerConfig(
        opt="adam", lr=0.001, clip=cfg.clip, weight_decay=0.0))
    drop_gen = None
    if getattr(model, "dropout", 0.0) > 0.001:
        drop_gen = torch.Generator(device=device).manual_seed(seed + 1)

    def tensors(batch):
        dev = lambda a: torch.from_numpy(a).to(device)
        return (dev(batch.adj), dev(batch.feats), dev(batch.node_mask),
                dev(batch.assign_feats) if uses_assign else None)

    def forward(adj, x, mask, assign, gen=None):
        kwargs = {"node_mask": mask, "dropout_gen": gen}
        if uses_assign:
            kwargs["assign_x"] = assign
        return model(x, adj, **kwargs)

    def evaluate(batcher, max_examples=None) -> Dict:
        model.eval()
        preds, labs, seen = [], [], 0
        with torch.no_grad():
            for batch in batcher.batches(cfg.batch_size, shuffle=False,
                                         pad_final=True):
                logits, _ = forward(*tensors(batch))
                preds.append(torch.argmax(logits, dim=-1))
                labs.append(batch.label)
                seen += len(batch.label)
                if max_examples is not None and seen >= max_examples:
                    break
        model.train()
        return eval_graph_preds(torch.cat(preds).cpu().numpy(),
                                np.concatenate(labs))

    if mesh is not None:
        from tpugraph_torch.parallel.spmd import make_dp_graph_train_step

        dp_step = make_dp_graph_train_step(
            model, opt, mesh, linkpred=linkpred, uses_assign=uses_assign,
            has_dropout=drop_gen is not None)

        def train_step(batch):
            return dp_step(drop_gen, *tensors(batch),
                           torch.from_numpy(batch.label).to(device))
    else:
        def train_step(batch):
            adj, x, mask, assign = tensors(batch)
            logits, aux = forward(adj, x, mask, assign, drop_gen)
            loss = softmax_cross_entropy(
                logits, torch.from_numpy(batch.label).to(device))
            if linkpred and isinstance(aux, (list, tuple)) and len(aux) > 0:
                loss = loss + link_prediction_loss(aux[0], adj, mask)
            opt.zero_grad()
            loss.backward()
            opt.step()
            return loss, logits

    history: Dict[str, List[float]] = {"loss": [], "train_acc": [],
                                       "val_acc": [], "test_acc": []}
    best_val = {"epoch": 0, "acc": 0.0, "loss": 0.0}
    test_result = {"epoch": 0, "acc": 0.0}
    cg_batches, cg_preds = [], []
    model.train()
    begin = time.time()
    for epoch in range(cfg.num_epochs):
        losses = []
        last = epoch == cfg.num_epochs - 1
        for bi, batch in enumerate(train_batcher.batches(cfg.batch_size,
                                                         shuffle=True, rng=rng)):
            with trace_annotation("train_step"):
                loss, logits = train_step(batch)
                losses.append(loss.detach())
            if last:
                # the cg bundle: the first 20 batches and the logits of the
                # first 5 (tpugraph/train/loop.py:819-824)
                if bi < 20:
                    cg_batches.append(batch)
                if bi < 5:
                    cg_preds.append(logits.detach().cpu().numpy())
        # a Python sum of the float32 losses, in batch order, as tpugraph's
        avg_loss = 0.0
        for v in (torch.stack(losses).tolist() if losses else []):
            avg_loss += v
        avg_loss /= max(len(losses), 1)
        history["loss"].append(avg_loss)

        if epoch % cfg.eval_every == 0 or last:
            tr = evaluate(train_batcher, max_eval_examples)
            history["train_acc"].append(tr["acc"])
            scalars = {"loss": avg_loss, "train_acc": tr["acc"]}
            if val_batcher is not None and len(val_batcher) > 0:
                vr = evaluate(val_batcher)
                history["val_acc"].append(vr["acc"])
                scalars["val_acc"] = vr["acc"]
                if vr["acc"] > best_val["acc"] - 1e-7:
                    best_val = {"epoch": epoch, "acc": vr["acc"],
                                "loss": avg_loss}
            if test_batcher is not None and len(test_batcher) > 0:
                te = evaluate(test_batcher)
                history["test_acc"].append(te["acc"])
                test_result = {"epoch": epoch, "acc": te["acc"]}
                scalars["test_acc"] = te["acc"]
            if log_fn is not None:
                log_fn(epoch, scalars)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.time() - begin

    cg_dict = None
    if cg_batches:
        cg_dict = {
            "adj": np.concatenate([b.adj for b in cg_batches], axis=0),
            "feat": np.concatenate([b.feats for b in cg_batches], axis=0),
            "label": np.concatenate([b.label for b in cg_batches], axis=0),
            "num_nodes": np.concatenate([b.num_nodes for b in cg_batches], axis=0),
            "pred": np.concatenate(cg_preds, axis=0)[None],
            "train_idx": np.arange(len(train_batcher)),
        }
    return {"params": model.state_dict(), "history": history,
            "best_val": best_val, "test_result": test_result, "cg": cg_dict,
            "elapsed": elapsed}
