"""Port of ``tpugraph/train/loop.py``: full-batch node classification on
the static-weight aggregation formats.

The JAX loop fuses epochs into one ``lax.scan`` per device call; here it
is an eager Python loop, one optimizer step per epoch, with the same node
split RNG and the same per-epoch metrics (loss and accuracies of the
training-mode forward, before the update).

``use_bcsr=True`` picks the format as ``tpugraph/train/loop.py:316-475``
does (:func:`resolve_bcsr_format`):

* ``bcsr_format="packets"`` — edge packets at ``packet_geom``, kernel B7;
* ``bcsr_resident="on"`` — column-stacked tiles (``stack=1``, padded to
  64), int8 when every weight is an integer in [-127, 127] and bf16
  otherwise, kernel B4;
* otherwise dense f32 tiles, kernel B1, or B3 with ``bcsr_k_pack > 1``
  (``-1`` picks it from the tile counts).

``"auto"`` resolves to tiles with resident off on the card, as the JAX
package does on any device that is not a TPU; its TPU cost model is not
ported.  The COO path raises; GAT (``att=True``) is not ported, so no
model here takes the JAX package's GAT-on-BCSR branch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpugraph_torch._device import DeviceLike, default_device
from tpugraph_torch.core.graph import Graph
from tpugraph_torch.nn.layers import Adjacency, BCSRAdj, PacketAdj, StackedAdj
from tpugraph_torch.nn.losses import node_cross_entropy
from tpugraph_torch.ops.bcsr import (bcsr_from_coo, bcsr_transpose_host,
                                     choose_k_pack_counts, coo_tile_counts)
from tpugraph_torch.ops.packets import pack_edges, pack_edges_transpose
from tpugraph_torch.ops.resident_kernels import stack_bcsr
from tpugraph_torch.train.metrics import eval_node
from tpugraph_torch.train.optim import OptimizerConfig, build_optimizer


_RESIDENT_K_PACK = 64  # stacks padded to this multiple (tpugraph/train/loop.py:429)


@dataclasses.dataclass
class TrainConfig:
    """The ``tpugraph`` ``TrainConfig`` fields this path reads
    (``tpugraph/train/loop.py:35``), with ``use_bcsr`` on by default (the
    COO path is not ported).  ``packet_compute_dtype`` is the port's own:
    B7's compute dtype on the packet path (``None``: bf16 on a CUDA
    device, f32 on the CPU, the JAX package's accelerator/interpret
    default).

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
    opt: str = "adam"
    opt_scheduler: str = "none"
    use_bcsr: bool = True
    bcsr_block: int = 128
    bcsr_k_pack: int = 0  # 0 off, >1 fixed, -1 chosen from the tile counts
    packet_geom: Tuple[int, int, int] = (512, 256, 128)  # block_r, block_c, K
    bcsr_format: str = "auto"    # "tiles", "packets" or "auto"
    bcsr_resident: str = "auto"  # "on", "off" or "auto"
    packet_compute_dtype: Optional[torch.dtype] = None


def resolve_bcsr_format(cfg: TrainConfig, n_live: int, t_probe: int,
                        density: float, low_locality: bool,
                        on_tpu: bool, att: bool = False) -> str:
    """The aggregation format (``tpugraph/train/loop.py:137``): an
    attention model or ``bcsr_resident="on"`` forces ``"tiles"``; an
    explicit ``bcsr_format`` wins next; ``"auto"`` is ``"tiles"`` unless
    ``on_tpu`` and the graph is low-locality.  That last case is the JAX
    package's cost model over TPU-measured rates; the port has no rates
    of its own yet, so it raises there.  The port always passes
    ``on_tpu=False``."""
    if att or cfg.bcsr_resident == "on":
        return "tiles"
    fmt = cfg.bcsr_format
    if fmt != "auto":
        return fmt
    if not (on_tpu and low_locality and density < 3e-3):
        return "tiles"
    raise NotImplementedError(
        f"bcsr_format='auto' on a low-locality graph ({n_live} edges, "
        f"{t_probe} tiles) needs a cost model with measured rates, which "
        "is not ported; set bcsr_format")


def build_adjacency(g: Graph, cfg: TrainConfig,
                    device: torch.device) -> Tuple[Adjacency, int]:
    """Pack ``g`` in the format ``cfg`` selects and move it to ``device``
    (``tpugraph/train/loop.py:316-475``); returns the adjacency and the
    padded node count it needs (a multiple of the block)."""
    s_np = g.senders.numpy()
    r_np = g.receivers.numpy()
    w_np = g.edge_weight.numpy()
    n_pad = g.num_nodes_padded
    fmt = resolve_bcsr_format(cfg, int((w_np != 0).sum()), 1, 1.0, False,
                              on_tpu=False)
    if fmt not in ("tiles", "packets"):
        raise ValueError(f"unknown bcsr_format {fmt!r}")
    if fmt == "packets":
        br, bc, kk = cfg.packet_geom
        p = pack_edges(s_np, r_np, w_np, n_pad, block_r=br, block_c=bc, k=kk)
        p_t = pack_edges_transpose(s_np, r_np, w_np, n_pad, block_r=br,
                                   block_c=bc, k=kk)
        return (PacketAdj(p.to(device), p_t.to(device),
                          cfg.packet_compute_dtype), p.num_nodes)
    block = cfg.bcsr_block
    if cfg.bcsr_resident == "on":
        integral = bool(np.all(w_np == np.rint(w_np))
                        and np.abs(w_np).max(initial=0) <= 127)
        tdt = torch.int8 if integral else torch.bfloat16
        if not integral:
            print("tpugraph_torch: the resident path quantizes non-integral "
                  "adjacency weights to bf16 tiles (use bcsr_resident='off' "
                  "for exact f32-tile aggregation)", flush=True)
        m = bcsr_from_coo(s_np, r_np, w_np, n_pad, block=block, tile_dtype=tdt)
        st = stack_bcsr(m, stack=1, k_pack=_RESIDENT_K_PACK).to(device)
        del m
        m_t = bcsr_transpose_host(s_np, r_np, w_np, n_pad, block=block,
                                  tile_dtype=tdt)
        st_t = stack_bcsr(m_t, stack=1, k_pack=_RESIDENT_K_PACK).to(device)
        return StackedAdj(st, st_t), st.num_nodes
    if cfg.bcsr_k_pack < 0:
        kp = choose_k_pack_counts(coo_tile_counts(s_np, r_np, n_pad,
                                                  block=block, weights=w_np))
    else:
        kp = cfg.bcsr_k_pack
    prt = kp if kp > 1 else None
    m = bcsr_from_coo(s_np, r_np, w_np, n_pad, block=block,
                      pad_rows_to=prt).to(device)
    m_t = bcsr_transpose_host(s_np, r_np, w_np, n_pad, block=block,
                              pad_rows_to=prt).to(device)
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
    init_params: Optional[Dict[str, torch.Tensor]] = None,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Full-batch node classification on one padded graph
    (``tpugraph/train/loop.py:279``).

    ``model`` is a :class:`tpugraph_torch.nn.GcnEncoderNode`; it moves to
    ``device`` (``None`` = CUDA) and trains in place, starting from
    ``init_params`` (a ``state_dict``) when given.  ``feat`` is
    ``float32[N_pad, D]``, ``labels`` ``int[N_real]``.  Returns params
    (the ``state_dict``), ``ypred [1, N_pad, C]``, the split, the metric
    history, train/test results, the seconds of the epoch loop
    (``"elapsed"``) and of packing and uploading the adjacency
    (``"pack_s"``), and the packed adjacency (``"adj"``).
    """
    if not cfg.use_bcsr:
        raise NotImplementedError("the COO path (use_bcsr=False) is not "
                                  "ported yet")
    device = default_device(device)
    rng = np.random.default_rng(seed)
    n_real = g.n_node
    train_idx, test_idx = split_nodes(n_real, cfg.train_ratio, rng)

    t_pack = time.perf_counter()
    sp, n_new = build_adjacency(g, cfg, device)
    pack_s = time.perf_counter() - t_pack

    feat_pad = np.zeros((n_new, feat.shape[1]), dtype=np.float32)
    feat_pad[: feat.shape[0]] = feat
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

    model.to(device)
    if init_params is not None:
        model.load_state_dict(init_params)
    model.train()
    opt = build_optimizer(model.parameters(), OptimizerConfig(
        opt=cfg.opt, lr=cfg.lr, scheduler=cfg.opt_scheduler,
        weight_decay=cfg.weight_decay, clip=cfg.clip))

    def acc(correct, mask):
        return torch.sum(correct * mask) / torch.clamp(torch.sum(mask), min=1.0)

    hist: Dict[str, List[torch.Tensor]] = {"loss": [], "train_acc": [],
                                           "test_acc": []}
    begin = time.time()
    for _ in range(cfg.num_epochs):
        logits, _ = model(x, sp)
        loss = node_cross_entropy(logits, y, node_mask=train_mask_d)
        opt.zero_grad()
        loss.backward()
        opt.step()
        with torch.no_grad():
            correct = (torch.argmax(logits, dim=-1) == y).float()
            hist["loss"].append(loss.detach())
            hist["train_acc"].append(acc(correct, train_mask_d))
            hist["test_acc"].append(acc(correct, test_mask_d))
    history = {k: (torch.stack(v).tolist() if v else [])
               for k, v in hist.items()}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.time() - begin

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
    }
