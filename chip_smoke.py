"""Smoke test of the PyTorch/CUDA port (``tpugraph_torch``) on one NVIDIA card.

Run from the repository root:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``tpugraph_torch/csrc`` (one
nvcc per source, sm_90a, all started together), then:

1. kernels — holds B1 ``spmm_bcsr`` and B2 ``sddmm_bcsr`` against their
   plain PyTorch versions on the card at the syn1 shapes of the main path
   (768 nodes, D = 10 and 20) and at a scaled shape (a seeded banded graph,
   65,536 nodes, +-1,024 band, 16 neighbours a node, D = 128), and times
   the kernel, the plain version and, where one exists, a single PyTorch
   library call computing the same function (a yardstick only; the port
   never calls it); then B2 on ``b2-mixed`` tiles with a crossover sweep,
   and B1/B3 on ``b1-mixed`` tiles (0-90% full, int8 weights in [-127,
   127]) by default and with each branch forced, and B1's crossover sweep
   (``B1 crossover``);
2. train — ``train_node_classifier`` on syn1 (seed 0) at its published
   widths (10 -> 20 -> 20 -> 20, 3 GraphConv layers, 4 classes), 1000
   epochs on the BCSR path (``use_bcsr=True``); first holds 20 epochs on
   the card against the CPU run from the same initial parameters;
3. explain — writes and reloads the checkpoint, then ``explain_nodes_bcsr``
   on five house nodes and the motif AUC; the same five nodes again with
   bf16 kernel tiles (the Explainer's private ``_spmm_dtype`` hook onto
   ``run_bcsr_mask_optimization(spmm_dtype=bf16)``, AUC > 0.9 too); then ``bench_explain.py:60-116``'s configuration (a
   65,536-node banded graph, degree 32, band 192, block 256,
   ``GcnEncoderNode(10, 20, 20, 4, 3)``, 100 mask epochs) in f32 and bf16,
   with B1 (bf16 tiles) and B2 (bf16 support) measured at that shape;
4. lowloc — the repo's production-scale low-locality training
   configuration (``bench_train.py:84-99``): a Chung-Lu power-law graph of
   65,536 nodes and 2,097,152 directed unit-weight edges (32 neighbours a
   node on average, seed 0, degree-sorted labels), N(0,1) features,
   ``GcnEncoderNode(128, 128, 128, label_dim=4, num_layers=3)`` at
   ``bcsr_block=256``, nothing cut.  First a reduced copy (4,096 nodes,
   block 128, 10 epochs) trains in the four static-weight formats —
   ``tiles`` (B1), ``bcsr_k_pack=4`` (B3), ``bcsr_resident="on"`` (B4,
   int8 tiles) and ``bcsr_format="packets"`` (B7) — on the card and on the
   CPU from the same parameters; then the full graph trains 100 epochs in
   each format from one set of parameters, and each format's kernel is
   held against its plain version on that format's own packed adjacency
   (D = 128).  B4's tensor-core phase is also run in each diagnostic mode
   of ``_spmm_stacked_ablation`` (D1) and with a bf16 output and on a
   16,384-node copy of the graph (D4), printed as ``resident_ablation``.  Small-shape variants (B4 with bf16 tiles, stack=2, int4,
   bf16 x and a bf16 output; B7 with f32 compute) are checked on the
   reduced graph, and the B1/B3 dtype options (int8 tiles, bf16 x, f32
   and bf16 outputs) on the full one, with B1 against B4 on the same int8
   weights (``B1 int8 vs B4 int8``);
5. diffuse — the repo's diffusion configuration (``bench.py:263-283``) on
   the same power-law graph: ``DiffusionOperator(g, block=256)``
   sym-normalized (bf16 tiles, 8 hops) and unnormalized (int8 tiles,
   ``hop_scale = 1/m^2``, 2 hops) on seeded N(0,1) bf16 x, D = 128.  Each
   operator runs ``op(x, hops)`` (B6) and ``spmm_pair_resident`` (B5);
   B5's f32 output is held against two f32 ``torch.sparse.mm`` calls
   entry by entry within its rounding bound, and B5/B6 against their plain
   versions, with pack seconds and diffusion edges/s (``2 * E * hops / t``,
   ``bench.py:678``);
6. coo — the COO main path, through the entry points a user calls:
   ``tpugraph_torch.cli.train.main`` and ``cli.explain.main`` on syn1 at
   its published widths (10 -> 20 -> 20, 3 layers, 4 classes, 1000
   epochs, seed 0) in this process, on the COO default (train, then the
   stats explain of 60 nodes x 100 mask epochs), with ``--bcsr`` (train
   in the format ``auto`` picks on the card, B4's stacks, with B4 then
   held to its plain version on the CLI's own stacks of A and A^T at D =
   10 and 20; ``--explain-node 305`` on B1/B2 in tile space; the stats
   explain) and with ``--bcsr --bcsr-format packets`` (train on B7); each
   train reaches test acc >= 0.85 and each stats explain AUC > 0.9, and
   the kernels' launches under the CLI are counted.  Then
   ``bench_explain.py:138-156``'s COO yardstick on the banded graph of
   phase 3 (one query, every edge, 4 epochs) beside the tile-space rate.
   The lowloc phase trains the power-law graph on COO as a fifth row,
   ``coo``, held to the ``tiles`` trajectory, and in the format the
   card's ``auto`` rule picks as a sixth, ``auto`` (its pick printed);
   the ``tiles``/``k_pack4`` rows pin their format, and phase 2 pins
   ``bcsr_resident="off"``, where ``auto`` would pick the resident
   format on the card;
7. syn — the rest of the paper's node suite through the same entry
   points, each ``cli.train`` (1000 epochs) followed by the stats
   ``cli.explain`` (60 nodes x 100 mask epochs): syn2-syn5 on COO, syn3
   with ``--bcsr`` (auto: the resident format) and a tile-space
   ``--explain-node 305``, syn1 with ``--method att`` on COO and with
   ``--bcsr`` (tiles and a transpose plan: B2 scores and B1 in every
   step, counted under ``cli_att_bcsr``, plus a tile-space explain), and
   syn1 with ``--bn``, each run and timed in the default mode (atomic COO
   sums), syn1's and syn2's AUCs above 0.9.  Then each row's train and
   stats explain run again under ``torch.use_deterministic_algorithms``
   (COO sums in edge order, so the figures repeat), and their test acc
   and AUC stay within 0.02 of the port's CPU run
   (``syn_cpu_figures.json``, from ``syn_cpu_figures.py --write``).  B4
   at the shapes of syn3's (and, in phase 6, syn1's) ``--bcsr``: the
   CLI's own stacks of A and A^T at D = 10 and 20, bf16 x; B1 and B2 at
   the attention path's shapes (syn1's tiles scaled by their scores, and
   their transpose);
8. graph — the paper's second experiment through the same entry points:
   SYNBENCH (``bench_catalog.py:54-101``, written here without networkx:
   1,000 TU-format graphs of 12-80 nodes, seed 0) trained by ``cli.train
   --bmname SYNBENCH --max-nodes 100`` at the default widths (hidden and
   output 20, 3 GraphConv layers, batches of 20, Adam at 0.001 with clip
   2.0; DiffPool with assign ratio 0.1 and one pooling stage): base 20
   epochs (test acc >= 0.9), ``--method att`` 10 and ``--method
   soft-assign --linkpred`` 10 (loss finite, train acc > 0.5), graphs/s
   each; a 64-graph copy 5 epochs on the card (deterministic) and on the
   CPU from the same weights (losses within 1e-4); ``cli.explain
   --graph-mode`` (graphs 1-4), ``--graph-idx 0`` and ``--multigraph-class
   0`` (31 graphs) on the base checkpoint, each mask finite, square and
   not all zero; then ``Explainer.explain_graph_bcsr`` on graphs 1-4 at
   block 128 (B1 forward and backward, B2 for the mask gradient, launches
   counted under ``graph_explain_bcsr``), and B1/B2 held to their plain
   versions at that path's shapes (one 128^2 tile, D = the feature width
   and 20);
9. opt — syn1 (seed 0, published widths, 1000 epochs) through
   ``cli.train`` with ``--opt sgd``, ``--opt rmsprop``, ``--opt adagrad
   --opt-scheduler step``, ``--opt-scheduler cos`` (Adam) and ``--opt sgd
   --bcsr`` (auto: B4's stacks, launches under ``cli_opt_sgd_bcsr_train``):
   epochs/s, test acc and the last loss of each, and each row's first 20
   epochs held within 1e-4 of the port's CPU run of the same flags
   (deterministic mode); then ``--resume`` on COO and on ``--bcsr``: 500
   epochs of Adam with a step decay every 250, 500 more resumed, held
   within 1e-6 of 1000 straight (deterministic mode), the update count
   1000 in ``opt_state.pt``;
10. baselines — ``cli.explain --explainer-model grad`` (the stats over
   nodes 400:700:5) on the coo phase's syn1 checkpoint and
   ``--explainer-model att`` on the syn phase's ``--method att`` one, each
   mask within 1e-5 of the port's CPU masks from the same checkpoint (the
   AUC, the CPU's AUC and the seconds printed); ``--explain-node 305
   --explainer-model grad``; ``--multinode-class 0`` (``aligned`` and
   ``aligned_adj.npy``), with ``align_explanations`` on the card and on
   the CPU from that run's own inputs (the 1000-step run is chaotic, so
   from the card's state at every 100th step the CPU takes 10 steps and
   lands within 1e-4 of the card's P); the grad baseline of
   SYNBENCH graph 1 in graph mode, card against CPU within 1e-5.  The
   baselines run the model's dense path and launch no kernel;
11. tasks — ROADMAP item 9's tasks through ``cli.train`` on fixtures it
   writes without networkx (``write_task_fixtures``: a BioSnap PPI set of
   2,000 genes, Enron's 10 slices of 146 nodes as networkx pickles, a
   ``--pkl`` bundle of 240 graphs): ``--pkl``, ``ppi_essential`` on COO
   and ``--bcsr`` (auto: B4), ``enron`` and ``enron_multigraph``, each
   timed and its first 20 epochs held within 1e-4 of the CPU's
   (deterministic mode; the ``--bcsr`` row to the CPU's resident twin);
12. parallel — the multi-device paths at the card's one rank: the g++
   graph engine (its C++ and numpy halo plans of syn1 equal); the 4-shard
   halo plans (locality partition, block 128) of syn1 (the CLI's graph,
   D = 10 and 20) and of the power-law graph (D = 128), every shard's
   rectangular ``[local | halo]`` tiles (dead tiles included), their
   transpose, the attention backward's transposed scores and the overlap
   split's local and halo tiles through B1, and the tiles through B2,
   each held to its plain version, with each shard's dead tiles,
   ``halo_size`` and ``partition_cut_stats`` printed;
   ``train_node_classifier_halo(n_dev=1)`` over a 1-rank NCCL group on
   syn1 at its published widths, 1000 epochs, on COO (deterministic),
   tiles (B1), attention on tiles (B1 + B2) and the overlap split, each
   row's first 20 epochs within 1e-4 of the CPU's run of the same
   function over a 1-rank gloo group and its test acc within one test
   node of the CPU's evaluation of the card's weights; the power-law
   graph 100 epochs on the tile halo path beside the lowloc ``tiles``
   row; SYNBENCH 20 epochs through ``train_graph_classifier`` on a
   1-rank mesh within 1e-5 of the single-device run; and ``cli.train
   --halo 2`` raising the launcher's device-count error before anything
   runs;
13. mesh — the explainer's query sharding and tensor parallelism at the
   card's one rank, on the coo phase's syn1 checkpoints (COO and
   ``--bcsr``): ``explain_nodes_batch(mesh=)`` over a 1-rank NCCL group
   on the 60 stats nodes against the single-device card run (both
   deterministic, 1e-6) with the two AUCs, and with 20 mask epochs
   against the CPU's over a 1-rank gloo group (1e-4);
   ``explain_nodes_bcsr(mesh=)`` on nodes 400:700:60 (B1 forward and on
   the laid-out transpose, B2 for the mask gradient: their launches
   under ``mesh_bcsr_explain``) against the sequential card run (1e-6)
   and with 20 epochs the CPU's (1e-4), and B1/B2 held to their twins on
   the explainer's pack at D = 10 and 20; the tensor-parallel step
   (``parallel/tp.py``) at world size 1, 20 Adam steps on syn1 held to
   one device's losses (1e-5) and on the power-law graph at width 128
   beside the single-device COO step (steps/s); ``cli.explain --mesh
   2`` raising the launcher's device-count error before anything is
   written; printed as ``mesh``;
14. profile — ``torch.profiler`` traces (``utils/profiling.py``) of 30
   syn1 epochs on COO and on ``--bcsr`` (auto: B4) and of one SYNBENCH
   epoch: for the last 10 epochs or steps, the device-busy share (the
   union of their kernels' intervals over the wall window, and over the
   unprofiled wall), the launches and the microseconds of wall a launch,
   printed as ``profile``;
15. launch_probes — D3's probes (``bench_palcall_diag.py``): chains of 200
   dependent launches of ``probe_tiny`` (grid 1 and 2) and
   ``probe_resident`` (n = 4,096, 16,384, 65,536), a fit of the time a
   launch against the bytes it writes, and the host cost of one wrapper
   call, printed as ``launch_probes``.

Every file a CLI call writes is parsed (PNG signature and IHDR, PDF
header, xref and ``%%EOF``, event records and their CRCs; the totals
printed as ``renders``), and the first line printed is ``packages``:
whether matplotlib, scipy, networkx and sklearn are installed.  The
``syn`` and ``opt`` rows' test accuracy is also held, within one test
node, to the CPU's evaluation of the checkpoint the card wrote, and
``--opt sgd --bcsr``'s first 20 epochs (B4) to the CPU's resident twin
within 1e-5.

Every kernel is held to its plain version entry by entry: within an f32
reordering term and a bf16 ulp for each earlier rounding point, both
scaled by the largest value of the entry's own output row (so light rows
are not hidden behind the hub rows), plus an ulp of the entry itself for
a bf16 output.  Each
phase fails the run if its check fails.  The last two lines are the
``kernels`` JSON object and ``{"ok": true, "device": {...}}``.  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
BF16_REL = 2.0 ** -8        # one bf16 rounding (8 significant bits)
BF16_ULP = 2.0 ** -7        # one bf16 ulp, relative
F32_U = 2.0 ** -24          # float32 unit roundoff
TINY = 1.1754943508222875e-38  # smallest normal float32: the floor of a zero row
# B6 against its plain version, besides the output's own rounding: one bf16
# ulp of a row's largest value for the last hop's y, and two for flips at
# earlier hops, which reach a row only through A_t A's averaging
POWER_CARRIED = 3
EPOCHS = 1000
EXPLAIN_NODES = list(range(400, 700, 60))
LOWLOC_NODES, LOWLOC_DEG, LOWLOC_D, LOWLOC_BLOCK = 65536, 32, 128, 256
LOWLOC_EPOCHS = 100
REDUCED_NODES, REDUCED_BLOCK, REDUCED_EPOCHS = 4096, 128, 10
SMALLN_NODES = 16384  # bench_resident_diag3.py's smalln
PROBE_K = 200         # dependent launches a probe chain (bench_palcall_diag.py's K)
PROBE_NS = (4096, 16384, 65536)
# bench_explain.py:61: banded graph, nodes, degree, band, block; 100 epochs
BANDED_NODES, BANDED_DEG, BANDED_BAND, BANDED_BLOCK = 65536, 32, 192, 256
BANDED_EPOCHS = 100
# (tag, normalize, hops): the repo's diffusion configuration, bench.py:263-283
# (DIFF_H = 8 on the sym-normalized operator) and the unnormalized int8
# operator with hop_scale = 1/m^2 at 2 hops
DIFF_CASES = (("normalized", True, 8), ("int8", False, 2))
FORMATS = {  # TrainConfig fields of each static-weight format, and COO
    "tiles": {"use_bcsr": True, "bcsr_format": "tiles", "bcsr_resident": "off"},
    "k_pack4": {"use_bcsr": True, "bcsr_format": "tiles", "bcsr_resident": "off",
                "bcsr_k_pack": 4},
    "resident": {"use_bcsr": True, "bcsr_resident": "on"},
    "packets": {"use_bcsr": True, "bcsr_format": "packets"},
    "coo": {"use_bcsr": False},
}
EXPLAIN_STATS_NODES = 60   # the stats explain: nodes 400:700:5
CARD = "not read"          # nvidia-smi's name and power limit, set in main
FORMAT_KERNEL = {"tiles": "spmm_bcsr", "k_pack4": "spmm_bcsr_packed",
                 "resident": "spmm_stacked_resident", "packets": "spmm_packets"}
AUTO = {"use_bcsr": True}  # bcsr_format and bcsr_resident "auto": the card's rule


def format_ran(counts):
    """The aggregation format a run took, from its kernel launches."""
    ran = [f for f, k in FORMAT_KERNEL.items() if counts.get(k)]
    if not ran:
        return "coo"
    if ran == ["tiles"] and counts.get("sddmm_bcsr"):
        return "tiles_att"
    return "+".join(ran)


def auto_line(text):
    """The format rule's printed decision in a captured output, if any."""
    lines = [ln for ln in text.splitlines() if "bcsr_format auto ->" in ln]
    return f"({lines[-1].split(': ', 1)[1]}) " if lines else ""


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, warmup: int = 3, iters: int = 21) -> float:
    """Median of ``iters`` single calls timed with CUDA events (inputs warm
    in L2, as in the training and explain loops)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def banded_edges(n: int, band: int, degree: int, seed: int):
    """``degree`` random in-neighbours within +-``band`` for every node."""
    import numpy as np

    rng = np.random.default_rng(seed)
    recv = np.repeat(np.arange(n, dtype=np.int64), degree)
    off = rng.integers(1, band + 1, recv.size) * rng.choice([-1, 1], recv.size)
    send = recv + off
    ok = (send >= 0) & (send < n)
    w = rng.standard_normal(recv.size).astype(np.float32)
    return send[ok].astype(np.int32), recv[ok].astype(np.int32), w[ok]


def make_banded_graph(n: int, deg: int, bandwidth: int, seed: int = 0):
    """Symmetric graph whose edges stay within a node-id band (a copy of
    ``bench.py:44``): ``deg / 2`` random forward offsets in ``[1, band)``
    a node, both directions, unit weights."""
    import numpy as np

    rng = np.random.default_rng(seed)
    half = deg // 2
    src = np.repeat(np.arange(n, dtype=np.int64), half)
    off = rng.integers(1, bandwidth, size=src.shape[0])
    dst = (src + off) % n
    s = np.concatenate([src, dst]).astype(np.int32)
    r = np.concatenate([dst, src]).astype(np.int32)
    return s, r, np.ones(s.shape[0], dtype=np.float32)


def make_powerlaw_graph(n: int, avg_deg: int, seed: int = 0,
                        gamma: float = 2.5):
    """Chung-Lu scale-free graph (a copy of ``bench.py:58``): endpoints
    drawn in proportion to a power-law weight sequence, both directions,
    unit weights."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w = (np.arange(n) + 10.0) ** (-1.0 / (gamma - 1.0))
    p = w / w.sum()
    target = n * avg_deg // 2
    src = rng.choice(n, size=int(target * 1.3), p=p)
    dst = rng.choice(n, size=int(target * 1.3), p=p)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    uniq = np.unique(lo.astype(np.int64) * n + hi)[:target]
    lo, hi = (uniq // n).astype(np.int32), (uniq % n).astype(np.int32)
    s = np.concatenate([lo, hi])
    r = np.concatenate([hi, lo])
    return s, r, np.ones(s.shape[0], dtype=np.float32)


def powerlaw_task(n: int, d: int, seed: int = 0):
    """The low-locality training task of ``bench_train.py:87-98``: the
    power-law graph relabelled by descending in-degree, N(0, 1) features
    and log-degree quartile labels."""
    import numpy as np

    from tpugraph_torch.core.graph import graph_from_edges

    s, r, w = make_powerlaw_graph(n, LOWLOC_DEG, seed)
    din = np.bincount(r, minlength=n)
    perm = np.argsort(-din, kind="stable")
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    s, r = inv[s].astype(np.int32), inv[r].astype(np.int32)
    g = graph_from_edges(s, r, n, edge_weight=w)
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((g.num_nodes_padded, d)).astype(np.float32)
    deg = np.bincount(r, minlength=n).astype(np.float64)
    labels = np.digitize(
        np.log1p(deg), np.quantile(np.log1p(deg), [0.25, 0.5, 0.75])
    ).astype(np.int32)
    return g, feat, labels


def library_spmm(m, x):
    """One PyTorch call for y = A @ x: a BSR sparse tensor of the widened
    tiles times x cast as the kernel casts it."""
    import torch

    from tpugraph_torch.ops.bcsr_kernels import x_operand

    a = torch.sparse_bsr_tensor(m.row_ptr, m.col_blk, m.tiles.float(),
                                size=(m.num_row_nodes, m.num_nodes))
    xr = x_operand(x, m.tiles.dtype)
    return lambda: a @ xr


def library_sddmm(m, dy, x):
    """One PyTorch call for the support-masked dy @ x^T: sampled_addmm on
    the CSR of the tiles' nonzero pattern."""
    import torch

    t, i, j = (m.tiles != 0).nonzero(as_tuple=True)
    rows = m.row_of.long()[t] * m.block + i
    cols = m.col_blk.long()[t] * m.block + j
    support = torch.sparse_coo_tensor(
        torch.stack([rows, cols]), torch.ones_like(rows, dtype=torch.float32),
        (m.num_row_nodes, m.num_nodes)).coalesce().to_sparse_csr()
    xt = x.t().contiguous()
    return lambda: torch.sparse.sampled_addmm(support, dy, xt, beta=0.0)


def library_stacked(st, x):
    """One PyTorch call for B4's function: a BSR tensor whose blocks are
    the widened stack slices (each ``[B, B]`` slice of a stack its own
    block; all-zero slices dropped) times x cast as the kernel casts it."""
    import torch

    from tpugraph_torch.ops.bcsr_kernels import x_operand
    from tpugraph_torch.ops.resident_kernels import widen_tiles

    tiles = widen_tiles(st).reshape(-1, st.block, st.block)
    cols = st.col_blk.long().repeat_interleave(st.stack)
    live = (tiles != 0).flatten(1).any(1)
    rows, cols = st.rows.long()[live], cols[live]
    order = torch.argsort(rows * (st.num_nodes // st.block) + cols)
    crow = torch.zeros(st.num_row_blocks + 1, dtype=torch.int64,
                       device=x.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=st.num_row_blocks), 0)
    a = torch.sparse_bsr_tensor(crow, cols[order], tiles[live][order],
                                size=(st.num_row_nodes, st.num_nodes))
    xr = x_operand(x, st.tiles.dtype)
    return lambda: a @ xr


def library_packets(p, x):
    """One PyTorch call for B7's function (f32): ``torch.sparse.mm`` of the
    CSR of the live edge slots."""
    import torch

    live = p.w != 0
    rows = (p.row_of.long()[:, None] * p.block_r + p.rows.long())[live]
    cols = (p.col_blk.long()[:, None] * p.block_c + p.cols.long())[live]
    a = torch.sparse_coo_tensor(torch.stack([rows, cols]), p.w[live],
                                (p.num_nodes, p.num_nodes)
                                ).coalesce().to_sparse_csr()
    return lambda: torch.sparse.mm(a, x)


def measure_case(name, shape, d, run, plain, library, nbytes, ops, peak,
                 tol_k, carried=0, extra=None, iters=21, scale=None):
    """One kernel against its plain version on one input, entry by entry:
    ``|got - ref| <= rel * row + BF16_ULP * |ref|`` for a bf16 output (one
    flip of its own rounding, at most an ulp of the entry itself; without
    that term for f32), where ``row`` is the largest |ref| of the entry's
    output row (the last axis) and ``rel = 1e-5 * sqrt(tol_k) + carried *
    BF16_ULP`` (f32 sums of ``tol_k`` terms in another order, and one bf16
    ulp for each earlier rounding point whose flips a later phase spreads
    over the row).  A light row is held to its own scale, not the hub
    rows'.  ``scale`` (a function giving a tensor of the output's shape)
    replaces ``row`` with a per-entry scale: for a dot product, the sum of
    its terms' magnitudes, which bounds its f32 rounding where cancellation
    leaves the value itself far below its terms.  Then kernel, plain and library times (median of ``iters``) and
    the bound, the larger of bytes over HBM rate and ``ops`` over
    ``peak``."""
    import torch

    got = run()
    ref = plain()
    torch.cuda.synchronize()
    out_bf16 = ref.dtype == torch.bfloat16
    ref = ref.float().reshape(-1, got.shape[-1])
    diff = (got.float().reshape(ref.shape) - ref).abs()
    del got
    row = (ref.abs().amax(1, keepdim=True) if scale is None
           else scale().float().reshape(ref.shape))
    rel = 1e-5 * math.sqrt(tol_k) + carried * BF16_ULP
    tol = rel * row + TINY
    if out_bf16:
        tol = tol + BF16_ULP * ref.abs()
    del ref
    err = float(diff.max())
    worst = float((diff / (row + TINY)).max())
    used = float((diff / tol).max())
    bad = int((diff > tol).sum())
    del diff, row, tol
    what = "row's largest value" if scale is None else "sum of |terms|"
    check(bad == 0, f"{name} on {shape} D={d}: {bad} entries leave their plain "
          f"version by more than {rel:.3g} of their {what}"
          f"{' plus an ulp of their own' if out_bf16 else ''} "
          f"(at most {used:.3g} of that)")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    try:
        lib_ms = time_ms(library(), iters=iters) if library is not None else None
    except (RuntimeError, NotImplementedError) as e:
        print(f"  {name}: library call unsupported here ({type(e).__name__}: "
              f"{str(e).splitlines()[0][:120]})")
        lib_ms = None
    torch.cuda.empty_cache()
    rec = {
        "shape": shape, "d": d, **(extra or {}),
        "max_abs_err": err, "max_row_rel_err": worst, "row_rel_tol": rel,
        "own_ulp_tol": int(out_bf16), "tol_used": used,
        "ms": time_ms(run, iters=iters), "plain_ms": time_ms(plain, iters=iters),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
    }
    torch.cuda.empty_cache()
    extra_s = " ".join(f"{k}={v}" for k, v in (extra or {}).items())
    print(f"  {name:21s} {shape:18s} D={d:<3d} {extra_s} "
          f"kernel_ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
          f"library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)} "
          f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) "
          f"max_abs_err={err:.3g} row_err={worst / BF16_ULP:.3g} ulp "
          f"(tol {rel / BF16_ULP:.3g}{' + 1 own' if out_bf16 else ''}; "
          f"used {used:.3g})", flush=True)
    return rec


def _dtype_extra(m, x, out_dtype):
    """(bytes of tiles, x and output; peak; dtype labels) of one B1/B3
    case: operations at the bf16 rate unless the tiles are f32."""
    import torch

    out_b = 2 if out_dtype == torch.bfloat16 else 4
    name = lambda t: str(t).split(".")[1]
    nbytes = (m.tiles.numel() * m.tiles.element_size()
              + x.element_size() * m.num_nodes * x.shape[1]
              + out_b * m.num_row_nodes * x.shape[1]
              + 4 * (2 * m.num_tiles + m.num_row_blocks + 1))
    peak = F32_FLOPS_PER_S if m.tiles.dtype == torch.float32 else BF16_FLOPS_PER_S
    labels = {"tile": name(m.tiles.dtype), "x": name(x.dtype),
              "out": "bf16" if out_b == 2 else "f32"}
    return nbytes, peak, labels


def measure_spmm(shape, m, x, out_dtype=None, iters=21, extra=None):
    """B1 against its plain version on one BCSR."""
    from tpugraph_torch.ops import bcsr_kernels as bk

    t, b, d = m.num_tiles, m.block, x.shape[1]
    nnz = int((m.tiles != 0).sum())
    max_row_tiles = int((m.row_ptr[1:] - m.row_ptr[:-1]).max())
    nbytes, peak, labels = _dtype_extra(m, x, out_dtype)
    return measure_case(
        "spmm_bcsr", shape, d, lambda: bk.spmm_bcsr(m, x, out_dtype),
        lambda: bk.spmm_bcsr_plain(m, x, out_dtype), lambda: library_spmm(m, x),
        nbytes, 2.0 * nnz * d, peak, max_row_tiles * b,
        extra={"tiles": t, "nnz": nnz, **labels, **_branches(m, d), **(extra or {})},
        iters=iters)


def measure_sddmm(shape, m, dy, x, iters=21, extra=None):
    """B2 against its plain version on one BCSR (f32 dy and x)."""
    from tpugraph_torch.ops import bcsr_kernels as bk

    t, b, d = m.num_tiles, m.block, x.shape[1]
    nnz = int((m.tiles != 0).sum())
    return measure_case(
        "sddmm_bcsr", shape, d, lambda: bk.sddmm_bcsr(m, dy, x),
        lambda: bk.sddmm_bcsr_plain(m, dy, x), lambda: library_sddmm(m, dy, x),
        (m.tiles.element_size() + 4) * t * b * b
        + 4 * (m.num_nodes + m.num_row_nodes) * d + 4 * (2 * t + m.num_row_blocks + 1),
        2.0 * nnz * d, F32_FLOPS_PER_S, d,
        extra={"tiles": t, "nnz": nnz, "support": str(m.tiles.dtype).split(".")[1],
               **(extra or {})},
        scale=lambda: bk.sddmm_bcsr_plain(m, dy.abs(), x.abs()), iters=iters)


def _branches(m, d):
    """The shares of B1/B3's strips that are empty, take the sparse branch
    and take the dense one at this width (the wrapper's crossover)."""
    from tpugraph_torch.ops import bcsr_kernels as bk

    sh = bk.branch_shares(m, d)
    return {"strips_empty": round(sh["empty"], 5), "strips_sparse": round(sh["sparse"], 5),
            "strips_dense": round(sh["dense"], 5)}


def measure_kernels(shape_name, m, d, gen):
    """B1 and B2 against their plain versions on one BCSR."""
    import torch

    dev = m.tiles.device
    x = torch.randn((m.num_nodes, d), generator=gen, device=dev)
    dy = torch.randn((m.num_row_nodes, d), generator=gen, device=dev)
    return {"spmm_bcsr": measure_spmm(shape_name, m, x),
            "sddmm_bcsr": measure_sddmm(shape_name, m, dy, x)}


def random_tiles(n_tiles, density, tile_dtype, gen, n_rb=512, per_rb=4, int8_max=3,
                 block=128):
    """``n_tiles`` block^2 tiles on the card, ``per_rb`` a row block over
    ``n_rb`` row blocks (65,536 nodes at block 128), at random column
    blocks, each entry nonzero with probability ``density`` (a number or
    one per tile); N(0,1) values, integers in [-int8_max, int8_max] for
    int8."""
    import torch

    from tpugraph_torch.ops import bcsr

    dev = torch.device("cuda")
    shape = (n_tiles, block, block)
    dens = torch.as_tensor(density, dtype=torch.float32, device=dev).reshape(-1, 1, 1)
    keep = torch.rand(shape, generator=gen, device=dev) < dens
    if tile_dtype == torch.int8:
        vals = torch.randint(-int8_max, int8_max + 1, shape, generator=gen, device=dev)
    else:
        vals = torch.randn(shape, generator=gen, device=dev)
    tiles = (vals * keep).to(tile_dtype)
    t = torch.arange(n_tiles, device=dev, dtype=torch.int32)
    return bcsr.BCSR(
        tiles=tiles, col_blk=torch.randint(0, n_rb, (n_tiles,), generator=gen,
                                           device=dev, dtype=torch.int32),
        row_ptr=torch.arange(0, n_tiles + 1, per_rb, device=dev, dtype=torch.int32),
        row_of=t // per_rb, num_nodes=n_rb * block, block=block, longest_list=per_rb)


def b2_branches(gen):
    """B2 against its plain version where one launch runs both branches:
    256 tiles whose support densities run from 0 (dead tiles) to 90%, so
    their 64^2 sub-tiles fall on both sides of the crossover; every support
    dtype at D = 10, 20 and 128."""
    import torch

    from tpugraph_torch.ops import bcsr_kernels as bk

    dens = torch.tensor([0.0, 0.002, 0.01, 0.05, 0.2, 0.5, 0.9, 0.03]).repeat(32)
    recs = []
    for tile_dtype in (torch.float32, torch.bfloat16, torch.int8):
        m = random_tiles(256, dens, tile_dtype, gen, n_rb=64)
        nnz = int((m.tiles != 0).sum())
        for d in (10, 20, 128):
            x = torch.randn((m.num_nodes, d), generator=gen, device="cuda")
            dy = torch.randn((m.num_row_nodes, d), generator=gen, device="cuda")
            recs.append(measure_case(
                "sddmm_bcsr", "b2-mixed", d, lambda: bk.sddmm_bcsr(m, dy, x),
                lambda: bk.sddmm_bcsr_plain(m, dy, x), lambda: library_sddmm(m, dy, x),
                (m.tiles.element_size() + 4) * 256 * 128 * 128
                + 4 * (m.num_nodes + m.num_row_nodes) * d, 2.0 * nnz * d,
                F32_FLOPS_PER_S, d, iters=5,
                extra={"tiles": 256, "nnz": nnz,
                       "support": str(tile_dtype).split(".")[1]},
                scale=lambda: bk.sddmm_bcsr_plain(m, dy.abs(), x.abs())))
            off = m.tiles == 0
            got = bk.sddmm_bcsr(m, dy, x)
            check(bool((got[off] == 0).all()) and not bool(torch.signbit(got[off]).any()),
                  "sddmm_bcsr wrote other than +0.0 off the support")
    return recs


def b2_crossover(gen):
    """The support density at which B2's sparse branch stops beating its
    dense one: 2,048 f32 tiles of 128^2 (65,536 nodes) at a uniform random
    density, each branch forced, D = 20 and 128.  Returns the nonzeros a
    64^2 sub-tile holds where the two times cross (interpolated), per D."""
    import torch

    from tpugraph_torch.ops import bcsr_kernels as bk

    out = {}
    for d in (20, 128):
        rows = []
        for dens in (0.01, 0.03, 0.1, 0.2, 0.3, 0.45, 0.6):
            m = random_tiles(2048, dens, torch.float32, gen)
            x = torch.randn((m.num_nodes, d), generator=gen, device="cuda")
            dy = torch.randn((m.num_row_nodes, d), generator=gen, device="cuda")
            sp = time_ms(lambda: bk._sddmm_bcsr_crossover(m, dy, x, 64 * 64), iters=11)
            de = time_ms(lambda: bk._sddmm_bcsr_crossover(m, dy, x, -1), iters=11)
            rows.append((dens * 4096, sp, de))
            del m, x, dy
        torch.cuda.empty_cache()
        cross = None
        for (n0, s0, d0), (n1, s1, d1) in zip(rows, rows[1:]):
            if s0 <= d0 and s1 > d1:
                f = (d0 - s0) / ((d0 - s0) + (s1 - d1))
                cross = n0 + f * (n1 - n0)
                break
        out[d] = {"nnz_per_subtile": cross, "sweep": [
            {"nnz_per_subtile": n, "sparse_ms": s, "dense_ms": e} for n, s, e in rows]}
        print(f"  B2 crossover D={d}: sparse below ~{cross} nonzeros a 64^2 sub-tile; "
              + " ".join(f"{n:.0f}:{s:.3f}/{e:.3f}" for n, s, e in rows)
              + " (nnz: sparse/dense ms)", flush=True)
    return out


def b1_branches(gen):
    """B1 and B3 against their plain versions where one launch runs both
    branches: 256 tiles of 128^2 whose densities run from 0 (dead tiles) to
    90% (int8 weights in [-127, 127]), so their strips fall on both sides
    of the crossover; every tile dtype at D = 10, 20 and 128, f32 x; then
    each branch forced (``_spmm_bcsr_crossover``), held the same way, and
    the two forced outputs compared bit for bit; B3 on the same tiles
    (every row block already holds 4 tiles: k_pack 4).  Then the block
    sizes whose tile rows are not whole 256-byte strips (B = 192 for every
    tile dtype, 320 for int8; 64 tiles, D = 20 and 128), held the same
    way."""
    import torch

    from tpugraph_torch.ops import bcsr_kernels as bk

    dens = torch.tensor([0.0, 0.002, 0.01, 0.05, 0.2, 0.5, 0.9, 0.03]).repeat(32)
    recs = {"spmm_bcsr": [], "spmm_bcsr_packed": []}
    cases = [(t, 128, 256, (10, 20, 128)) for t in (torch.float32, torch.bfloat16, torch.int8)]
    cases += [(t, 192, 64, (20, 128)) for t in (torch.float32, torch.bfloat16, torch.int8)]
    cases += [(torch.int8, 320, 64, (20, 128))]
    for tile_dtype, block, n_tiles, widths in cases:
        shape = "b1-mixed" if block == 128 else f"b1-mixed-B{block}"
        m = random_tiles(n_tiles, dens[:n_tiles], tile_dtype, gen, n_rb=n_tiles // 4,
                         int8_max=127, block=block)
        for d in widths:
            x = torch.randn((m.num_nodes, d), generator=gen, device="cuda")
            recs["spmm_bcsr"].append(measure_spmm(shape, m, x))
            recs["spmm_bcsr_packed"].append(measure_packed(shape, m, 4, x))
            nbytes, peak, labels = _dtype_extra(m, x, None)
            nnz = int((m.tiles != 0).sum())
            forced = {}
            for tag, c in (("dense", -1), ("sparse", 1 << 20)):
                recs["spmm_bcsr"].append(measure_case(
                    "spmm_bcsr", f"{shape}-{tag}", d,
                    lambda c=c: bk._spmm_bcsr_crossover(m, x, c),
                    lambda: bk.spmm_bcsr_plain(m, x), None, nbytes, 2.0 * nnz * d,
                    peak, 4 * block, iters=5, extra={**labels, "forced": tag}))
                forced[tag] = bk._spmm_bcsr_crossover(m, x, c)
            check(bool(torch.equal(forced["dense"], forced["sparse"])),
                  f"B1 forced branches differ ({tile_dtype}, B={block}, D={d})")
    return recs


def b1_crossover(gen):
    """The strip density at which B1's sparse branch stops beating its dense
    one: 2,048 tiles of 128^2 (65,536 nodes) at a uniform random density,
    each branch forced; f32 tiles at D = 20 and 128, int8 tiles at D = 128.
    Returns the nonzeros of a strip (8 rows x strip_k) where the two times
    cross (interpolated), per case."""
    import torch

    from tpugraph_torch.ops import bcsr_kernels as bk

    out = {}
    for tile_dtype, d in ((torch.float32, 20), (torch.float32, 128), (torch.int8, 128)):
        strip = 8 * bk.strip_k(tile_dtype, 128)
        rows = []
        for dens in (0.01, 0.03, 0.1, 0.2, 0.3, 0.45, 0.6, 0.9):
            m = random_tiles(2048, dens, tile_dtype, gen, int8_max=127)
            x = torch.randn((m.num_nodes, d), generator=gen, device="cuda")
            sp = time_ms(lambda: bk._spmm_bcsr_crossover(m, x, 1 << 20), iters=11)
            de = time_ms(lambda: bk._spmm_bcsr_crossover(m, x, -1), iters=11)
            rows.append((dens * strip, sp, de))
            del m, x
        torch.cuda.empty_cache()
        cross = None
        for (n0, s0, d0), (n1, s1, d1) in zip(rows, rows[1:]):
            if s0 <= d0 and s1 > d1:
                f = (d0 - s0) / ((d0 - s0) + (s1 - d1))
                cross = n0 + f * (n1 - n0)
                break
        key = f"{str(tile_dtype).split('.')[1]}_D{d}"
        out[key] = {"nnz_per_strip": cross, "strip_entries": strip,
                    "wrapper": bk.spmm_crossover(d, tile_dtype, 128), "sweep": [
                        {"nnz_per_strip": n, "sparse_ms": s, "dense_ms": e}
                        for n, s, e in rows]}
        print(f"  B1 crossover {key}: sparse below ~{cross} nonzeros of a {strip}-entry "
              f"strip (wrapper {bk.spmm_crossover(d, tile_dtype, 128)}); "
              + " ".join(f"{n:.0f}:{s:.3f}/{e:.3f}" for n, s, e in rows)
              + " (nnz: sparse/dense ms)", flush=True)
    return out


def measure_packed(shape, m, k_pack, x, out_dtype=None):
    """B3 against its plain version on a k_pack-padded BCSR."""
    from tpugraph_torch.ops import bcsr_kernels as bk

    t, b, d = m.num_tiles, m.block, x.shape[1]
    nnz = int((m.tiles != 0).sum())
    max_row_tiles = int((m.row_ptr[1:] - m.row_ptr[:-1]).max())
    nbytes, peak, labels = _dtype_extra(m, x, out_dtype)
    return measure_case(
        "spmm_bcsr_packed", shape, d,
        lambda: bk.spmm_bcsr_packed(m, x, k_pack, out_dtype),
        lambda: bk.spmm_bcsr_packed_plain(m, x, k_pack, out_dtype),
        lambda: library_spmm(m, x),
        nbytes, 2.0 * nnz * d, peak, max_row_tiles * b,
        extra={"tiles": t, "nnz": nnz, "k_pack": k_pack, **labels, **_branches(m, d)})


def measure_stacked(shape, st, x, out_dtype=None):
    """B4 against its plain version on one stacked layout."""
    import torch

    from tpugraph_torch.ops import resident_kernels as rk

    d = x.shape[1]
    wide = rk.widen_tiles(st)
    nnz = int((wide != 0).sum())
    del wide
    n_slices = st.num_tiles * st.stack
    tile_bytes = st.tiles.numel() * st.tiles.element_size()
    x_b = x.element_size()
    out_b = 2 if out_dtype == torch.bfloat16 else 4
    lists = (st.row_ptr[1:] - st.row_ptr[:-1]).float()
    per_rb = int(lists.max())
    peak = F32_FLOPS_PER_S if st.tiles.dtype == torch.float32 else BF16_FLOPS_PER_S
    kind = "int4" if st.packed4 else str(st.tiles.dtype).split(".")[1]
    return measure_case(
        "spmm_stacked_resident", shape, d,
        lambda: rk.spmm_stacked_resident(st, x, out_dtype=out_dtype),
        lambda: rk.spmm_stacked_resident_plain(st, x, out_dtype),
        lambda: library_stacked(st, x),
        tile_bytes + x_b * st.num_nodes * d + out_b * st.num_row_nodes * d
        + 4 * (st.num_tiles + 2 * n_slices + st.num_row_blocks + 1),
        2.0 * nnz * d, peak, per_rb * st.block,
        extra={"tiles": st.num_tiles, "stack": st.stack, "tile": kind,
               "x": "bf16" if x_b == 2 else "f32",
               "out": "bf16" if out_b == 2 else "f32", "nnz": nnz,
               "longest_list": per_rb, "mean_list": round(float(lists.mean()), 2)})


def resident_ablation(st, x, rec64):
    """D1's and D4's counterparts on B4's tensor-core phase (int8 tiles,
    D = 128): each diagnostic mode of ``_spmm_stacked_ablation`` (D1:
    ``bench_resident_diag2.py:105``); ``scratchacc`` (D4,
    ``bench_resident_diag3.py:63``), B4 with its f32 register accumulator
    rounded once to a bf16 output, against the f32 output; and ``smalln``,
    B4 on a 16,384-node power-law graph built as the full one (same average
    degree, block 256), held to its plain version, with its time per node
    against the 65,536-node time's."""
    import torch

    from tpugraph_torch.ops import bcsr
    from tpugraph_torch.ops import resident_kernels as rk
    from tpugraph_torch.train.loop import _RESIDENT_K_PACK

    outs = {m: rk._spmm_stacked_ablation(st, x, m) for m in rk.ABLATIONS}
    torch.cuda.synchronize()
    for m, y in outs.items():
        check(y.shape == (st.num_row_nodes, x.shape[1])
              and bool(torch.isfinite(y).all()), f"B4 ablation {m}: bad output")
    check(bool(torch.equal(outs["full"], rk.spmm_stacked_resident(st, x))),
          "B4 ablation full differs from B4")
    del outs
    rec = {"spmm_stacked_resident_ms": rec64["ms"],
           **{f"{m}_ms": time_ms(lambda m=m: rk._spmm_stacked_ablation(st, x, m))
              for m in rk.ABLATIONS}}
    rec["scratchacc"] = {
        "bf16_out_ms": time_ms(lambda: rk.spmm_stacked_resident(
            st, x, out_dtype=torch.bfloat16)),
        "f32_out_ms": rec64["ms"]}
    g, _, _ = powerlaw_task(SMALLN_NODES, LOWLOC_D)
    s, r, w = (t.numpy() for t in (g.senders, g.receivers, g.edge_weight))
    m = bcsr.bcsr_from_coo(s, r, w, g.num_nodes_padded, block=LOWLOC_BLOCK,
                           tile_dtype=torch.int8)
    st_s = rk.stack_bcsr(m, stack=1, k_pack=_RESIDENT_K_PACK).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    xs = torch.randn((st_s.num_nodes, x.shape[1]), generator=gen, device="cuda")
    small = measure_stacked(f"powerlaw-{SMALLN_NODES // 1024}k", st_s, xs)
    rec["smalln"] = {
        "nodes": SMALLN_NODES, "tiles": st_s.num_tiles, "time_ms": small["ms"],
        "per_node_ratio": (small["ms"] / SMALLN_NODES)
        / (rec64["ms"] / st.num_row_nodes)}
    print(f"  resident_ablation {json.dumps(rec)}", flush=True)
    return rec, small


def chain_us(step, k=PROBE_K, reps=5):
    """Microseconds a launch over ``k`` dependent launches of ``step``,
    timed with CUDA events around the whole chain (median of ``reps``)."""
    import torch

    step()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / k)
    times.sort()
    return times[len(times) // 2]


def phase_probes(gen):
    """D3's counterpart (``bench_palcall_diag.py``): chains of ``PROBE_K``
    dependent launches of ``probe_tiny`` at a grid of 1 and 2 CTAs and of
    ``probe_resident`` at each n of ``PROBE_NS``; the fit ``per_call(n) =
    intercept + slope * MB(n)`` over the bytes each call writes; and the
    host-clock cost of one wrapper call (ctypes), unsynchronized.  Each probe
    is first held to its plain version (exactly: the same f32 operations)."""
    import numpy as np
    import torch

    from tpugraph_torch import ops
    from tpugraph_torch.ops import probe_kernels as pk

    dev = torch.device("cuda")
    x8 = torch.randn((8, pk.D), generator=gen, device=dev)
    xs = {n: torch.randn((n, pk.D), generator=gen, device=dev).to(torch.bfloat16)
          for n in PROBE_NS}
    errs = {}
    for grid in pk.GRIDS:
        errs[f"tiny_g{grid}"] = float((pk.probe_tiny(x8, grid)
                                       - pk.probe_tiny_plain(x8)).abs().max())
    for n in PROBE_NS:
        errs[f"resident_{n}"] = float((pk.probe_resident(x8, xs[n])
                                       - pk.probe_resident_plain(x8, xs[n])).abs().max())
    check(max(errs.values()) == 0.0, f"a probe differs from its plain version: {errs}")

    ops.reset_launch_counts()
    tiny_us = {}
    for grid in pk.GRIDS:
        state = [x8]

        def step(grid=grid):
            state[0] = pk.probe_tiny(state[0], grid)
        tiny_us[grid] = chain_us(step)
    res_us = {}
    for n in PROBE_NS:
        tok = [x8]

        def step(n=n):
            tok[0] = pk.probe_resident(tok[0], xs[n])[:8]
        res_us[n] = chain_us(step)
    launches = ops.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        pk.probe_tiny(x8)
    host_us = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    mb = np.array([4 * pk.D * n / 1e6 for n in PROBE_NS])
    us = np.array([res_us[n] for n in PROBE_NS])
    (intercept, slope), *_ = np.linalg.lstsq(np.vstack([np.ones_like(mb), mb]).T, us,
                                             rcond=None)
    rec = {"tiny_us": {f"grid{g}": v for g, v in tiny_us.items()},
           "resident_us": {str(n): v for n, v in res_us.items()},
           "fit": {"intercept_us": float(intercept), "slope_us_per_MB": float(slope),
                   "implied_GB_per_s": 1e3 / float(slope) if slope > 0 else None,
                   "bytes_model": "4 * 128 * n bytes of f32 output written a call"},
           "host_us_per_wrapper_call": host_us, "k": PROBE_K, "max_abs_err": errs}
    print(f"  launch_probes {json.dumps(rec)}", flush=True)
    n_big = PROBE_NS[-1]
    kernels = {
        "probe_tiny": {
            "max_abs_err": errs["tiny_g1"], "ms": tiny_us[1] / 1e3,
            "plain_ms": time_ms(lambda: pk.probe_tiny_plain(x8)),
            "bound_ms": 2 * 8 * pk.D * 4 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": time_ms(lambda: torch.mul(x8, 0.999)),
            "shapes": [{"grid": g, "us_per_launch": v} for g, v in tiny_us.items()]},
        "probe_resident": {
            "max_abs_err": errs[f"resident_{n_big}"], "ms": res_us[n_big] / 1e3,
            "plain_ms": time_ms(lambda: pk.probe_resident_plain(x8, xs[n_big])),
            "bound_ms": (4 * pk.D * n_big + 4 * 8 * pk.D + 2 * 8 * pk.D)
            / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
            "library_null_reason": "no single PyTorch call zeroes a buffer and "
                                   "writes eight rows of it",
            "shapes": [{"n": n, "us_per_launch": v} for n, v in res_us.items()]},
    }
    return {"launches": launches, "record": rec, "kernels": kernels}


def measure_packets(shape, p, x, compute_dtype):
    """B7 against its plain version on one packet layout."""
    import torch

    from tpugraph_torch.ops import packets_kernels as pk

    d = x.shape[1]
    live = p.w != 0
    e = int(live.sum())
    rows_g = (p.row_of.long()[:, None] * p.block_r + p.rows.long())[live]
    per_row = int(torch.bincount(rows_g).max()) if e else 1
    hub = int(torch.bincount(rows_g // p.block_r).max()) / e if e else 0.0
    bf16 = compute_dtype == torch.bfloat16
    wl = pk.work_list(p)
    return measure_case(
        "spmm_packets", shape, d,
        lambda: pk.spmm_packets(p, x, compute_dtype=compute_dtype),
        lambda: pk.spmm_packets_plain(p, x, None, compute_dtype),
        lambda: library_packets(p, x),
        12 * p.num_edge_slots + 4 * (2 * p.num_packets + p.num_row_blocks + 1)
        + 4 * 2 * p.num_nodes * d,
        2.0 * e * d, BF16_FLOPS_PER_S if bf16 else F32_FLOPS_PER_S, per_row,
        extra={"packets": p.num_packets, "edges": e,
               "compute": "bf16" if bf16 else "f32",
               "heaviest_block_share": round(hub, 4),
               "chunks": int(wl.items.shape[0]),
               "split_blocks": int(wl.splits.shape[0]),
               "split_chunks": wl.num_parts})


def packets_ablation(p, x, full_ms):
    """D2's counterpart: B7 (bf16 compute, f32 output) timed in each of its
    diagnostic modes on one packet layout, beside B7's own time."""
    from tpugraph_torch.ops import packets_kernels as pk

    times = {m: time_ms(lambda m=m: pk._spmm_packets_ablation(p, x, m))
             for m in pk.ABLATIONS}
    rec = {"spmm_packets_ms": full_ms, **{f"{m}_ms": t for m, t in times.items()}}
    print(f"  packets_ablation {json.dumps(rec)}", flush=True)
    return rec


def phase_lowloc(report, gen):
    """Reduced card-vs-CPU check, then full-size training in every format
    with each format's kernel measured on its own packs."""
    import numpy as np
    import torch

    from tpugraph_torch import ops
    from tpugraph_torch.nn import GcnEncoderNode
    from tpugraph_torch.ops import bcsr, message, packets
    from tpugraph_torch.ops import packets_kernels as pk
    from tpugraph_torch.ops import resident_kernels as rk
    from tpugraph_torch.train import TrainConfig, train_node_classifier

    dims = dict(input_dim=LOWLOC_D, hidden_dim=128, embedding_dim=128,
                label_dim=4, num_layers=3)

    # ---- reduced copy: card against CPU, every format
    t0 = time.perf_counter()
    g, feat, labels = powerlaw_task(REDUCED_NODES, LOWLOC_D)
    init = GcnEncoderNode(**dims, generator=torch.Generator().manual_seed(1),
                          device="cpu").state_dict()
    for fmt, fields in FORMATS.items():
        cfg = TrainConfig(num_epochs=REDUCED_EPOCHS, bcsr_block=REDUCED_BLOCK,
                          packet_compute_dtype=torch.bfloat16, **fields)
        cpu = train_node_classifier(GcnEncoderNode(**dims, device="cpu"), g,
                                    feat, labels, cfg, init_params=init,
                                    device="cpu")
        gpu = train_node_classifier(GcnEncoderNode(**dims), g, feat, labels,
                                    cfg, init_params=init)
        diff = float(np.max(np.abs(np.subtract(cpu["history"]["loss"],
                                               gpu["history"]["loss"]))))
        # coo: atomic sums on the card reorder every aggregation, within
        # the same 1e-4 on the loss
        print(f"  reduced {fmt:8s} {REDUCED_NODES} nodes: card vs CPU "
              f"{REDUCED_EPOCHS}-epoch loss max |diff| {diff:.3g} (limit 1e-4)",
              flush=True)
        check(diff <= 1e-4, f"{fmt}: card and CPU losses differ by {diff}")
        if fmt == "resident":
            small_st = gpu["adj"].st
    # variants off the training path, on the reduced graph
    small = f"powerlaw-{REDUCED_NODES // 1024}k"
    s, r, w = (t.numpy() for t in (g.senders, g.receivers, g.edge_weight))
    x_small = torch.randn((small_st.num_nodes, LOWLOC_D), generator=gen,
                          device="cuda")
    m_bf = bcsr.bcsr_from_coo(s, r, w, g.num_nodes_padded, block=REDUCED_BLOCK,
                              tile_dtype=torch.bfloat16)
    m_i8 = bcsr.bcsr_from_coo(s, r, w, g.num_nodes_padded, block=REDUCED_BLOCK,
                              tile_dtype=torch.int8)
    variants = [
        measure_stacked(small, small_st, x_small),
        measure_stacked(small, rk.stack_bcsr(m_bf, stack=2).to("cuda"),
                        x_small, torch.bfloat16),
        measure_stacked(small, rk.pack_stacked_int4(
            rk.stack_bcsr(m_i8, stack=2)).to("cuda"), x_small, torch.bfloat16),
        measure_stacked(small, small_st, x_small.to(torch.bfloat16)),
    ]
    p_small = packets.pack_edges(s, r, w, g.num_nodes_padded).to("cuda")
    xp = torch.randn((p_small.num_nodes, LOWLOC_D), generator=gen,
                     device="cuda")
    variants.append(measure_packets(small, p_small, xp, torch.float32))
    del small_st, m_bf, m_i8, p_small
    print(f"  reduced phase {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- full size: 100 epochs in every format, kernels on their packs
    shape = f"powerlaw-{LOWLOC_NODES // 1024}k"
    t0 = time.perf_counter()
    g, feat, labels = powerlaw_task(LOWLOC_NODES, LOWLOC_D)
    n_live = int((g.edge_weight != 0).sum())
    print(f"  powerlaw graph: {LOWLOC_NODES} nodes, {n_live} directed edges, "
          f"made in {time.perf_counter() - t0:.1f} s", flush=True)
    check(n_live == LOWLOC_NODES * LOWLOC_DEG, f"{n_live} edges")
    init = GcnEncoderNode(**dims, generator=torch.Generator().manual_seed(0),
                          device="cpu").state_dict()
    x = torch.randn((LOWLOC_NODES, LOWLOC_D), generator=gen, device="cuda")
    runs, shapes, launches = {}, {}, {}
    for fmt, fields in FORMATS.items():
        ops.reset_launch_counts()
        out = train_node_classifier(
            GcnEncoderNode(**dims), g, feat, labels,
            TrainConfig(num_epochs=LOWLOC_EPOCHS, bcsr_block=LOWLOC_BLOCK,
                        **fields), init_params=init)
        launches[fmt] = ops.launch_counts()
        check(format_ran(launches[fmt]) == fmt,
              f"{fmt} trained in {format_ran(launches[fmt])}")
        hist = out["history"]["loss"]
        runs[fmt] = out
        adj = out["adj"]
        if fmt in ("tiles", "k_pack4"):
            size = (f"{adj.m.num_tiles} tiles ({adj.m.tiles.numel() * 4 / 1e9:.2f} GB)"
                    " a direction")
        elif fmt == "resident":
            size = (f"{adj.st.num_tiles} int8 tiles "
                    f"({adj.st.tiles.numel() / 1e9:.2f} GB) a direction")
        elif fmt == "packets":
            size = f"{adj.p.num_packets} packets of {adj.p.k} a direction"
        else:
            size = f"{adj.senders.numel()} padded COO edges"
        print(f"  full {fmt:8s} pack {out['pack_s']:.2f} s, {size}; "
              f"{LOWLOC_EPOCHS / out['elapsed']:.2f} epochs/s; loss "
              f"{hist[0]:.4f} -> {hist[-1]:.4f}; train acc "
              f"{out['result_train']['acc']:.4f} test acc "
              f"{out['result_test']['acc']:.4f}; launches "
              f"{ {k: v for k, v in launches[fmt].items() if v} } [{CARD}]",
              flush=True)
        check(bool(np.all(np.isfinite(hist))) and hist[-1] < hist[0],
              f"{fmt}: losses not finite or not decreasing")
        check(out["ypred"].shape == (1, LOWLOC_NODES, 4)
              and bool(np.all(np.isfinite(out["ypred"]))),
              f"{fmt}: bad predictions")
        if fmt == "coo":
            check(sum(launches[fmt].values()) == 0, "coo launched a kernel")
        else:
            check(launches[fmt][FORMAT_KERNEL[fmt]] > 0,
                  f"{fmt} did not launch {FORMAT_KERNEL[fmt]}")
        if fmt == "k_pack4":
            check(launches[fmt]["spmm_bcsr"] == 0, "k_pack4 launched spmm_bcsr")
        if fmt != "tiles":
            check(bool(np.allclose(hist, runs["tiles"]["history"]["loss"],
                                   rtol=2e-2, atol=2e-3)),
                  f"{fmt} loss trajectory leaves the tiles one")
        # this format's kernel on its own packs
        if fmt == "tiles":
            shapes[fmt] = measure_spmm(shape, adj.m, x)
        elif fmt == "k_pack4":
            shapes[fmt] = measure_packed(shape, adj.m, 4, x)
        elif fmt == "resident":
            shapes[fmt] = measure_stacked(shape, adj.st, x)
            rp = adj.st.row_ptr
            print(f"  B4 inverse index: longest list {shapes[fmt]['longest_list']} entries "
                  f"(row block {int((rp[1:] - rp[:-1]).argmax())}) against a mean of "
                  f"{shapes[fmt]['mean_list']}; a cluster of 4 CTAs shares each "
                  f"128-row slab's list", flush=True)
            ablation_res, smalln = resident_ablation(adj.st, x, shapes[fmt])
            pair_ms = time_ms(lambda: (rk.spmm_stacked_resident(adj.st, x),
                                       rk.spmm_stacked_resident(adj.st_t, x)))
            res_rates = {"res_edges_per_s": n_live / (pair_ms / 1e3),
                         "res_pack_s_per_tile": out["pack_s"] / adj.st.num_tiles}
        elif fmt == "packets":
            check(launches[fmt]["spmm_packets_reduce"] > 0,
                  "packets did not launch B7's reduce pass (no split block)")
            shapes[fmt] = measure_packets(shape, adj.p, x, torch.bfloat16)
            wl = pk.work_list(adj.p)
            print(f"  B7 work list: {wl.items.shape[0]} chunks of at most "
                  f"{pk.CHUNK_SLOTS // adj.p.k} packets over {adj.p.num_row_blocks} "
                  f"receiver blocks; {wl.splits.shape[0]} blocks split into "
                  f"{wl.num_parts} chunks (block 0: "
                  f"{int(adj.p.row_ptr[1] - adj.p.row_ptr[0])} packets)", flush=True)
            ablation = packets_ablation(adj.p, x, shapes[fmt]["ms"])
            pair_ms = time_ms(lambda: (pk.spmm_packets(adj.p, x),
                                       pk.spmm_packets(adj.p_t, x)))
            pkt_rates = {"pkt_edges_per_s": n_live / (pair_ms / 1e3),
                         "pkt_pack_s_per_edge": out["pack_s"] / n_live}
        else:  # coo: the forward and transposed gather + index_add_ pair
            pair_ms = time_ms(lambda: (
                message.spmm(adj.senders, adj.receivers, adj.weight, x),
                message.spmm(adj.receivers, adj.senders, adj.weight, x)))
            coo_rates = {"coo_edges_per_s": n_live / (pair_ms / 1e3),
                         "coo_pack_s_per_edge": out["pack_s"] / n_live}
        out.pop("adj")
        del adj
        torch.cuda.empty_cache()
    # the card's own rule on this graph: bcsr_format and bcsr_resident "auto"
    ops.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = train_node_classifier(
            GcnEncoderNode(**dims), g, feat, labels,
            TrainConfig(num_epochs=LOWLOC_EPOCHS, bcsr_block=LOWLOC_BLOCK,
                        **AUTO), init_params=init)
    launches["auto"] = ops.launch_counts()
    hist = out["history"]["loss"]
    picked = format_ran(launches["auto"])
    print(f"  full auto     -> {picked} {auto_line(buf.getvalue())}pack "
          f"{out['pack_s']:.2f} s; {LOWLOC_EPOCHS / out['elapsed']:.2f} epochs/s; "
          f"loss {hist[0]:.4f} -> {hist[-1]:.4f}; test acc "
          f"{out['result_test']['acc']:.4f}; launches "
          f"{ {k: v for k, v in launches['auto'].items() if v} } [{CARD}]",
          flush=True)
    check(picked in FORMAT_KERNEL and launches["auto"][FORMAT_KERNEL[picked]] > 0,
          f"auto trained in {picked} without its kernel")
    check(bool(np.allclose(hist, runs["tiles"]["history"]["loss"],
                           rtol=2e-2, atol=2e-3)),
          "auto's loss trajectory leaves the tiles one")
    del out
    torch.cuda.empty_cache()
    print(f"  H100 format-rule rates (fwd+bwd SpMM pair at D={LOWLOC_D}; pack "
          f"of A and A^T incl. upload, over A's tiles / edges): "
          f"{json.dumps({**res_rates, **pkt_rates, **coo_rates})} [{CARD}]",
          flush=True)
    print(f"  full-size phase {time.perf_counter() - t0:.1f} s", flush=True)
    report["lowloc"] = {"launches": launches, "shapes": shapes,
                        "tiles_epochs_per_s": LOWLOC_EPOCHS / runs["tiles"]["elapsed"],
                        "variants": variants + [smalln], "graph": g,
                        "packets_ablation": ablation,
                        "resident_ablation": ablation_res}


def dtype_cases(g):
    """The B1/B3 dtype options on the power-law graph at block 256, D = 128:
    B1 on int8 tiles with bf16 x, B3 (k_pack 4) on int8 tiles with f32 x,
    each at an f32 and a bf16 output; and B1 against B4 (stack 1, the
    resident format's layout) on the same int8 weights and bf16 x, timed in
    turns (B1, B4, B4, B1)."""
    import torch

    from tpugraph_torch.ops import bcsr
    from tpugraph_torch.ops import bcsr_kernels as bk
    from tpugraph_torch.ops import resident_kernels as rk
    from tpugraph_torch.train.loop import _RESIDENT_K_PACK

    s, r, w = (t.numpy() for t in (g.senders, g.receivers, g.edge_weight))
    n = g.num_nodes_padded
    shape = f"powerlaw-{n // 1024}k"
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((n, LOWLOC_D), generator=gen, device="cuda")
    out = {"spmm_bcsr": [], "spmm_bcsr_packed": []}
    m_host = bcsr.bcsr_from_coo(s, r, w, n, block=LOWLOC_BLOCK, tile_dtype=torch.int8)
    m = m_host.to("cuda")
    xb = x.to(torch.bfloat16)
    for od in (torch.float32, torch.bfloat16):
        out["spmm_bcsr"].append(measure_spmm(shape, m, xb, od))
    st = rk.stack_bcsr(m_host, stack=1, k_pack=_RESIDENT_K_PACK).to("cuda")
    del m_host
    b1 = lambda: bk.spmm_bcsr(m, xb)
    b4 = lambda: rk.spmm_stacked_resident(st, xb)
    turns = [time_ms(f) for f in (b1, b4, b4, b1)]
    out["b1_vs_b4"] = {"b1_ms": [turns[0], turns[3]], "b4_ms": [turns[1], turns[2]],
                       "b1_tiles": m.num_tiles, "b4_tiles": st.num_tiles}
    print(f"  B1 int8 vs B4 int8 (stack 1) on {shape}, bf16 x, D={LOWLOC_D}, in turns: "
          f"B1 {turns[0]:.4f} / {turns[3]:.4f} ms ({m.num_tiles} tiles), B4 "
          f"{turns[1]:.4f} / {turns[2]:.4f} ms ({st.num_tiles} tiles)", flush=True)
    del st
    m = bcsr.bcsr_from_coo(s, r, w, n, block=LOWLOC_BLOCK, tile_dtype=torch.int8,
                           pad_rows_to=4).to("cuda")
    for od in (torch.float32, torch.bfloat16):
        out["spmm_bcsr_packed"].append(measure_packed(shape, m, 4, x, od))
    del m
    torch.cuda.empty_cache()
    return out


def phase_explain_banded(gen):
    """``bench_explain.py:60-116``'s configuration on the card: tile-space
    mask optimization, 100 Adam epochs, on a 65,536-node banded graph
    (degree 32, band 192, block 256) with ``GcnEncoderNode(10, 20, 20, 4,
    3)`` (random weights, seed 0), in f32 and with bf16 kernel tiles; then
    B1 (bf16 tiles, f32 x) and B2 (bf16 support) at this shape, D = 20."""
    import dataclasses

    import numpy as np
    import torch

    from tpugraph_torch import ops
    from tpugraph_torch.explain import ExplainConfig
    from tpugraph_torch.explain.bcsr_explain import run_bcsr_mask_optimization
    from tpugraph_torch.nn import GcnEncoderNode
    from tpugraph_torch.ops import bcsr

    dev = torch.device("cuda")
    n = BANDED_NODES
    s, r, w = make_banded_graph(n, BANDED_DEG, BANDED_BAND)
    m_host = bcsr.bcsr_from_coo(s, r, w, n, block=BANDED_BLOCK)
    m = m_host.to(dev)
    tp = bcsr.bcsr_transpose_plan(m_host).to(dev)
    partner = torch.from_numpy(bcsr.bcsr_sym_partner(m_host)).long().to(dev)
    print(f"  banded graph: {n} nodes, {s.size} directed edges, "
          f"{m.num_tiles} tiles of {BANDED_BLOCK}^2", flush=True)
    model = GcnEncoderNode(input_dim=10, hidden_dim=20, embedding_dim=20,
                           label_dim=4, num_layers=3,
                           generator=torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (m.num_nodes, 10)).astype(np.float32)).to(dev)
    pred_vec = torch.zeros((m.num_nodes,), dtype=torch.int32, device=dev)

    def run(epochs, spmm_dtype):
        return run_bcsr_mask_optimization(
            model, m, tp, partner, x, node_idx=5, gt_label=1,
            pred_label_vec=pred_vec, num_sub_nodes=n,
            cfg=ExplainConfig(num_epochs=epochs),
            generator=torch.Generator(device=dev).manual_seed(1),
            spmm_dtype=spmm_dtype)

    rates, launches = {}, {}
    for tag, dt in (("f32", None), ("bf16", torch.bfloat16)):
        run(2, dt)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, w_tiles, hist = run(BANDED_EPOCHS, dt)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches[tag] = ops.launch_counts()
        rates[tag] = BANDED_EPOCHS / elapsed
        total = hist["total"]
        print(f"  banded explain {tag}: {rates[tag]:.2f} steps/s; loss "
              f"{total[0]:.5f} -> {total[-1]:.5f}; launches "
              f"{ {k: v for k, v in launches[tag].items() if v} }", flush=True)
        check(bool(np.all(np.isfinite(total))) and bool(torch.isfinite(w_tiles).all()),
              f"banded explain {tag}: non-finite loss or mask")
        check(launches[tag]["spmm_bcsr"] > 0 and launches[tag]["sddmm_bcsr"] > 0,
              f"banded explain {tag} did not launch B1 and B2")
        del w_tiles
    m16 = dataclasses.replace(m, tiles=m.tiles.to(torch.bfloat16))
    shapes = measure_kernels("banded-64k", m16, 20, gen)
    del m, m16, tp
    torch.cuda.empty_cache()
    return {"launches": launches, "steps_per_s": rates, "shapes": shapes}


# files every CLI call wrote and this smoke parsed (check_renders)
RENDERS = {"png": 0, "pdf": 0, "event_files": 0, "event_records": 0}


def check_renders(argv, summary, since):
    """Every file a CLI call wrote under its ``--logdir`` parses: a PNG's
    signature and IHDR (its CRC too), a PDF's header, xref and ``%%EOF``,
    an event file's records with both masked CRCs; every path its summary
    lists (``train_curve``, ``viz``) exists; a training call wrote an
    event file and a stats explain its precision-recall curve."""
    from tpugraph_torch.utils.tb_writer import read_records
    from tpugraph_torch.viz.writers import check_pdf, check_png

    logdir = argv[len(argv) - argv[::-1].index("--logdir")] if "--logdir" in argv else "log"
    new = {"png": [], "pdf": [], "events": []}
    for d, _, files in os.walk(logdir):
        for f in files:
            path = os.path.join(d, f)
            if os.path.getmtime(path) < since:
                continue
            if f.endswith(".png"):
                check_png(path)
                new["png"].append(path)
            elif f.endswith(".pdf"):
                check_pdf(path)
                new["pdf"].append(path)
            elif f.startswith("events.out.tfevents."):
                RENDERS["event_records"] += len(read_records(path))
                new["events"].append(path)
    RENDERS["png"] += len(new["png"])
    RENDERS["pdf"] += len(new["pdf"])
    RENDERS["event_files"] += len(new["events"])
    viz = summary.get("viz")
    listed = [summary.get("train_curve")] + (viz if isinstance(viz, list) else [viz])
    for path in listed:
        check(path is None or path == "" or os.path.isfile(path),
              f"the CLI listed {path}, which does not exist")
    if "train_curve" in summary:
        check(len(new["events"]) == 1, f"cli.train wrote {len(new['events'])} event files")
    if summary.get("auc") is not None:
        check(any(os.sep + "pr" + os.sep in p for p in new["png"]),
              "the stats explain drew no precision-recall curve")
    return new


def run_cli(main, argv):
    """One CLI entry point in this process, its printed output kept out of
    the smoke's, and every file it wrote checked (:func:`check_renders`);
    returns its summary, its wall seconds and its output."""
    buf = io.StringIO()
    since = time.time()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        summary = main(argv)
    wall = time.perf_counter() - t0
    check_renders(argv, summary, since)
    return summary, wall, buf.getvalue()


def _node_model_inputs(cfg, fmt):
    """(model on the CPU, padded graph, features, labels, class weight,
    TrainConfig) of ``cfg``'s node task, built by ``cli/tasks.py`` itself,
    the format pinned to the resident stacks when ``fmt`` is ``resident``
    (which auto takes on the card only)."""
    import dataclasses

    from tpugraph_torch.cli.tasks import node_task_data, node_task_model, train_config

    G, labels, cw = node_task_data(cfg)
    model, g, feat = node_task_model(cfg, G, labels, "cpu")
    tc = train_config(cfg)
    if fmt == "resident":
        tc = dataclasses.replace(tc, bcsr_resident="on")
    return model, g, feat, labels, cw, tc


def cpu_eval_acc(argv, fmt):
    """The test accuracy of the checkpoint ``cli.train argv`` wrote,
    evaluated on the CPU in the format the card trained in (COO, tiles or
    the resident stacks' plain twin), over the same test nodes; and the
    number of test nodes.  This figure is not chaotic: it reads the card's
    own weights."""
    import numpy as np
    import torch

    from tpugraph_torch.cli.config import parse_train_args
    from tpugraph_torch.train import gen_prefix, load_checkpoint
    from tpugraph_torch.train.loop import build_adjacency

    cfg = parse_train_args(argv)
    model, g, feat, labels, _, tc = _node_model_inputs(cfg, fmt)
    ck = load_checkpoint(cfg.ckptdir, gen_prefix(cfg.name, cfg.method, cfg.hidden_dim,
                                                 cfg.output_dim, cfg.bias,
                                                 cfg.name_suffix))
    with contextlib.redirect_stdout(io.StringIO()):
        sp, n_new = build_adjacency(g, tc, torch.device("cpu"),
                                    att=cfg.method == "att")
    x = np.zeros((n_new, feat.shape[1]), np.float32)
    x[: feat.shape[0]] = feat
    model.load_state_dict(ck["params"])
    model.eval()
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(x), sp)
    pred = torch.argmax(logits, dim=-1).numpy()[: g.n_node]
    test = np.setdiff1d(np.arange(g.n_node), ck["train_idx"])
    return float(np.mean(pred[test] == labels[test])), int(test.size)


def cpu_resident_losses(argv, epochs):
    """The first ``epochs`` losses of ``cli.train argv``'s node task on the
    CPU in the resident format (the stacks' plain twin: int8 tiles, bf16
    x), from the CLI's initial weights: the like-for-like run of a card
    run that ``auto`` sent to B4."""
    import dataclasses

    from tpugraph_torch.cli.config import parse_train_args
    from tpugraph_torch.train.loop import train_node_classifier

    cfg = parse_train_args(argv)
    model, g, feat, labels, cw, tc = _node_model_inputs(cfg, "resident")
    with contextlib.redirect_stdout(io.StringIO()):
        out = train_node_classifier(model, g, feat, labels,
                                    dataclasses.replace(tc, num_epochs=epochs),
                                    seed=cfg.seed, device="cpu", class_weight=cw)
    return out["history"]["loss"]


def cli_adjacency(argv):
    """The adjacency ``cli.train argv`` trains on, packed on the card as its
    trainer packs it (``cli/tasks.py``'s node task graph through
    ``build_adjacency``), and its padded node count."""
    import torch

    from tpugraph_torch.cli.config import parse_train_args
    from tpugraph_torch.cli.tasks import _edges_in_order, node_task_data, train_config
    from tpugraph_torch.core.graph import graph_from_edge_list
    from tpugraph_torch.train.loop import build_adjacency

    cfg = parse_train_args(argv)
    G, _, _ = node_task_data(cfg)
    g = graph_from_edge_list(G.number_of_nodes(), _edges_in_order(G))
    with contextlib.redirect_stdout(io.StringIO()):
        return build_adjacency(g, train_config(cfg), torch.device("cuda"),
                               att=cfg.method == "att")


def measure_cli_stacked(shape, argv, seed):
    """B4 at the shapes ``cli.train argv``'s resident path gives it: the
    CLI's own stacks of A (forward) and of A^T (backward) at D = 10 (layer
    1) and 20 (layers 2-3), x in bf16 as the wrapper rounds it for int8 and
    bf16 tiles."""
    import torch

    from tpugraph_torch.nn.layers import StackedAdj

    adj, n_pad = cli_adjacency(argv)
    check(isinstance(adj, StackedAdj),
          f"{shape}: the CLI packed {type(adj).__name__}, not B4's stacks")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    recs = []
    for d in (10, 20):
        x = torch.randn((n_pad, d), generator=gen, device="cuda").to(torch.bfloat16)
        recs += [measure_stacked(shape, adj.st, x),
                 measure_stacked(f"{shape}-T", adj.st_t, x)]
    del adj, x
    torch.cuda.empty_cache()
    return recs


def phase_coo(banded_tile_sps, keep):
    """The COO main path through the CLI on syn1 (the default, ``--bcsr``
    and ``--bcsr --bcsr-format packets``), then ``bench_explain.py:138-156``'s
    COO yardstick on the banded graph beside the tile-space rate.  The COO
    and ``--bcsr`` checkpoints are copied to ``keep/coo`` and ``keep/bcsr``
    for the baselines and mesh phases."""
    import numpy as np
    import torch

    from tpugraph_torch import ops
    from tpugraph_torch.cli import explain as cli_explain
    from tpugraph_torch.cli import train as cli_train
    from tpugraph_torch.cli.config import parse_explain_args
    from tpugraph_torch.core.graph import graph_from_edges
    from tpugraph_torch.explain import ExplainConfig, run_mask_optimization
    from tpugraph_torch.nn import GcnEncoderNode

    launches, figures, packet_shapes, stacked_shapes = {}, {}, [], []
    with tempfile.TemporaryDirectory() as tmp:
        for arm, flags in (("coo", []), ("bcsr", ["--bcsr"]),
                           ("packets", ["--bcsr", "--bcsr-format", "packets"])):
            dirs = ["--dataset", "syn1", "--ckptdir", os.path.join(tmp, arm, "ckpt"),
                    "--logdir", os.path.join(tmp, arm, "log")]
            ops.reset_launch_counts()
            summary, wall, text = run_cli(cli_train.main, dirs + flags)
            launches[f"cli_{arm}_train"] = ops.launch_counts()
            acc = summary["result_test"]["acc"]
            eps = EPOCHS / summary["elapsed_s"]
            figures[f"{arm}_train_epochs_per_s"] = eps
            fmt = format_ran(launches[f"cli_{arm}_train"])
            print(f"  cli.train {' '.join(flags) or '(COO)'}: ran {fmt}; test acc "
                  f"{acc:.4f}; {eps:.1f} epochs/s over {EPOCHS} epochs ({wall:.2f} s "
                  f"the call); launches "
                  f"{ {k: v for k, v in launches[f'cli_{arm}_train'].items() if v} } "
                  f"{auto_line(text)}[{CARD}]", flush=True)
            check(acc >= 0.85, f"cli.train {arm}: test acc {acc} < 0.85")
            if arm == "coo":
                check(fmt == "coo", "COO training launched a kernel")
            elif arm == "bcsr":
                # auto on the card: syn1 is low-locality (tile occupancy
                # 0.0090 at block 128), so the resident format (B4)
                check(fmt == "resident",
                      f"cli.train --bcsr ran {fmt}, not auto's resident")
                stacked_shapes += measure_cli_stacked("syn1-cli", dirs + flags, 3)
            else:
                check(launches["cli_packets_train"]["spmm_packets"] > 0,
                      "cli.train --bcsr-format packets did not launch B7")
                # B7 at the shapes this path gives it: the CLI's graph
                # packed as its trainer packs it, D = 10 (layer 1) and 20
                # (layers 2-3), A's packets (forward) and A^T's (backward)
                adj, n_pad = cli_adjacency(dirs + flags)
                check(adj.compute_dtype in (None, torch.bfloat16),
                      f"the CLI's packets compute at {adj.compute_dtype}")
                gen = torch.Generator(device="cuda").manual_seed(3)
                for d in (10, 20):
                    x = torch.randn((n_pad, d), generator=gen, device="cuda")
                    packet_shapes += [
                        measure_packets("syn1-cli", adj.p, x, torch.bfloat16),
                        measure_packets("syn1-cli-T", adj.p_t, x, torch.bfloat16)]
                del adj, x
                continue
            if arm == "coo":
                # the mask heatmaps: COO histories carry the masked weights
                summary, wall, _ = run_cli(cli_explain.main, dirs + [
                    "--explain-node", "305", "--log-mask-every", "25"])
                print(f"  cli.explain --explain-node 305 --log-mask-every 25: mask "
                      f"{summary['mask_shape']}, {summary['mask_heatmaps']} heatmaps, "
                      f"render {summary['viz']}; {wall:.2f} s the call [{CARD}]",
                      flush=True)
                check(summary["mask_heatmaps"] == 4 and summary["viz"].endswith(".pdf"),
                      f"COO --log-mask-every 25: {summary}")
            if arm == "bcsr":
                ops.reset_launch_counts()
                summary, wall, _ = run_cli(cli_explain.main, dirs + flags + [
                    "--explain-node", "305", "--log-mask-every", "100"])
                launches["cli_bcsr_explain_node"] = ops.launch_counts()
                shape = summary["mask_shape"]
                print(f"  cli.explain --bcsr --explain-node 305 --log-mask-every 100: "
                      f"mask {shape}; render {summary['viz']}; {wall:.2f} s the call; "
                      f"launches "
                      f"{ {k: v for k, v in launches['cli_bcsr_explain_node'].items() if v} } "
                      f"[{CARD}]", flush=True)
                check(len(shape) == 2 and shape[0] == shape[1] > 1,
                      f"bad tile-space mask shape {shape}")
                # tile-space histories hold no masked weights, so no heatmaps,
                # as in tpugraph
                check("mask_heatmaps" not in summary and summary["viz"].endswith(".pdf"),
                      f"--bcsr --log-mask-every 100: {summary}")
                for k in ("spmm_bcsr", "sddmm_bcsr"):
                    check(launches["cli_bcsr_explain_node"][k] > 0,
                          f"cli.explain --bcsr --explain-node did not launch {k}")
            ops.reset_launch_counts()
            summary, wall, _ = run_cli(cli_explain.main, dirs + flags)
            stats_launches = ops.launch_counts()
            auc = summary["auc"]
            check(summary["num_nodes_explained"] == EXPLAIN_STATS_NODES,
                  "the stats explain did not explain 60 nodes")
            check(auc is not None and auc > 0.9, f"cli.explain {arm}: AUC {auc}")
            check(sum(stats_launches.values()) == 0,
                  "the COO stats explain launched a kernel")
            # bench_explain.py:285-305: the batched explain of the 60 nodes,
            # best of 3 after a first run, on the CLI's explainer
            ex = cli_explain.build_explainer(parse_explain_args(dirs + flags))
            ex.print_training = False
            nodes = list(range(400, 700, 5))
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                ex.explain_nodes_batch(nodes)
                times.append(time.perf_counter() - t0)
            sps = EXPLAIN_STATS_NODES * 100 / min(times)
            figures[f"{arm}_explain_s"] = wall
            figures[f"{arm}_explain_steps_per_s"] = sps
            print(f"  cli.explain {' '.join(flags) or '(COO)'} stats: AUC {auc:.4f} "
                  f"over {EXPLAIN_STATS_NODES} nodes x 100 epochs; {wall:.2f} s the "
                  f"call; explain_nodes_batch best of 3 {min(times):.3f} s = "
                  f"{sps:.1f} mask-opt steps/s [{CARD}]", flush=True)
            del ex
            if arm in ("coo", "bcsr"):
                shutil.copytree(os.path.join(tmp, arm, "ckpt"),
                                os.path.join(keep, arm))

    # bench_explain.py:138-156: one query, every edge, 4 epochs on the banded
    # graph of phase 3, num_pairs = E_pad
    dev = torch.device("cuda")
    n = BANDED_NODES
    s, r, w = make_banded_graph(n, BANDED_DEG, BANDED_BAND)
    g = graph_from_edges(s, r, n, edge_weight=w).to(dev)
    model = GcnEncoderNode(input_dim=10, hidden_dim=20, embedding_dim=20,
                           label_dim=4, num_layers=3,
                           generator=torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (g.num_nodes_padded, 10)).astype(np.float32)).to(dev)
    pred_vec = torch.zeros((g.num_nodes_padded,), dtype=torch.int32, device=dev)

    def run(epochs):
        return run_mask_optimization(
            model, g, x, [5], [1], pred_vec, None, [n],
            ExplainConfig(num_epochs=epochs),
            generator=torch.Generator(device=dev).manual_seed(1))

    run(1)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, hist = run(4)
    torch.cuda.synchronize()
    coo_sps = 4 / (time.perf_counter() - t0)
    check(sum(ops.launch_counts().values()) == 0, "the COO explain launched a kernel")
    check(bool(np.all(np.isfinite(hist["total"])))
          and bool(torch.isfinite(state.edge_logits).all()),
          "banded COO explain: non-finite loss or mask")
    figures["banded_coo_steps_per_s"] = coo_sps
    print(f"  banded explain COO yardstick ({n} nodes, {s.size} edges, one query, "
          f"4 epochs): {coo_sps:.2f} steps/s against tile-space f32 "
          f"{banded_tile_sps:.2f} steps/s; loss {hist['total'][0, 0]:.5f} -> "
          f"{hist['total'][0, -1]:.5f} [{CARD}]", flush=True)
    del g, x, state
    torch.cuda.empty_cache()
    return {"launches": launches, "figures": figures,
            "shapes": {"spmm_packets": packet_shapes,
                       "spmm_stacked_resident": stacked_shapes}}


def _ordered_edges(adj):
    """Each undirected edge once, in ``nx.Graph.edges()`` order: by node,
    then by neighbour insertion, skipping neighbours already visited."""
    seen = set()
    for u, nbrs in adj.items():
        for v in nbrs:
            if v not in seen:
                yield u, v
        seen.add(u)


def write_tu_synthetic(root, name, n_graphs=1000, seed=0):
    """SYNBENCH, the catalog's reference-scale TU-format synthetic
    (``bench_catalog.py:54-101``) without networkx, byte for byte: class 0
    is a cycle with ``n // 6`` random chords, class 1 two stars joined at
    their centres, 12-80 nodes each, node labels the degree mod 3, graph
    labels 3 and 7 (remapped to 0 and 1 by the reader).  Returns the
    graph and node counts."""
    import numpy as np

    def add_edge(adj, u, v):
        adj.setdefault(u, {})[v] = None
        adj.setdefault(v, {})[u] = None

    rng = np.random.default_rng(seed)
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    indicator, node_labels, edges, graph_labels = [], [], [], []
    node_id = 1
    for gi in range(1, n_graphs + 1):
        n = int(rng.integers(12, 81))
        adj = {u: {} for u in range(n)}  # nodes in nx's order: 0..n-1
        if gi % 2 == 1:  # nx.cycle_graph(n), then the chords
            for u in range(n):
                add_edge(adj, u, (u + 1) % n)
            for _ in range(n // 6):
                u, v = rng.integers(0, n, 2)
                if u != v:
                    add_edge(adj, int(u), int(v))
            graph_labels.append(3)
        else:  # nx.disjoint_union(star_graph(k), star_graph(n - k - 2))
            k = n // 2
            for v in range(1, k + 1):
                add_edge(adj, 0, v)
            for v in range(k + 2, n):
                add_edge(adj, k + 1, v)
            add_edge(adj, 0, k + 1)
            graph_labels.append(7)
        for u in range(n):
            indicator.append(gi)
            node_labels.append(len(adj[u]) % 3)
        for u, v in _ordered_edges(adj):
            edges.append((node_id + u, node_id + v))
            edges.append((node_id + v, node_id + u))
        node_id += n
    prefix = os.path.join(d, name)
    with open(prefix + "_graph_indicator.txt", "w") as f:
        f.write("\n".join(map(str, indicator)) + "\n")
    with open(prefix + "_node_labels.txt", "w") as f:
        f.write("\n".join(map(str, node_labels)) + "\n")
    with open(prefix + "_A.txt", "w") as f:
        f.write("\n".join(f"{a}, {b}" for a, b in edges) + "\n")
    with open(prefix + "_graph_labels.txt", "w") as f:
        f.write("\n".join(map(str, graph_labels)) + "\n")
    return n_graphs, node_id - 1


# The syn phase's rows: (key, cli.train flags, node explained in tile space
# or None, the format it trains in on the card).  The format auto runs on
# the card at block 128: resident for syn3 (tile occupancy 0.0067); an
# attention model takes tiles with a transpose plan (B2 scores, B1 over the
# scaled tiles).  ``syn_cpu_figures.py`` runs the same rows on the CPU.
SYN_ROWS = (
    ("syn2", ["--dataset", "syn2"], None, "coo"),
    ("syn3", ["--dataset", "syn3"], None, "coo"),
    ("syn4", ["--dataset", "syn4"], None, "coo"),
    ("syn5", ["--dataset", "syn5"], None, "coo"),
    ("syn3_bcsr", ["--dataset", "syn3", "--bcsr"], 305, "resident"),
    ("att", ["--method", "att"], None, "coo"),
    ("att_bcsr", ["--method", "att", "--bcsr"], 305, "tiles_att"),
    ("bn", ["--bn"], None, "coo"),
)
# each row's test acc and stats-explain AUC in the port's own CPU run at
# seed 0 on one thread, written by ``syn_cpu_figures.py --write``
SYN_CPU_FILE = "syn_cpu_figures.json"
SYN_TOL = 0.02  # |card - CPU| of test acc and of AUC
# Each row's card test acc is also held to the CPU's evaluation of the
# checkpoint the card wrote (cpu_eval_acc), within one test node: the
# weights are the card's own, so only a prediction at a near-tie may flip.
# The file's figure is a sample of a chaotic run: its spread over 1, 2, 4
# and 8 CPU threads (syn_cpu_figures.py --spread) is printed beside it.
SYN_AUC_FLOOR = 0.9  # syn1 and syn2 rows (the repo's own limit, tests/test_explain.py)
SYN_TRAJ_EPOCHS, SYN_TRAJ_TOL = 20, 1e-4  # card vs CPU: the first epochs' losses


def deterministic_row(argv, traj):
    """``cli.train argv`` and then its stats ``cli.explain`` under
    ``torch.use_deterministic_algorithms``: index_add_ on the card then sums
    each row in edge order (a sort), not by atomics, so test acc and AUC
    repeat from run to run (with atomics syn5's AUC spread 0.45-0.54 over
    four runs of one tree).  The same stats explain then runs on the CPU
    from the checkpoint the card wrote: 1000 epochs of training turn a
    difference in the last bit into other weights (syn5's differ by 0.2
    between CPU runs on 1 and 2 threads), and near chance the AUC moves
    with them, so the card's explanation is held to the CPU's of the same
    model.  With ``traj`` (rows that train in the same format on both),
    the first SYN_TRAJ_EPOCHS epochs also run on the card (deterministically)
    and on the CPU.  Returns (acc, AUC, the CPU's AUC, the largest
    difference of the short runs' losses or None, the CPU's acc of the
    card's checkpoint and its test-node count)."""
    from tpugraph_torch import ops
    from tpugraph_torch.cli import explain as cli_explain
    from tpugraph_torch.cli import train as cli_train

    with deterministic_mode():
        ops.reset_launch_counts()
        train, _, _ = run_cli(cli_train.main, argv)
        fmt = format_ran(ops.launch_counts())
        explain, _, _ = run_cli(cli_explain.main, argv)
    cpu_acc, n_test = cpu_eval_acc(argv, fmt)
    cpu, _, _ = run_cli(cli_explain.main, argv + ["--platform", "cpu"])
    err = None
    if traj:
        short = argv + ["--ckptdir", argv[argv.index("--ckptdir") + 1] + "_short",
                        "--epochs", str(SYN_TRAJ_EPOCHS)]
        with deterministic_mode():
            card = task_run(short)
        err = max_diff(card["history"]["loss"],
                       task_run(short + ["--platform", "cpu"])["history"]["loss"])
    return train["result_test"]["acc"], explain["auc"], cpu["auc"], err, cpu_acc, n_test


@contextlib.contextmanager
def deterministic_mode():
    """``torch.use_deterministic_algorithms`` for the block, restored after."""
    import torch

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def phase_syn(gen, keep):
    """syn2-syn5 through the CLI (train, then the 60-node stats explain), on
    COO and for syn3 with ``--bcsr`` and a tile-space ``--explain-node``;
    syn1 with ``--method att`` on COO and ``--bcsr`` (launches under
    ``cli_att_bcsr``) and with ``--bn``.  Each row runs and is timed in the
    default mode, then runs again deterministically for the guard against
    the CPU.  Then B1 and B2 at the shapes the attention path gives them.
    The ``att`` row's checkpoint is copied to ``keep/att``."""
    import dataclasses
    import re

    import torch

    from tpugraph_torch import ops
    from tpugraph_torch.cli import explain as cli_explain
    from tpugraph_torch.cli import train as cli_train
    from tpugraph_torch.core.graph import graph_from_edge_list
    from tpugraph_torch.data import gen_syn1
    from tpugraph_torch.ops import bcsr
    from tpugraph_torch.ops import bcsr_kernels as bk

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           SYN_CPU_FILE)) as f:
        cpu = json.load(f)
    launches, figures, stacked = {}, {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for key, flags, node, want in SYN_ROWS:
            dirs = ["--ckptdir", os.path.join(tmp, key, "ckpt"),
                    "--logdir", os.path.join(tmp, key, "log")]
            ref_acc, ref_auc = cpu[key]["acc"], cpu[key]["auc"]
            dataset = (flags[flags.index("--dataset") + 1] if "--dataset" in flags
                       else "syn1")
            floor = SYN_AUC_FLOOR if dataset in ("syn1", "syn2") else None
            ops.reset_launch_counts()
            summary, wall, text = run_cli(cli_train.main, dirs + flags)
            path = "cli_att_bcsr" if key == "att_bcsr" else f"cli_{key}_train"
            launches[path] = ops.launch_counts()
            fmt = format_ran(launches[path])
            acc = summary["result_test"]["acc"]
            eps = EPOCHS / summary["elapsed_s"]
            print(f"  {key:9s} cli.train {' '.join(flags)}: ran {fmt}; test acc "
                  f"{acc:.4f}; {eps:.1f} epochs/s over {EPOCHS} epochs ({wall:.2f} "
                  f"s the call); launches "
                  f"{ {k: v for k, v in launches[path].items() if v} } "
                  f"{auto_line(text)}[{CARD}]", flush=True)
            check(fmt == want, f"{key}: trained in {fmt}, not {want}")
            if key == "att_bcsr":
                # a step: B2 scores and B1 forward in each of 3 layers; B2
                # dtiles in each, B1 dx on the transposed tiles in layers 2-3,
                # and B1 on the score gradient and its transpose in each: 11
                # B1 (5 on transposed tiles) and 6 B2; then one eval forward
                n1, n2 = launches[path]["spmm_bcsr"], launches[path]["sddmm_bcsr"]
                check(n1 == 11 * EPOCHS + 3 and n2 == 6 * EPOCHS + 3,
                      f"att --bcsr launched B1 {n1} and B2 {n2} times")
            if want == "resident":
                stacked += measure_cli_stacked(f"{dataset}-cli", dirs + flags, 4)
            figures[f"{key}_train_epochs_per_s"] = eps
            figures[f"{key}_test_acc"] = acc
            if node is not None:
                ops.reset_launch_counts()
                summary, wall, _ = run_cli(cli_explain.main, dirs + flags + [
                    "--explain-node", str(node)])
                npath = f"cli_{key}_explain_node"
                launches[npath] = ops.launch_counts()
                shape = summary["mask_shape"]
                print(f"  {key:9s} cli.explain --bcsr --explain-node {node}: mask "
                      f"{shape}; {wall:.2f} s the call; launches "
                      f"{ {k: v for k, v in launches[npath].items() if v} } "
                      f"[{CARD}]", flush=True)
                check(len(shape) == 2 and shape[0] == shape[1] > 1,
                      f"{key}: bad tile-space mask shape {shape}")
                for k in ("spmm_bcsr", "sddmm_bcsr"):
                    check(launches[npath][k] > 0,
                          f"{key}: the tile-space explain did not launch {k}")
            ops.reset_launch_counts()
            summary, wall, text = run_cli(cli_explain.main, dirs + flags)
            check(sum(ops.launch_counts().values()) == 0,
                  f"{key}: the COO stats explain launched a kernel")
            auc = summary["auc"]
            done = re.search(r"explained (\d+) nodes in ([0-9.]+)s \((\d+) epochs",
                             text)
            sps = int(done.group(1)) * int(done.group(3)) / float(done.group(2))
            print(f"  {key:9s} cli.explain stats: AUC {auc:.4f}"
                  f"{f' (guard > {floor})' if floor else ''} over "
                  f"{summary['num_nodes_explained']} nodes x 100 epochs; {sps:.1f} "
                  f"mask-opt steps/s; {wall:.2f} s the call [{CARD}]", flush=True)
            check(summary["num_nodes_explained"] == EXPLAIN_STATS_NODES,
                  f"{key}: the stats explain did not explain 60 nodes")
            if floor:
                check(auc > floor, f"{key}: AUC {auc} <= {floor}")
            figures[f"{key}_explain_steps_per_s"] = sps
            figures[f"{key}_auc"] = auc
            # the guard: the same row again, deterministically
            det_acc, det_auc, cpu_auc, traj, eval_acc, n_test = deterministic_row(
                ["--ckptdir", os.path.join(tmp, key, "det"),
                 "--logdir", os.path.join(tmp, key, "det_log")] + flags,
                traj=want == "coo")
            traj_text = ("" if traj is None else
                         f"; first {SYN_TRAJ_EPOCHS} epochs, card vs CPU loss max "
                         f"|diff| {traj:.3g} (tol {SYN_TRAJ_TOL})")
            threads = cpu[key].get("acc_threads", {})
            spread = (max(threads.values()) - min(threads.values())) if threads else None
            print(f"  {key:9s} deterministic re-run: test acc {det_acc:.4f} (CPU "
                  f"{ref_acc:.4f}; on 1/2/4/8 threads {list(threads.values())}, spread "
                  f"{spread}; the CPU's evaluation of this checkpoint {eval_acc:.4f}, "
                  f"tol 1/{n_test}), AUC {det_auc:.4f} (CPU from this checkpoint "
                  f"{cpu_auc:.4f}, from its own {ref_auc:.4f}); guard "
                  f"+-{SYN_TOL}{f', AUC > {floor}' if floor else ''}{traj_text}",
                  flush=True)
            check(abs(det_acc - ref_acc) <= SYN_TOL,
                  f"{key}: test acc {det_acc} is not within {SYN_TOL} of the "
                  f"CPU's {ref_acc}")
            check(abs(det_acc - eval_acc) <= 1.0 / n_test + 1e-9,
                  f"{key}: test acc {det_acc} is more than one test node from the "
                  f"CPU's evaluation of the same checkpoint, {eval_acc}")
            figures[f"{key}_det_cpu_eval_acc"] = eval_acc
            figures[f"{key}_cpu_acc_spread"] = spread
            check(abs(det_auc - cpu_auc) <= SYN_TOL,
                  f"{key}: AUC {det_auc} is not within {SYN_TOL} of the CPU's "
                  f"{cpu_auc} from the same checkpoint")
            check(traj is None or traj <= SYN_TRAJ_TOL,
                  f"{key}: card and CPU losses differ by {traj}")
            if floor:
                check(det_auc > floor, f"{key}: deterministic AUC {det_auc} <= {floor}")
            figures[f"{key}_det_test_acc"] = det_acc
            figures[f"{key}_det_auc"] = det_auc
            figures[f"{key}_det_cpu_auc"] = cpu_auc
            if key == "att":
                shutil.copytree(os.path.join(tmp, key, "ckpt"),
                                os.path.join(keep, "att"))

    # B1 and B2 at the shapes the attention path gives them: syn1's tiles
    # scaled by their scores (x_att of D = 10, then 20), B1 on them and on
    # their transpose, B2 on their support
    G, _, _ = gen_syn1(seed=0)
    g = graph_from_edge_list(G.number_of_nodes(), G.edges())
    m_h = bcsr.bcsr_from_coo(g.senders.numpy(), g.receivers.numpy(),
                             g.edge_weight.numpy(), g.num_nodes_padded)
    tp = bcsr.bcsr_transpose_plan(m_h).to("cuda")
    m = m_h.to("cuda")
    shapes = {"spmm_bcsr": [], "sddmm_bcsr": [], "spmm_stacked_resident": stacked}
    for d in (10, 20):
        x_att = torch.randn((m.num_nodes, d), generator=gen, device="cuda")
        eff = dataclasses.replace(m, tiles=m.tiles * bk.sddmm_bcsr(m, x_att, x_att))
        eff_t = bk._transposed(eff.tiles, tp)
        both = measure_kernels("syn1-att", eff, d, gen)
        shapes["spmm_bcsr"] += [both["spmm_bcsr"], measure_spmm(
            "syn1-att-T", eff_t, torch.randn((m.num_nodes, d), generator=gen,
                                             device="cuda"))]
        shapes["sddmm_bcsr"].append(both["sddmm_bcsr"])
    del m, tp, eff, eff_t
    torch.cuda.empty_cache()
    return {"launches": launches, "figures": figures, "shapes": shapes}


# The graph phase: SYNBENCH (bench_catalog.py:54-101) trained through
# cli.train at tpugraph/cli/config.py's default widths, (method, flags,
# epochs) a row
GRAPH_ROWS = (("base", [], 20), ("att", ["--method", "att"], 10),
              ("soft-assign", ["--method", "soft-assign", "--linkpred"], 10))
GRAPH_N, GRAPH_TRAIN = 1000, 800  # graphs, and the 80% split cli.train trains on
GRAPH_BASE_ACC = 0.9       # base's test accuracy floor
GRAPH_REDUCED, GRAPH_REDUCED_EPOCHS = 64, 5
GRAPH_TRAJ_TOL = 1e-4      # |card - CPU| of the reduced copy's per-epoch loss
GRAPH_EXPLAIN = (["--graph-mode"], ["--graph-idx", "0"], ["--multigraph-class", "0"])
GRAPH_BCSR = (1, 2, 3, 4)  # graphs explained in tile space at block 128


def last_epoch_scalars(text):
    """The metrics of the last ``epoch N: k: v; ...`` line a CLI printed."""
    line = [ln for ln in text.splitlines() if ln.startswith("epoch ")][-1]
    return {k: float(v) for k, v in
            (kv.split(": ") for kv in line.split(": ", 1)[1].split("; "))}


def graph_reduced_copy(tmp):
    """A 64-graph SYNBENCH trained 5 epochs through ``cli/tasks.py``'s
    ``benchmark_task`` on the card (deterministic algorithms) and on the
    CPU, from the one set of weights ``--seed`` draws.  Held: seeded N(0, 1)
    node attributes (``_node_attributes.txt``, ``feat="node-feat"``), whose
    per-epoch losses stay within GRAPH_TRAJ_TOL and accuracies within one
    graph.  Printed only: the CLI's own node-label features, where every
    leaf of a star is alike, gradients that cancel exactly come out as
    rounding noise, and Adam's first steps turn noise into lr-sized steps
    (5.5e-4 apart within 5 epochs on an H100 80GB HBM3 at 700 W)."""
    import numpy as np

    from tpugraph_torch.cli.config import parse_train_args
    from tpugraph_torch.cli.tasks import benchmark_task

    data = os.path.join(tmp, "reduced")
    _, n_nodes = write_tu_synthetic(data, "SYNB64", n_graphs=GRAPH_REDUCED, seed=0)
    attrs = np.random.default_rng(0).standard_normal((n_nodes, 4))
    with open(os.path.join(data, "SYNB64", "SYNB64_node_attributes.txt"), "w") as f:
        f.write("\n".join(", ".join(f"{v:.6f}" for v in row) for row in attrs) + "\n")
    out = {}
    for (method, flags, _), feat in itertools.product(
            (GRAPH_ROWS[0], GRAPH_ROWS[2]), ("node-feat", "node-label")):
        argv = ["--bmname", "SYNB64", "--datadir", data, "--max-nodes", "100",
                "--epochs", str(GRAPH_REDUCED_EPOCHS), "--eval-every", "1",
                "--ckptdir", os.path.join(tmp, "reduced_ckpt"),
                "--logdir", os.path.join(tmp, "reduced_log")] + flags
        with contextlib.redirect_stdout(io.StringIO()):
            cpu = benchmark_task(parse_train_args(argv + ["--platform", "cpu"]),
                                 feat=feat)
            with deterministic_mode():
                card = benchmark_task(parse_train_args(argv), feat=feat)
        err = max_diff(card["history"]["loss"], cpu["history"]["loss"])
        acc_err = max(max_diff(card["history"][k], cpu["history"][k])
                      for k in ("train_acc", "val_acc", "test_acc"))
        held = feat == "node-feat"
        print(f"  reduced copy {method}, {feat}: {GRAPH_REDUCED} graphs x "
              f"{GRAPH_REDUCED_EPOCHS} epochs, card vs CPU: loss max |diff| "
              f"{err:.3g} ({f'tol {GRAPH_TRAJ_TOL}' if held else 'not held'}), "
              f"accuracy max |diff| {acc_err:.3g}; loss "
              f"{card['history']['loss'][0]:.5f} -> "
              f"{card['history']['loss'][-1]:.5f}", flush=True)
        if held:
            check(err <= GRAPH_TRAJ_TOL,
                  f"reduced graph copy {method}: card and CPU losses differ by {err}")
            check(acc_err <= 1.0 / 6 + 1e-9,  # one graph of the 6-graph splits
                  f"reduced graph copy {method}: accuracies differ by {acc_err}")
        out[f"{method}_{feat}"] = {"loss_err": err, "acc_err": acc_err}
    return out


def phase_graph(gen, keep):
    """Graph classification and its explanation through the CLI on
    SYNBENCH: ``cli.train --bmname`` for base, att and soft-assign
    --linkpred (graphs/s; base's test acc >= 0.9, DiffPool's loss finite
    and its train acc > 0.5), the reduced copy against the CPU, the three
    graph-mode ``cli.explain`` calls on the base checkpoint (COO), then
    ``explain_graph_bcsr`` on four graphs at block 128 with B1 and B2 held
    to their plain versions at the shapes that path gives them.  The base
    checkpoint is copied to ``keep/graph``."""
    import dataclasses

    import numpy as np
    import torch

    from tpugraph_torch import ops
    from tpugraph_torch.cli import explain as cli_explain
    from tpugraph_torch.cli import train as cli_train
    from tpugraph_torch.cli.config import parse_explain_args
    from tpugraph_torch.ops import bcsr_kernels as bk

    launches, figures = {}, {}
    shapes = {"spmm_bcsr": [], "sddmm_bcsr": []}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        n_graphs, n_nodes = write_tu_synthetic(os.path.join(tmp, "data"),
                                               "SYNBENCH", n_graphs=GRAPH_N, seed=0)
        print(f"  SYNBENCH: {n_graphs} graphs, {n_nodes} nodes, written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        base = ["--bmname", "SYNBENCH", "--datadir", os.path.join(tmp, "data"),
                "--max-nodes", "100", "--ckptdir", os.path.join(tmp, "ckpt"),
                "--logdir", os.path.join(tmp, "log")]
        for method, flags, epochs in GRAPH_ROWS:
            ops.reset_launch_counts()
            summary, wall, text = run_cli(cli_train.main,
                                          base + flags + ["--epochs", str(epochs)])
            check(sum(ops.launch_counts().values()) == 0,
                  f"graph training {method} launched a tile kernel")
            last = last_epoch_scalars(text)
            acc = summary["test_result"]["acc"]
            gps = epochs * GRAPH_TRAIN / summary["elapsed_s"]
            figures[f"{method}_graphs_per_s"] = gps
            figures[f"{method}_test_acc"] = acc
            print(f"  cli.train --bmname SYNBENCH {' '.join(flags) or '(base)'}: "
                  f"{epochs} epochs, {gps:.1f} graphs/s ({summary['elapsed_s']} s "
                  f"the loop, {wall:.2f} s the call); last epoch {last}; best val "
                  f"{summary['best_val']['acc']:.4f}, test acc {acc:.4f} "
                  f"[{CARD}]", flush=True)
            if method == "base":
                check(acc >= GRAPH_BASE_ACC,
                      f"graph base: test acc {acc} < {GRAPH_BASE_ACC}")
            if method == "soft-assign":
                check(math.isfinite(last["loss"]) and last["train_acc"] > 0.5,
                      f"DiffPool: loss {last['loss']}, train acc {last['train_acc']}")
        figures["reduced"] = graph_reduced_copy(tmp)
        shutil.copytree(os.path.join(tmp, "ckpt"), os.path.join(keep, "graph"))

        logdir = os.path.join(tmp, "log", "SYNBENCH_base_h20_o20_explain")
        for flags in GRAPH_EXPLAIN:
            ops.reset_launch_counts()
            summary, wall, text = run_cli(cli_explain.main, base + flags)
            check(sum(ops.launch_counts().values()) == 0,
                  f"the COO graph explain {flags} launched a kernel")
            idxs = summary.get("graph_indices", [summary.get("graph_idx")])
            for gi in idxs:
                mask = np.load(os.path.join(
                    logdir, f"masked_adj_node_idx_0graph_idx_{gi}.npy"))
                check(mask.ndim == 2 and mask.shape[0] == mask.shape[1]
                      and bool(np.all(np.isfinite(mask))) and bool(np.any(mask != 0)),
                      f"cli.explain {flags}: bad mask of graph {gi}")
            figures[f"explain{flags[0]}_graphs_per_s"] = len(idxs) / wall
            print(f"  cli.explain {' '.join(flags)}: {len(idxs)} graphs, masks "
                  f"{mask.shape}; {wall:.2f} s the call "
                  f"({len(idxs) / wall:.2f} graphs/s) [{CARD}]", flush=True)

        ex = cli_explain.build_explainer(parse_explain_args(base + ["--graph-mode"]))
        ex.print_training = False
        ex.explain_graph_bcsr(GRAPH_BCSR[0], block=128)  # warm-up: pack, build
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = [ex.explain_graph_bcsr(gi, block=128) for gi in GRAPH_BCSR]
        torch.cuda.synchronize()
        per_graph = (time.perf_counter() - t0) / len(GRAPH_BCSR)
        launches["graph_explain_bcsr"] = ops.launch_counts()
        counts = launches["graph_explain_bcsr"]
        for res in results:
            ma = res["masked_adj"]
            check(ma.shape == (len(res["neighbors"]),) * 2
                  and bool(np.all(np.isfinite(ma))) and bool(np.any(ma != 0)),
                  f"explain_graph_bcsr: bad mask of graph {res['graph_idx']}")
        for k in ("spmm_bcsr", "sddmm_bcsr"):
            check(counts[k] > 0, f"explain_graph_bcsr did not launch {k}")
        figures["bcsr_s_per_graph"] = per_graph
        print(f"  explain_graph_bcsr graphs {list(GRAPH_BCSR)} at block 128: "
              f"{per_graph:.3f} s a graph ({ex.cfg.num_epochs} mask epochs); "
              f"launches { {k: v for k, v in counts.items() if v} } [{CARD}]",
              flush=True)

        # B1 and B2 at this path's shapes: a graph's tiles under a mask
        # gate, x of the layer widths (the node-label features, then 20),
        # B1 on them and on their transpose (dx), B2 on their support
        _, _, m, tp, _, _, _ = ex._bcsr_pack(GRAPH_BCSR[0], 128)
        eff = dataclasses.replace(m, tiles=m.tiles * torch.rand(
            m.tiles.shape, generator=gen, device="cuda"))
        eff_t = bk._transposed(eff.tiles, tp)
        for d in (ex.feat.shape[-1], 20):
            both = measure_kernels("graph-b128", eff, d, gen)
            shapes["spmm_bcsr"] += [both["spmm_bcsr"], measure_spmm(
                "graph-b128-T", eff_t, torch.randn((m.num_nodes, d), generator=gen,
                                                   device="cuda"))]
            shapes["sddmm_bcsr"].append(both["sddmm_bcsr"])
        del ex, m, tp, eff, eff_t
    torch.cuda.empty_cache()
    return {"launches": launches, "figures": figures, "shapes": shapes}


# The opt phase: syn1 through cli.train with each optimizer chain, (key,
# flags) a row; sgd_bcsr trains on --bcsr, which auto sends to B4 on the card
OPT_ROWS = (("sgd", ["--opt", "sgd"]), ("rmsprop", ["--opt", "rmsprop"]),
            ("adagrad_step", ["--opt", "adagrad", "--opt-scheduler", "step"]),
            ("adam_cos", ["--opt-scheduler", "cos"]),
            ("sgd_bcsr", ["--opt", "sgd", "--bcsr"]))
OPT_TRAJ_EPOCHS, OPT_TRAJ_TOL = 20, 1e-4  # card vs CPU: the first epochs' losses
# sgd_bcsr like for like: the card's resident run (B4, int8 tiles, bf16 x)
# against the CPU's run of the stacks' plain twin, the same roundings on
# both sides; the bound is a tenth of OPT_TRAJ_TOL (PERF.md section 6 gives
# the measured gap)
OPT_RESIDENT_TOL = 1e-5
RESUME_FLAGS = ["--opt-scheduler", "step", "--opt-decay-step", "250"]
RESUME_SPLIT, RESUME_TOL = 500, 1e-6  # 500 + 500 resumed against 1000 straight


def task_run(argv):
    """``cli/tasks.py``'s ``run_task`` on ``argv`` (what ``cli.train.main``
    runs), its printing kept out of the smoke's; returns its output,
    per-epoch history included."""
    from tpugraph_torch.cli.config import parse_train_args
    from tpugraph_torch.cli.tasks import run_task

    with contextlib.redirect_stdout(io.StringIO()):
        return run_task(parse_train_args(argv))


def max_diff(a, b):
    import numpy as np

    return float(np.max(np.abs(np.subtract(a, b))))


def phase_opt(keep):
    """syn1 through ``cli.train`` with each optimizer chain of OPT_ROWS
    (1000 epochs each; epochs/s, test acc, the last loss), each row's first
    20 epochs held to the port's CPU run of the same flags
    (deterministically); then ``--resume`` on COO and on ``--bcsr``: 500
    epochs of Adam with a step decay every 250, 500 more resumed, held to
    1000 straight within RESUME_TOL.  Checkpoints go under ``keep/opt``."""
    import torch

    from tpugraph_torch import ops
    from tpugraph_torch.cli import train as cli_train

    launches, figures = {}, {}
    tmp = os.path.join(keep, "opt")
    for key, flags in OPT_ROWS:
        dirs = ["--ckptdir", os.path.join(tmp, key, "ckpt"),
                "--logdir", os.path.join(tmp, key, "log")]
        ops.reset_launch_counts()
        summary, wall, text = run_cli(cli_train.main, dirs + flags)
        path = f"cli_opt_{key}_train"
        launches[path] = ops.launch_counts()
        fmt = format_ran(launches[path])
        acc = summary["result_test"]["acc"]
        eps = EPOCHS / summary["elapsed_s"]
        last = last_epoch_scalars(text)["loss"]
        print(f"  {key:12s} cli.train {' '.join(flags)}: ran {fmt}; test acc "
              f"{acc:.4f}; last loss {last:.4f}; {eps:.1f} epochs/s over {EPOCHS} "
              f"epochs ({wall:.2f} s the call); launches "
              f"{ {k: v for k, v in launches[path].items() if v} } [{CARD}]",
              flush=True)
        want = "resident" if "--bcsr" in flags else "coo"
        check(fmt == want, f"opt {key}: trained in {fmt}, not {want}")
        check(math.isfinite(last), f"opt {key}: last loss {last}")
        short = ["--ckptdir", os.path.join(tmp, key, "short"),
                 "--epochs", str(OPT_TRAJ_EPOCHS)] + flags
        with deterministic_mode():
            card = task_run(short)
        cpu = task_run(short + ["--platform", "cpu"])
        err = max_diff(card["history"]["loss"], cpu["history"]["loss"])
        print(f"  {key:12s} first {OPT_TRAJ_EPOCHS} epochs, card vs CPU loss max "
              f"|diff| {err:.3g} (tol {OPT_TRAJ_TOL})", flush=True)
        check(err <= OPT_TRAJ_TOL,
              f"opt {key}: card and CPU losses differ by {err}")
        like = None
        if fmt == "resident":
            like = max_diff(card["history"]["loss"],
                            cpu_resident_losses(short, OPT_TRAJ_EPOCHS))
            print(f"  {key:12s} like for like, card B4 vs the CPU's resident twin: "
                  f"loss max |diff| {like:.3g} (tol {OPT_RESIDENT_TOL})", flush=True)
            check(like <= OPT_RESIDENT_TOL,
                  f"opt {key}: card and CPU resident losses differ by {like}")
        eval_acc, n_test = cpu_eval_acc(dirs + flags, fmt)
        print(f"  {key:12s} test acc {acc:.4f}, the CPU's evaluation of the card's "
              f"checkpoint {eval_acc:.4f} (tol 1/{n_test})", flush=True)
        check(abs(acc - eval_acc) <= 1.0 / n_test + 1e-9,
              f"opt {key}: test acc {acc} is more than one test node from the CPU's "
              f"evaluation of the same checkpoint, {eval_acc}")
        figures[key] = {"epochs_per_s": eps, "test_acc": acc, "last_loss": last,
                        "traj_err": err, "resident_traj_err": like,
                        "cpu_eval_acc": eval_acc}

    for arm, extra in (("coo", []), ("bcsr", ["--bcsr"])):
        res = ["--ckptdir", os.path.join(tmp, f"resume_{arm}")] + RESUME_FLAGS + extra
        straight = ["--ckptdir", os.path.join(tmp, f"straight_{arm}"),
                    "--epochs", str(2 * RESUME_SPLIT)] + RESUME_FLAGS + extra
        ops.reset_launch_counts()
        with deterministic_mode():
            first = task_run(res + ["--epochs", str(RESUME_SPLIT)])
            resumed = task_run(res + ["--epochs", str(RESUME_SPLIT), "--resume"])
        launches[f"cli_resume_{arm}"] = ops.launch_counts()
        with deterministic_mode():
            whole = task_run(straight)
        err = max_diff(resumed["history"]["loss"],
                       whole["history"]["loss"][RESUME_SPLIT:])
        count = torch.load(os.path.join(resumed["ckpt_path"], "opt_state.pt"),
                           weights_only=True)["count"]
        fmt = format_ran(launches[f"cli_resume_{arm}"])
        print(f"  --resume {arm}: {RESUME_SPLIT} + {RESUME_SPLIT} resumed epochs "
              f"({fmt}) vs {2 * RESUME_SPLIT} straight: loss max |diff| {err:.3g} "
              f"(tol {RESUME_TOL}); update count {count}; loss "
              f"{first['history']['loss'][0]:.5f} -> "
              f"{resumed['history']['loss'][-1]:.5f} [{CARD}]", flush=True)
        check(err <= RESUME_TOL, f"--resume {arm}: losses differ by {err}")
        check(count == 2 * RESUME_SPLIT, f"--resume {arm}: update count {count}")
        check(fmt == ("resident" if extra else "coo"),
              f"--resume {arm} trained in {fmt}")
        figures[f"resume_{arm}"] = err
    return {"launches": launches, "figures": figures}


BASELINE_NODES = list(range(400, 700, 5))  # the stats explain's
BASELINE_TOL = 1e-5   # |card - CPU| of every baseline mask entry
# |card - CPU| of P over ALIGN_STEPS (the conditioned horizon) from every
# ALIGN_EVERY-th step of the card's run
ALIGN_TOL, ALIGN_STEPS, ALIGN_EVERY = 1e-4, 10, 100


def phase_baselines(keep):
    """The grad and att baselines through ``cli.explain --explainer-model``
    (the stats over nodes 400:700:5) on the coo phase's syn1 checkpoint and
    the syn phase's ``--method att`` one, each mask held to the port's CPU
    masks from the same checkpoint; ``--explain-node 305 --explainer-model
    grad``; ``--multinode-class 0`` (aligned, ``aligned_adj.npy``) with the
    alignment on the card and on the CPU from its own inputs; and the grad
    baseline of SYNBENCH graph 1 in graph mode, card against CPU.  None
    launches a hand-written kernel: the baselines run the model's dense
    path."""
    import numpy as np
    import torch

    from tpugraph_torch import ops
    from tpugraph_torch.cli import explain as cli_explain
    from tpugraph_torch.cli.config import parse_explain_args
    from tpugraph_torch.data.pipeline import to_numpy_array
    from tpugraph_torch.explain.align import Alignment, align_explanations
    from tpugraph_torch.viz import denoise_graph

    launches, figures = {}, {}
    log = os.path.join(keep, "baselines_log")
    rows = (("grad", ["--ckptdir", os.path.join(keep, "coo")]),
            ("att", ["--method", "att", "--ckptdir", os.path.join(keep, "att")]))
    for model, dirs in rows:
        argv = dirs + ["--logdir", log, "--explainer-model", model]
        ops.reset_launch_counts()
        summary, wall, _ = run_cli(cli_explain.main, argv)
        launches[f"cli_{model}_stats"] = ops.launch_counts()
        check(sum(launches[f"cli_{model}_stats"].values()) == 0,
              f"the {model} baseline launched a kernel")
        check(summary["num_nodes_explained"] == EXPLAIN_STATS_NODES,
              f"{model}: the stats explain did not explain 60 nodes")
        out = {}
        for dev, plat in (("card", []), ("cpu", ["--platform", "cpu"])):
            ex = cli_explain.build_explainer(parse_explain_args(argv + plat))
            ex.logdir = None
            t0 = time.perf_counter()
            out[dev] = ex.explain_nodes_gnn_stats(BASELINE_NODES, model=model)
            out[dev]["s"] = time.perf_counter() - t0
        err = max(max_diff(a, b) for a, b in zip(out["card"]["masked_adjs"],
                                                 out["cpu"]["masked_adjs"]))
        print(f"  cli.explain --explainer-model {model}: AUC {summary['auc']:.4f} "
              f"(CPU {out['cpu']['auc']:.4f}) over {EXPLAIN_STATS_NODES} nodes; "
              f"{wall:.3f} s the call, the batched baseline {out['card']['s']:.3f} "
              f"s (CPU {out['cpu']['s']:.3f} s); card vs CPU mask max |diff| "
              f"{err:.3g} (tol {BASELINE_TOL}) [{CARD}]", flush=True)
        check(err <= BASELINE_TOL, f"{model} baseline: card and CPU masks differ "
              f"by {err}")
        check(summary["auc"] is not None, f"{model} baseline: no AUC")
        figures[model] = {"auc": summary["auc"], "cpu_auc": out["cpu"]["auc"],
                          "call_s": wall, "batch_s": out["card"]["s"],
                          "mask_err": err}

    grad = rows[0][1] + ["--logdir", log]
    summary, wall, _ = run_cli(cli_explain.main, grad + [
        "--explain-node", "305", "--explainer-model", "grad"])
    shape = summary["mask_shape"]
    print(f"  cli.explain --explain-node 305 --explainer-model grad: mask {shape}; "
          f"{wall:.3f} s the call [{CARD}]", flush=True)
    check(len(shape) == 2 and shape[0] == shape[1] > 1,
          f"grad --explain-node 305: bad mask shape {shape}")

    summary, wall, _ = run_cli(cli_explain.main, grad + ["--multinode-class", "0"])
    logdir = os.path.join(log, "syn1_base_h20_o20_explain")
    aligned_file = os.path.join(logdir, "aligned_adj.npy")
    check(summary["aligned"] is True and os.path.isfile(aligned_file),
          f"--multinode-class 0 did not align: {summary}")
    # the alignment's own inputs, rebuilt from the two saved masks
    ex = cli_explain.build_explainer(parse_explain_args(grad))
    nodes = [i for i, lab in enumerate(ex.label[0]) if lab == 0][:2]
    ins = []
    for node in nodes:
        node_new, _, _, _, nbrs = ex.extract_neighborhood(node)
        G = denoise_graph(np.load(os.path.join(
            logdir, f"masked_adj_node_idx_{node}graph_idx_0.npy")), node_new,
            feat=ex.feat[0][nbrs], threshold=0.1)
        ins.append((np.array([G.feat[u] for u in G.nodes()]), to_numpy_array(G),
                    G.nodes().index(node_new)))
    (rf, ra, rc), (cf, ca, cc) = ins

    def align(dev):
        return Alignment(rf, ra, rc, cf, ca, cc, device=dev)

    def align_full(dev):
        return align_explanations(rf, ra, rc, cf, ca, cc,
                                  num_steps=ex.align_steps, device=dev)

    full = align_full("cuda")  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = align_full("cuda")
    align_s = time.perf_counter() - t0
    err_file = max_diff(full[1], np.load(aligned_file))
    # The 1000-step P is chaotic: Adam's normalized steps turn sign flips of
    # rounding-sized gradients into lr-sized moves, so two correct float32
    # runs (card and CPU, or two CPU runs whose inputs differ by one ulp)
    # end 1e-2 apart or more.  The card's run is held a segment at a time
    # instead: from its state at every ALIGN_EVERY-th step the CPU takes
    # ALIGN_STEPS steps, which must land within ALIGN_TOL of the card's.
    card, seg_err, n = align("cuda"), 0.0, ex.align_steps
    for k in range(0, n, ALIGN_EVERY):
        start, steps = card.state(), min(ALIGN_STEPS, n - k)
        card.step(steps)
        cpu = align("cpu")
        cpu.load(start)
        cpu.step(steps)
        seg_err = max(seg_err, max_diff(card.result()[0], cpu.result()[0]))
        card.step(min(ALIGN_EVERY, n - k) - steps)
    err_run = max_diff(card.result()[0], full[0])
    err_full = max_diff(full[0], align_full("cpu")[0])
    print(f"  cli.explain --multinode-class 0: nodes {summary['num_nodes_explained']}"
          f", aligned {summary['aligned']} ({ra.shape[0]} x {ca.shape[0]} nodes); "
          f"{wall:.3f} s the call; align_explanations {ex.align_steps} steps "
          f"{align_s:.3f} s on the card; P card vs CPU max |diff| {seg_err:.3g} "
          f"over {ALIGN_STEPS} steps from the card's state at every "
          f"{ALIGN_EVERY}th step (tol {ALIGN_TOL}); the segmented card run vs "
          f"align_explanations {err_run:.3g}; {err_full:.3g} after "
          f"{ex.align_steps} straight (chaotic, not held); aligned_adj.npy vs "
          f"the card's re-run {err_file:.3g} [{CARD}]", flush=True)
    check(seg_err <= ALIGN_TOL, f"align: card and CPU P differ by {seg_err} "
          f"within a {ALIGN_STEPS}-step segment")
    check(err_run <= 1e-5, f"align: the segmented card run is not "
          f"align_explanations' ({err_run})")
    check(err_file <= 1e-5, f"align: aligned_adj.npy is not the card's alignment "
          f"of its inputs ({err_file})")

    graph = ["--bmname", "SYNBENCH", "--ckptdir", os.path.join(keep, "graph"),
             "--logdir", log, "--graph-idx", "1"]
    sal = [cli_explain.build_explainer(parse_explain_args(graph + plat)).explain(
        0, graph_idx=1, graph_mode=True, model="grad")
        for plat in ([], ["--platform", "cpu"])]
    err = max_diff(*sal)
    print(f"  grad baseline, graph mode, SYNBENCH graph 1: mask {sal[0].shape}, "
          f"card vs CPU max |diff| {err:.3g} (tol {BASELINE_TOL})", flush=True)
    check(sal[0].shape[0] == sal[0].shape[1] and bool(np.any(sal[0] != 0)),
          "graph-mode grad baseline: bad mask")
    check(err <= BASELINE_TOL, f"graph-mode grad: card and CPU differ by {err}")
    figures["graph_grad_err"] = err
    return {"launches": launches, "figures": figures}


# The tasks phase: ROADMAP item 9's tasks on fixtures written here without
# networkx (tests/test_torch_tasks.py writes the same kinds with it), at
# the real datasets' shapes where the repo states them: Enron's 10 slices
# of 146 nodes (tpugraph/train/multigraph.py's reshape(10, 146, 6)).
TASK_ROWS = (
    ("pkl", ["--pkl", "bundle.pkl", "--epochs", "20"]),
    ("ppi", ["--dataset", "ppi_essential", "--epochs", "200"]),
    ("ppi_bcsr", ["--dataset", "ppi_essential", "--bcsr", "--epochs", "200"]),
    ("enron", ["--dataset", "enron", "--epochs", "200"]),
    ("enron_multigraph", ["--dataset", "enron_multigraph", "--epochs", "200"]),
)
TASK_TRAJ_EPOCHS, TASK_TRAJ_TOL = 20, 1e-4  # card vs CPU: the first epochs' losses
PPI_GENES, ENRON_NODES, PKL_GRAPHS = 2000, 146, 200


class _NxGraphStandIn:
    """Pickles as ``networkx.classes.graph.Graph`` does: its ``__dict__``
    (``graph``, ``_node``, ``_adj``) as the state of a new object."""


def write_nx_pickle(path, obj):
    """Pickle ``obj``, whose graphs are :class:`_NxGraphStandIn`, as
    networkx would: the class is named ``networkx.classes.graph.Graph``
    through stand-in modules present only while it is written."""
    import pickle
    import types

    names = ("networkx", "networkx.classes", "networkx.classes.graph")
    saved = {n: sys.modules.get(n) for n in names}
    mod = types.ModuleType("networkx.classes.graph")
    mod.Graph = _NxGraphStandIn
    _NxGraphStandIn.__module__, _NxGraphStandIn.__qualname__ = mod.__name__, "Graph"
    try:
        for n in names:
            sys.modules[n] = mod
        with open(path, "wb") as f:
            pickle.dump(obj, f, protocol=4)
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m
        _NxGraphStandIn.__module__, _NxGraphStandIn.__qualname__ = __name__, "_NxGraphStandIn"


def _nx_graph(edges, n, node_attrs=None):
    """A stand-in ``nx.Graph`` on nodes 0..n-1 with ``edges`` added in
    order, as ``add_edge`` builds its dicts."""
    g = _NxGraphStandIn()
    node = {u: dict((node_attrs or {}).get(u, {})) for u in range(n)}
    adj = {u: {} for u in range(n)}
    for u, v in edges:
        d = adj[u].get(v, {})
        adj[u][v] = adj[v][u] = d
    g.__dict__.update(graph={}, _node=node, _adj=adj)
    return g


def write_task_fixtures(root, seed=0):
    """Item 9's inputs under ``root``: a BioSnap PPI set of PPI_GENES genes
    (``ppi_essential/``: a random graph of mean degree 8 and a few small
    components, 30% essential, 12 motif columns, a few genes unlabelled or
    featureless), the 10 Enron slices of ENRON_NODES nodes with roles, and a
    ``--pkl`` bundle of PKL_GRAPHS cycles and stars with N(0, 1) features
    (200 for training, 40 for testing)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d = os.path.join(root, "ppi_essential")
    os.makedirs(d, exist_ok=True)
    ids = rng.permutation(np.arange(10_000, 10_000 + 3 * PPI_GENES))[:PPI_GENES]
    m = 4 * PPI_GENES
    s_, r_ = rng.integers(0, PPI_GENES, m), rng.integers(0, PPI_GENES, m)
    edges = [(int(ids[a]), int(ids[b])) for a, b in zip(s_, r_) if a != b]
    edges += [(90_000 + 3 * k, 90_000 + 3 * k + 1) for k in range(5)]
    with open(os.path.join(d, "hi-union-ppi.tsv"), "w") as f:
        f.write("# gene_a\tgene_b\n")
        f.writelines(f"{a}\t{b}\n" for a, b in edges)
    genes = sorted({g for e in edges for g in e})
    with open(os.path.join(d, "G-HumanEssential.tsv"), "w") as f:
        f.writelines(f"{g}\t{'Essential' if rng.random() < 0.3 else 'Non-Essential'}\n"
                     for g in genes if rng.random() < 0.97)
    with open(os.path.join(d, "G-MtfPathways_gene-motifs.csv"), "w") as f:
        f.write("gene," + ",".join(f"m{i}" for i in range(12)) + "\n")
        f.writelines(f"{g}," + ",".join(f"{v:.3f}" for v in rng.random(12) * 4) + "\n"
                     for g in genes if rng.random() < 0.97)
    roles = ["Employee", "Vice President", "Manager", "Trader",
             "CEO+Managing Director+Director+President"]
    d = os.path.join(root, "gnn-explainer-enron")
    os.makedirs(d, exist_ok=True)
    for i in range(10):
        n = ENRON_NODES
        mask = np.triu(rng.random((n, n)) < 0.04, 1)
        attrs = {u: {"role": roles[int(rng.integers(len(roles)))]}
                 for u in range(n) if rng.random() < 0.8}
        write_nx_pickle(os.path.join(d, f"enron_slice_{i}.pkl"),
                        _nx_graph(zip(*np.nonzero(mask)), n, attrs))
    graphs, labels = [], []
    for i in range(PKL_GRAPHS + 40):
        n = int(rng.integers(8, 30))
        cyc = i % 2 == 1
        edges = ([(u, (u + 1) % n) for u in range(n)] if cyc
                 else [(0, v) for v in range(1, n)])
        feats = {u: {"feat": rng.standard_normal(8).astype(np.float32)}
                 for u in range(n)}
        graphs.append(_nx_graph(edges, n, feats))
        labels.append(int(cyc))
    write_nx_pickle(os.path.join(root, "bundle.pkl"),
                    (graphs[:PKL_GRAPHS], labels[:PKL_GRAPHS], graphs[PKL_GRAPHS:],
                     labels[PKL_GRAPHS:]))


def phase_tasks():
    """Item 9 through ``cli.train`` on the card: ``--pkl``, ``ppi_essential``
    (COO and ``--bcsr``, which auto sends to B4 on the card), ``enron`` and
    ``enron_multigraph``, each timed, its events and accuracy curve checked,
    and its first TASK_TRAJ_EPOCHS losses held to the CPU's run of the same
    flags (deterministic mode; ``--bcsr`` to the CPU's resident twin)."""
    from tpugraph_torch import ops
    from tpugraph_torch.cli import train as cli_train

    launches, figures = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_task_fixtures(tmp)
        print(f"  fixtures written in {time.perf_counter() - t0:.1f} s", flush=True)
        for key, flags in TASK_ROWS:
            dirs = ["--datadir", tmp, "--ckptdir", os.path.join(tmp, key, "ckpt"),
                    "--logdir", os.path.join(tmp, key, "log")]
            ops.reset_launch_counts()
            summary, wall, _ = run_cli(cli_train.main, dirs + flags)
            path = f"cli_task_{key}"
            launches[path] = ops.launch_counts()
            fmt = format_ran(launches[path])
            epochs = int(flags[flags.index("--epochs") + 1])
            res = summary.get("result_test") or summary.get("test_result")
            check(res is not None and 0.0 <= res["acc"] <= 1.0,
                  f"task {key}: no test accuracy in {summary}")
            check(os.path.isfile(summary["train_curve"]), f"task {key}: no curve")
            short = dirs + flags + ["--epochs", str(TASK_TRAJ_EPOCHS)]
            short[short.index("--ckptdir") + 1] += "_short"
            with deterministic_mode():
                card = task_run(short)
            if fmt == "resident":
                cpu_loss = cpu_resident_losses(short, TASK_TRAJ_EPOCHS)
            else:
                cpu_loss = task_run(short + ["--platform", "cpu"])["history"]["loss"]
            err = max_diff(card["history"]["loss"], cpu_loss)
            rate = epochs / summary["elapsed_s"] if summary["elapsed_s"] else float("nan")
            print(f"  {key:16s} cli.train {' '.join(flags)}: ran {fmt}; test acc "
                  f"{res['acc']:.4f}; {rate:.1f} epochs/s ({wall:.2f} s the call); "
                  f"first {TASK_TRAJ_EPOCHS} epochs card vs CPU"
                  f"{' resident twin' if fmt == 'resident' else ''} loss max |diff| "
                  f"{err:.3g} (tol {TASK_TRAJ_TOL}); launches "
                  f"{ {k: v for k, v in launches[path].items() if v} } [{CARD}]",
                  flush=True)
            check(err <= TASK_TRAJ_TOL, f"task {key}: card and CPU losses differ by {err}")
            check(fmt == ("resident" if key == "ppi_bcsr" else "coo"),
                  f"task {key} trained in {fmt}")
            figures[key] = {"epochs_per_s": rate, "test_acc": res["acc"],
                            "traj_err": err, "format": fmt}
    return {"launches": launches, "figures": figures}


def phase_profile(gen):
    """A ``torch.profiler`` trace (``utils/profiling.py``) of the node
    trainer on syn1 (COO, then ``--bcsr``, which auto sends to B4), 30
    epochs each, and of one SYNBENCH epoch of the graph trainer: each
    traced epoch or minibatch step is a ``train_epoch``/``train_step``
    region, and for the last ten of them this prints the median
    device-busy share (the union of their kernels' intervals over the wall
    window), the launches and the host microseconds a launch."""
    import numpy as np
    import torch

    from tpugraph_torch import ops
    from tpugraph_torch.cli.tasks import build_graph_model
    from tpugraph_torch.cli.config import parse_train_args
    from tpugraph_torch.core.graph import graph_from_edge_list
    from tpugraph_torch.data import ConstFeatureGen, gen_syn1
    from tpugraph_torch.data.pipeline import prepare_data
    from tpugraph_torch.data.readers import read_graphfile
    from tpugraph_torch.nn import GcnEncoderNode
    from tpugraph_torch.train import TrainConfig, train_graph_classifier, train_node_classifier
    from tpugraph_torch.utils.profiling import device_busy, profile_trace

    G, labels, _ = gen_syn1(seed=0, feature_generator=ConstFeatureGen(
        np.ones(10, dtype=np.float32)))
    g = graph_from_edge_list(G.number_of_nodes(), G.edges())
    feat = np.stack([G.feat[u] for u in G.nodes()])
    dims = dict(input_dim=10, hidden_dim=20, embedding_dim=20, label_dim=4,
                num_layers=3)
    out, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = []
        for key, tc in (("syn1_coo", TrainConfig(num_epochs=30)),
                        ("syn1_bcsr", TrainConfig(num_epochs=30, **AUTO))):
            def run(tc=tc):
                model = GcnEncoderNode(**dims, generator=torch.Generator().manual_seed(0))
                with contextlib.redirect_stdout(io.StringIO()):
                    res = train_node_classifier(model, g, feat, labels, tc)
                return res["elapsed"] / tc.num_epochs
            runs.append((key, "train_epoch", run))
        write_tu_synthetic(tmp, "SYNBENCH")
        graphs = read_graphfile(tmp, "SYNBENCH", max_nodes=100)
        for G_ in graphs:
            G_.feat = {u: np.asarray(lab, dtype=np.float32)
                       for u, lab in G_.node_label.items()}
        train_b, _, _ = prepare_data(graphs, rng=np.random.default_rng(0), max_nodes=100)

        def run_graph():
            model = build_graph_model(parse_train_args([]), train_b, 2)
            tc = TrainConfig(num_epochs=1)
            res = train_graph_classifier(model, train_b, tc)
            return res["elapsed"] / -(-len(train_b) // tc.batch_size)
        runs.append(("synbench", "train_step", run_graph))
        for key, region, run in runs:
            run()  # warm: packing, allocator, cuBLAS handles
            plain_s = run()  # the same work without the profiler
            ops.reset_launch_counts()
            with profile_trace(os.path.join(tmp, key)) as prof:
                run()
            launches[f"profile_{key}"] = ops.launch_counts()
            recs = [device_busy(prof.trace_path, region, i) for i in range(-10, 0)]
            med = {k: float(np.median([r[k] for r in recs])) for k in recs[0]}
            # the profiler slows the host; the kernels' busy time is the
            # card's own, so also hold it to the unprofiled wall a unit
            med["plain_us"] = plain_s * 1e6
            med["busy_share_plain"] = med["busy_us"] / med["plain_us"]
            med["plain_us_per_launch"] = med["plain_us"] / max(med["launches"], 1)
            out[key] = med
            print(f"  profile {key} ({region}, median of the last 10): device busy "
                  f"{med['busy_us']:.1f} us, {med['busy_share']:.3f} of the traced "
                  f"{med['window_us']:.1f} us and {med['busy_share_plain']:.3f} of the "
                  f"unprofiled {med['plain_us']:.1f} us; {med['launches']:.0f} launches "
                  f"({med['kernels']:.0f} kernels), {med['window_us_per_launch']:.2f} us "
                  f"traced and {med['plain_us_per_launch']:.2f} us unprofiled of wall a "
                  f"launch, the launch call {med['launch_api_us']:.2f} us [{CARD}]",
                  flush=True)
            check(med["launches"] > 0 and med["kernels"] > 0,
                  f"profile {key}: no kernel ran in the traced region")
    print("profile " + json.dumps(out), flush=True)
    return {"launches": launches, "figures": out}


PAR_SHARDS = 4            # the 4-shard halo plans built on the host
PAR_BLOCK = 128           # their tile size (the halo path's default)
PAR_TRAJ_EPOCHS = 20      # world-size-1 halo rows held to the CPU over these epochs
PAR_TRAJ_TOL = 1e-4       # |card - CPU| of those losses (set before the first run)
PAR_DP_EPOCHS = 20        # SYNBENCH through train_graph_classifier on a 1-rank mesh
PAR_DP_TOL = 1e-5         # |1-rank mesh - single device| of its per-epoch loss (card)
PAR_ROWS = (  # name, cli.train flags, use_bcsr, overlap
    ("coo", [], False, "off"),
    ("bcsr", [], True, "off"),
    ("att_bcsr", ["--method", "att"], True, "off"),
    ("overlap", [], True, "on"),
)


def halo_plan_of(g, n_dev):
    """The halo plan ``train_node_classifier_halo`` builds for ``g`` on
    ``n_dev`` shards (the locality partition, then the plan), and the
    partition's ``(cut_edges, recv_rows)``."""
    import numpy as np

    from tpugraph_torch import native
    from tpugraph_torch.core.graph import graph_from_edges
    from tpugraph_torch.parallel import spmd

    s, r, w = g.senders.numpy(), g.receivers.numpy(), g.edge_weight.numpy()
    live = w != 0
    n = g.num_nodes_padded
    perm, inv = spmd.locality_partition(s[live], r[live], n, n_dev, weights=w[live])
    g2 = graph_from_edges(inv[s[live]].astype(np.int32), inv[r[live]].astype(np.int32),
                          len(perm), edge_weight=w[live])
    plan = spmd.build_halo_plan(g2, n_dev)
    assign = (inv[:n] // plan.shard_size).astype(np.int32)
    return plan, native.partition_cut_stats(s[live], r[live], w[live], n, n_dev, assign)


def measure_halo_shards(name, plan, ds, gen):
    """B1 and B2 on every shard of ``plan``'s BCSR forms, each held entry by
    entry to its plain twin: B1 on the rectangular ``[local | halo]`` tiles
    (dead tiles included) and on their transpose, B2 on the tiles and B1 on
    the transposed scores laid out by the padded transpose plan (the
    attention path's backward), and B1 on the overlap plan's local and halo
    tiles.  Shard 0 is timed at 21 calls, the others at 3.  Returns the
    records by kernel."""
    import torch

    from tpugraph_torch.ops.bcsr import transposed_bcsr
    from tpugraph_torch.parallel import spmd

    recs = {"spmm_bcsr": [], "sddmm_bcsr": []}
    n_dev, h = PAR_SHARDS, plan.halo_size
    bp = spmd.build_halo_bcsr(plan, n_dev, block=PAR_BLOCK, att=True)
    for d in range(n_dev):
        dead = int((~bp.m[d].tiles.reshape(bp.m[d].num_tiles, -1).any(1)).sum())
        dead_t = int((~bp.m_t[d].tiles.reshape(bp.m_t[d].num_tiles, -1).any(1)).sum())
        print(f"  {name} shard {d}: {bp.m[d].num_tiles} tiles ({dead} dead) over "
              f"[{plan.shard_size} | {n_dev} x {h}] columns, transpose "
              f"{bp.m_t[d].num_tiles} ({dead_t} dead), transpose plan "
              f"{bp.tp[d].num_tiles} entries, halo_size {h}", flush=True)
        m, mt, tp = bp.m[d].to("cuda"), bp.m_t[d].to("cuda"), bp.tp[d].to("cuda")
        iters = 21 if d == 0 else 3
        ex = {"shard": d, "dead_tiles": dead}
        for dd in ds:
            x = torch.randn((m.num_nodes, dd), generator=gen, device="cuda")
            dy = torch.randn((m.num_row_nodes, dd), generator=gen, device="cuda")
            recs["spmm_bcsr"].append(measure_spmm(f"{name}-s{d}", m, x, iters=iters,
                                                  extra=ex))
            recs["spmm_bcsr"].append(measure_spmm(f"{name}-s{d}-T", mt, dy, iters=iters,
                                                  extra=ex))
            recs["sddmm_bcsr"].append(measure_sddmm(f"{name}-s{d}", m, dy, x,
                                                    iters=iters, extra=ex))
            scores_t = transposed_bcsr(torch.sigmoid(m.tiles) * (m.tiles != 0), tp)
            recs["spmm_bcsr"].append(measure_spmm(f"{name}-s{d}-tp", scores_t, dy,
                                                  iters=iters, extra=ex))
            del x, dy, scores_t
        del m, mt, tp
        torch.cuda.empty_cache()
    del bp
    op = spmd.build_halo_bcsr_overlap(plan, n_dev, block=PAR_BLOCK)
    for d in range(n_dev):
        iters = 21 if d == 0 else 3
        for part in ("m_loc", "m_halo"):
            m = getattr(op, part)[d].to("cuda")
            x = torch.randn((m.num_nodes, ds[-1]), generator=gen, device="cuda")
            recs["spmm_bcsr"].append(measure_spmm(f"{name}-s{d}-{part[2:]}", m, x,
                                                  iters=iters, extra={"shard": d}))
            del m, x
    del op
    torch.cuda.empty_cache()
    return recs


def graph_task_inputs(argv):
    """The batchers, class count and card model ``benchmark_task`` builds
    for ``argv`` (node-label features, the seeded split)."""
    import numpy as np

    from tpugraph_torch.cli.config import parse_train_args
    from tpugraph_torch.cli.tasks import build_graph_model, train_config
    from tpugraph_torch.data.pipeline import prepare_data
    from tpugraph_torch.data.readers import read_graphfile

    cfg = parse_train_args(argv)
    graphs = read_graphfile(cfg.datadir, cfg.bmname, max_nodes=cfg.max_nodes)
    for G in graphs:
        G.feat = {u: np.asarray(lab, dtype=np.float32) for u, lab in G.node_label.items()}
    num_classes = max(G.graph["label"] for G in graphs) + 1
    split = prepare_data(graphs, train_ratio=cfg.train_ratio, test_ratio=cfg.test_ratio,
                         features=cfg.feature_type, max_nodes=cfg.max_nodes,
                         rng=np.random.default_rng(cfg.seed))
    return (split, train_config(cfg), cfg.seed,
            lambda: build_graph_model(cfg, split[0], num_classes, "cuda"))


def phase_parallel(gen, lowloc_tiles_eps):
    """The multi-device paths at the card's one rank (ROADMAP item 11, the
    training half), with the graph engine: the C++ and numpy halo plans of
    syn1 equal; B1/B2 on every shard of the 4-shard halo plans of syn1 (the
    CLI's graph, D = 10 and 20) and of the power-law graph (D = 128), held
    entry by entry; ``train_node_classifier_halo(n_dev=1)`` over a real
    1-rank NCCL group on syn1 at its published widths, 1000 epochs, in the
    four plan forms (COO deterministic, tiles, attention on tiles, the
    overlap split), each row's first epochs held to the CPU's run of the
    same function over a 1-rank gloo group and its test accuracy to the
    CPU's evaluation of the card's weights within one test node; the
    power-law graph 100 epochs on the tile halo path beside the
    single-device tiles row; SYNBENCH through ``train_graph_classifier``
    with a 1-rank mesh held to the single-device run; and ``cli.train
    --halo 2`` raising the launcher's device-count error before anything
    runs."""
    import dataclasses
    import multiprocessing

    import numpy as np
    import torch

    from tpugraph_torch import native, ops
    from tpugraph_torch.cli import train as cli_train
    from tpugraph_torch.cli.config import parse_train_args
    from tpugraph_torch.cli.tasks import node_task_data, node_task_model, train_config
    from tpugraph_torch.nn import GcnEncoderNode
    from tpugraph_torch.nn.layers import SparseAdj
    from tpugraph_torch.parallel import spmd
    from tpugraph_torch.parallel.launch import single_rank
    from tpugraph_torch.parallel.mesh import make_mesh
    from tpugraph_torch.train import TrainConfig, train_graph_classifier
    from tpugraph_torch.train.loop import train_node_classifier_halo

    launches, shapes = {}, {"spmm_bcsr": [], "sddmm_bcsr": []}
    t0 = time.perf_counter()
    # the engine, and its two paths on syn1's plan
    check(native.native_available(), "the C++ graph engine did not build")
    cfg1 = parse_train_args(["--dataset", "syn1"])
    G, labels, _ = node_task_data(cfg1)
    _, g1, _ = node_task_model(cfg1, G, labels, "cpu")
    plan_c = spmd.build_halo_plan(g1, PAR_SHARDS)
    real_lib = native._get_lib
    native._get_lib = lambda: None
    try:
        plan_n = spmd.build_halo_plan(g1, PAR_SHARDS)
    finally:
        native._get_lib = real_lib
    same = all(np.array_equal(getattr(plan_c, f), getattr(plan_n, f))
               for f in ("send_idx", "sender_slot", "receivers_local", "weights"))
    print(f"  graph engine: native_available {native.native_available()}; syn1 "
          f"halo plan C++ == numpy: {same}", flush=True)
    check(same and plan_c.halo_size == plan_n.halo_size,
          "the C++ and numpy halo plans of syn1 differ")

    # B1/B2 on the 4-shard plans of syn1 and of the power-law graph
    for name, g, ds in (("syn1-halo", g1, (10, 20)),
                        ("powerlaw-halo", None, (LOWLOC_D,))):
        if g is None:
            g = powerlaw_task(LOWLOC_NODES, 8)[0]
        t1 = time.perf_counter()
        plan, (cut, recv) = halo_plan_of(g, PAR_SHARDS)
        print(f"  {name}: {PAR_SHARDS} shards of {plan.shard_size} nodes, halo_size "
              f"{plan.halo_size}, partition_cut_stats cut {cut} edges, halo rows "
              f"received {recv.tolist()} (plan {time.perf_counter() - t1:.2f} s)",
              flush=True)
        recs = measure_halo_shards(name, plan, ds, gen)
        for k in shapes:
            shapes[k] += recs[k]
        del plan
    print(f"  shard kernels {time.perf_counter() - t0:.1f} s", flush=True)

    # world size 1: syn1 in four plan forms, card (NCCL) against the CPU (gloo)
    cpu_losses = {}
    with single_rank("gloo"):
        for name, flags, bcsr, overlap in PAR_ROWS:
            cfg = parse_train_args(["--dataset", "syn1"] + flags)
            model, g, feat = node_task_model(cfg, G, labels, "cpu")
            tc = dataclasses.replace(train_config(cfg), use_bcsr=bcsr,
                                     num_epochs=PAR_TRAJ_EPOCHS)
            out = train_node_classifier_halo(model, g, feat, labels, tc, 1,
                                             overlap=overlap, seed=cfg.seed)
            cpu_losses[name] = out["history"]["loss"]
    results = {}
    with single_rank("nccl"):
        check(make_mesh().backend == "nccl", "the 1-rank group is not NCCL")
        for name, flags, bcsr, overlap in PAR_ROWS:
            cfg = parse_train_args(["--dataset", "syn1"] + flags)
            model, g, feat = node_task_model(cfg, G, labels, "cuda")
            tc = dataclasses.replace(train_config(cfg), use_bcsr=bcsr)
            ops.reset_launch_counts()
            with (deterministic_mode() if name == "coo" else contextlib.nullcontext()):
                out = train_node_classifier_halo(model, g, feat, labels, tc, 1,
                                                 overlap=overlap, seed=cfg.seed)
            launches[f"parallel_halo_{name}"] = ops.launch_counts()
            err = max_diff(out["history"]["loss"][:PAR_TRAJ_EPOCHS], cpu_losses[name])
            # the CPU's evaluation of the card's weights (the single-device
            # forward over the original graph and node ids)
            ev, _, _ = node_task_model(cfg, G, labels, "cpu")
            ev.load_state_dict({k: v.cpu() for k, v in out["params"].items()})
            ev.eval()
            with torch.no_grad():
                logits, _ = ev(torch.from_numpy(feat), SparseAdj(
                    g.senders.long(), g.receivers.long(), g.edge_weight))
            test = out["test_idx"]
            cpu_acc = float(np.mean(logits.argmax(-1).numpy()[test] == labels[test]))
            acc = out["result_test"]["acc"]
            used = {k: v for k, v in launches[f"parallel_halo_{name}"].items() if v}
            print(f"  halo n_dev=1 {name}: {EPOCHS / out['elapsed']:.1f} epochs/s over "
                  f"{EPOCHS} epochs{' (deterministic)' if name == 'coo' else ''}; "
                  f"test acc {acc:.4f} (CPU eval of the card's weights {cpu_acc:.4f}, "
                  f"{len(test)} test nodes); first {PAR_TRAJ_EPOCHS} epochs card vs "
                  f"CPU max |diff| {err:.3g} (tol {PAR_TRAJ_TOL}); halo_size "
                  f"{out['halo_size']}; launches {used} [{CARD}]", flush=True)
            check(err <= PAR_TRAJ_TOL, f"halo {name}: card and CPU differ by {err}")
            check(abs(acc - cpu_acc) <= 1.0 / len(test) + 1e-9,
                  f"halo {name}: test acc {acc} vs the CPU's {cpu_acc}")
            check(bool(np.all(np.isfinite(out["ypred"]))), f"halo {name}: non-finite")
            if bcsr:
                check(used.get("spmm_bcsr", 0) > 0, f"halo {name} did not launch B1")
            if name == "att_bcsr":
                check(used.get("sddmm_bcsr", 0) > 0, f"halo {name} did not launch B2")
            results[name] = {"epochs_per_s": EPOCHS / out["elapsed"], "acc": acc,
                             "traj_err": err}

        # the power-law graph on the tile halo path, 100 epochs
        g, feat, plabels = powerlaw_task(LOWLOC_NODES, LOWLOC_D)
        model = GcnEncoderNode(LOWLOC_D, LOWLOC_D, LOWLOC_D, 4, 3,
                               generator=torch.Generator().manual_seed(0))
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        out = train_node_classifier_halo(
            model, g, feat, plabels, TrainConfig(num_epochs=LOWLOC_EPOCHS, use_bcsr=True,
                                                 bcsr_block=LOWLOC_BLOCK),
            1, overlap="off")
        launches["parallel_powerlaw_halo"] = ops.launch_counts()
        hist = out["history"]["loss"]
        eps = LOWLOC_EPOCHS / out["elapsed"]
        print(f"  halo n_dev=1 power-law ({LOWLOC_NODES} nodes, block {LOWLOC_BLOCK}, "
              f"f32 tiles): {eps:.2f} epochs/s against the single-device tiles row's "
              f"{lowloc_tiles_eps:.2f}; loss {hist[0]:.4f} -> {hist[-1]:.4f}; "
              f"{time.perf_counter() - t1:.1f} s with the plan [{CARD}]", flush=True)
        check(bool(np.all(np.isfinite(hist))) and hist[-1] < hist[0],
              "power-law halo training did not learn")
        check(launches["parallel_powerlaw_halo"]["spmm_bcsr"] > 0,
              "power-law halo training did not launch B1")
        results["powerlaw"] = {"epochs_per_s": eps, "tiles_epochs_per_s": lowloc_tiles_eps}
        del out, model
        torch.cuda.empty_cache()

        # SYNBENCH on a 1-rank mesh against the single-device run
        with tempfile.TemporaryDirectory() as tmp:
            write_tu_synthetic(tmp, "SYNBENCH")
            split, tc, seed, make = graph_task_inputs(
                ["--bmname", "SYNBENCH", "--datadir", tmp, "--max-nodes", "100",
                 "--epochs", str(PAR_DP_EPOCHS)])
            init = make().state_dict()
            runs = {}
            for tag, mesh in (("single", None), ("mesh1", make_mesh())):
                with deterministic_mode(), contextlib.redirect_stdout(io.StringIO()):
                    runs[tag] = train_graph_classifier(
                        make(), split[0], tc, val_batcher=split[1], test_batcher=split[2],
                        seed=seed, init_params=init, mesh=mesh)
            err = max_diff(runs["mesh1"]["history"]["loss"], runs["single"]["history"]["loss"])
            gps = PAR_DP_EPOCHS * len(split[0]) / runs["mesh1"]["elapsed"]
            print(f"  SYNBENCH on a 1-rank mesh, {PAR_DP_EPOCHS} epochs: loss max |diff| "
                  f"against one device {err:.3g} (tol {PAR_DP_TOL}); test acc "
                  f"{runs['mesh1']['test_result']['acc']:.4f}; {gps:.1f} graphs/s "
                  f"[{CARD}]", flush=True)
            check(err <= PAR_DP_TOL, f"1-rank mesh and one device differ by {err}")
            results["dp_mesh1"] = {"loss_err": err, "graphs_per_s": gps}

    # --halo 2 with fewer cards than ranks: the launcher's error, nothing run
    with tempfile.TemporaryDirectory() as tmp:
        ck, log = os.path.join(tmp, "ck"), os.path.join(tmp, "log")
        have = torch.cuda.device_count()
        try:
            cli_train.main(["--dataset", "syn1", "--halo", "2", "--ckptdir", ck,
                            "--logdir", log])
            raised = ""
        except RuntimeError as e:
            raised = str(e)
        print(f"  cli.train --halo 2 on {have} card(s): "
              f"{raised.splitlines()[0] if raised else 'no error'}", flush=True)
        check("2 ranks on NCCL need 2 CUDA devices" in raised
              and f"this host has {have}" in raised,
              "--halo 2 did not raise the launcher's device-count error")
        check(not os.path.exists(ck) and not os.path.exists(log)
              and not multiprocessing.active_children(),
              "--halo 2 ran something before it raised")
    print(f"  parallel phase {time.perf_counter() - t0:.1f} s", flush=True)
    return {"launches": launches, "shapes": shapes, "results": results}


MESH_STATS = list(range(400, 700, 5))   # the stats explain's 60 queries
MESH_BCSR = list(range(400, 700, 60))   # the tile-space queries (5)
MESH_SAME_TOL = 1e-6     # |sharded - one device| of a mask entry, same card, same kernels
MESH_CPU_EPOCHS = 20     # mask epochs of the card-vs-CPU comparisons
MESH_CPU_TOL = 1e-4      # |card - CPU| of a mask entry after them (set before the first run)
MESH_TP_STEPS = 20       # Adam steps of each TP row
MESH_TP_TOL = 1e-5       # |TP at world size 1 - one device| of each syn1 loss
MESH_TP_WIDE_TOL = 1e-3  # the same on the power-law graph at width 128 (atomic sums)


def _max_mask_diff(a, b):
    import numpy as np

    check(len(a) == len(b), f"{len(a)} results against {len(b)}")
    err = 0.0
    for ra, rb in zip(a, b):
        check(ra["node_idx"] == rb["node_idx"]
              and ra["masked_adj"].shape == rb["masked_adj"].shape,
              f"query {ra['node_idx']} against {rb['node_idx']}")
        err = max(err, float(np.max(np.abs(ra["masked_adj"] - rb["masked_adj"]))),
                  float(np.max(np.abs(ra["feat_mask"] - rb["feat_mask"]))))
    return err


def _tp_rows(model, g, x, y, mask, steps, sharded):
    """``steps`` Adam(1e-3) steps of a copy of ``model`` on the COO graph:
    the tensor-parallel step over the active 1-rank group (``sharded``) or
    the plain single-device one; returns the losses and steps/s."""
    import copy

    import torch

    from tpugraph_torch.nn.layers import SparseAdj
    from tpugraph_torch.nn.losses import node_cross_entropy
    from tpugraph_torch.parallel import tp
    from tpugraph_torch.parallel.mesh import make_mesh
    from tpugraph_torch.train.optim import OptimizerConfig, build_optimizer

    model = copy.deepcopy(model)
    dev = torch.device("cuda")
    sr = (g.senders.long().to(dev), g.receivers.long().to(dev), g.edge_weight.to(dev))
    xt, yt, mt = (torch.from_numpy(a).to(dev) for a in (x, y, mask))
    cfg = OptimizerConfig(opt="adam", lr=1e-3)
    if sharded:
        mesh = make_mesh(axis_names=("model",))
        tp.shard_params_tp(model, mesh)
        step = tp.make_tp_node_train_step(model, build_optimizer(model.parameters(), cfg),
                                          mesh)
    else:
        opt = build_optimizer(model.parameters(), cfg)

        def step(s, r, w, xx, yy, mm):
            opt.zero_grad()
            loss = node_cross_entropy(model(xx, SparseAdj(s, r, w))[0], yy, node_mask=mm)
            loss.backward()
            opt.step()
            return loss.detach()

    losses = [float(step(*sr, xt, yt, mt))]  # the first step, untimed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(*sr, xt, yt, mt) for _ in range(steps - 1)]
    torch.cuda.synchronize()
    sps = (steps - 1) / (time.perf_counter() - t0)
    return [float(v) for v in losses], sps


def phase_mesh(gen, keep):
    """The explainer's query sharding and tensor parallelism at the card's
    one rank (ROADMAP item 11, the rest), on syn1 at its published widths
    from the coo phase's checkpoints (COO and ``--bcsr``):

    * ``explain_nodes_batch(mesh=)`` over a 1-rank NCCL group on the 60
      stats nodes, 100 mask epochs, against the single-device card run
      (both deterministic: index_add_ sums in edge order), and with
      MESH_CPU_EPOCHS epochs against the CPU's over a 1-rank gloo group;
      the AUCs side by side;
    * ``explain_nodes_bcsr(mesh=)`` on 5 nodes: B1 and B2 launched, every
      mask entry the sequential card run's, and with MESH_CPU_EPOCHS
      epochs the CPU's; B1/B2 held to their twins at this path's shapes;
    * the tensor-parallel step at world size 1: syn1, MESH_TP_STEPS Adam
      steps, each loss held to one device's (deterministic); the power-law
      graph at width 128 on COO beside the single-device COO step;
    * ``cli.explain --mesh 2`` raising the launcher's device-count error
      before anything is written."""
    import multiprocessing

    import numpy as np
    import torch

    from tpugraph_torch import ops
    from tpugraph_torch.cli import explain as cli_explain
    from tpugraph_torch.cli.config import parse_explain_args
    from tpugraph_torch.explain import explanation_auc
    from tpugraph_torch.nn import GcnEncoderNode
    from tpugraph_torch.ops.bcsr import transposed_bcsr
    from tpugraph_torch.parallel.launch import single_rank
    from tpugraph_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    launches, shapes, results = {}, {"spmm_bcsr": [], "sddmm_bcsr": []}, {}

    def explainer(ckpt, platform=(), epochs=None):
        ex = cli_explain.build_explainer(parse_explain_args(
            ["--dataset", "syn1", "--ckptdir", os.path.join(keep, ckpt),
             "--logdir", os.path.join(keep, "mesh_log")] + list(platform)))
        ex.print_training, ex.logdir = False, None
        if epochs:
            ex.cfg = ex.cfg._replace(num_epochs=epochs)
        return ex

    def auc_of(res):
        return explanation_auc([r["masked_adj"] for r in res],
                               [r["node_idx_new"] for r in res], "syn1")[0]

    # ---- COO: 60 queries, sharded against one device and against the CPU
    ex = explainer("coo")
    with deterministic_mode():
        single = ex.explain_nodes_batch(MESH_STATS)
        ops.reset_launch_counts()
        with single_rank("nccl"):
            mesh = make_mesh()
            check(mesh.backend == "nccl" and mesh.size == 1, "not a 1-rank NCCL mesh")
            t0 = time.perf_counter()
            sharded = ex.explain_nodes_batch(MESH_STATS, mesh=mesh)
            torch.cuda.synchronize()
            coo_s = time.perf_counter() - t0
        launches["mesh_coo_explain"] = ops.launch_counts()
    same = _max_mask_diff(sharded, single)
    auc_mesh, auc_one = auc_of(sharded), auc_of(single)
    short_card = explainer("coo", epochs=MESH_CPU_EPOCHS)
    with deterministic_mode(), single_rank("nccl"):
        card20 = short_card.explain_nodes_batch(MESH_STATS, mesh=make_mesh())
    with single_rank("gloo"):
        cpu20 = explainer("coo", ["--platform", "cpu"], MESH_CPU_EPOCHS
                          ).explain_nodes_batch(MESH_STATS, mesh=make_mesh())
    cpu_err = _max_mask_diff(card20, cpu20)
    print(f"  explain_nodes_batch(mesh=1-rank NCCL) on {len(MESH_STATS)} nodes x 100 "
          f"epochs (deterministic): {coo_s:.3f} s; AUC {auc_mesh:.4f} against one "
          f"device's {auc_one:.4f}; max |sharded - one device| {same:.3g} (tol "
          f"{MESH_SAME_TOL}); {MESH_CPU_EPOCHS} epochs card vs CPU (gloo) max |diff| "
          f"{cpu_err:.3g} (tol {MESH_CPU_TOL}) [{CARD}]", flush=True)
    check(same <= MESH_SAME_TOL, f"sharded COO explain differs by {same}")
    check(cpu_err <= MESH_CPU_TOL, f"sharded COO explain card vs CPU: {cpu_err}")
    check(auc_mesh > 0.9, f"sharded COO AUC {auc_mesh}")
    check(sum(launches["mesh_coo_explain"].values()) == 0,
          "the COO explain launched a kernel")
    results["coo"] = {"s": coo_s, "auc": auc_mesh, "auc_single": auc_one,
                      "same_err": same, "cpu_err": cpu_err}
    del ex, single, sharded, short_card, card20, cpu20

    # ---- tile space: 5 queries in rounds of one, B1 forward and on A^T, B2
    ex = explainer("bcsr")
    t0 = time.perf_counter()
    seq = ex.explain_nodes_bcsr(MESH_BCSR)
    seq_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    with single_rank("nccl"):
        t0 = time.perf_counter()
        sharded = ex.explain_nodes_bcsr(MESH_BCSR, mesh=make_mesh())
        torch.cuda.synchronize()
        bcsr_s = time.perf_counter() - t0
    launches["mesh_bcsr_explain"] = counts = ops.launch_counts()
    same = _max_mask_diff(sharded, seq)
    short_card = explainer("bcsr", epochs=MESH_CPU_EPOCHS)
    with single_rank("nccl"):
        card20 = short_card.explain_nodes_bcsr(MESH_BCSR, mesh=make_mesh())
    with single_rank("gloo"):
        cpu20 = explainer("bcsr", ["--platform", "cpu"], MESH_CPU_EPOCHS
                          ).explain_nodes_bcsr(MESH_BCSR, mesh=make_mesh())
    cpu_err = _max_mask_diff(card20, cpu20)
    auc_b = auc_of(sharded)
    used = {k: v for k, v in counts.items() if v}
    print(f"  explain_nodes_bcsr(mesh=1-rank NCCL) on {MESH_BCSR}: {bcsr_s:.3f} s "
          f"(sequential {seq_s:.3f} s); AUC {auc_b:.4f}; max |sharded - sequential| "
          f"{same:.3g} (tol {MESH_SAME_TOL}); {MESH_CPU_EPOCHS} epochs card vs CPU "
          f"(gloo) max |diff| {cpu_err:.3g} (tol {MESH_CPU_TOL}); launches {used} "
          f"[{CARD}]", flush=True)
    check(counts["spmm_bcsr"] > 0 and counts["sddmm_bcsr"] > 0,
          "the sharded tile-space explain did not launch B1 and B2")
    check(same <= MESH_SAME_TOL, f"sharded tile-space explain differs by {same}")
    check(cpu_err <= MESH_CPU_TOL, f"sharded tile-space explain card vs CPU: {cpu_err}")
    results["bcsr"] = {"s": bcsr_s, "sequential_s": seq_s, "auc": auc_b,
                       "same_err": same, "cpu_err": cpu_err}
    # B1/B2 at this path's shapes: the explainer's pack, its laid-out
    # transpose, D = 10 (layer 1) and 20
    _, _, m, tp_plan, _, _, _ = ex._bcsr_pack(0, 128)
    m_t = transposed_bcsr(m.tiles, tp_plan)
    for d in (10, 20):
        x = torch.randn((m.num_nodes, d), generator=gen, device="cuda")
        dy = torch.randn((m.num_row_nodes, d), generator=gen, device="cuda")
        shapes["spmm_bcsr"] += [measure_spmm("mesh-syn1", m, x),
                                measure_spmm("mesh-syn1-T", m_t, dy)]
        shapes["sddmm_bcsr"].append(measure_sddmm("mesh-syn1", m, dy, x))
    del ex, seq, sharded, short_card, card20, cpu20, m_t, x, dy

    # ---- tensor parallelism at world size 1
    from tpugraph_torch.core import graph_from_edge_list
    from tpugraph_torch.data import gen_syn1

    G, labels, _ = gen_syn1(seed=0)
    g = graph_from_edge_list(G.number_of_nodes(), G.edges())
    x = np.zeros((g.num_nodes_padded, 10), np.float32)
    x[: G.number_of_nodes()] = np.stack([G.feat[u] for u in G.nodes()])
    y = np.zeros(g.num_nodes_padded, np.int64)
    y[: len(labels)] = labels
    mask = g.node_mask.numpy()
    model = GcnEncoderNode(10, 20, 20, 4, 3, generator=torch.Generator().manual_seed(0))
    ops.reset_launch_counts()
    with deterministic_mode():
        one, one_sps = _tp_rows(model, g, x, y, mask, MESH_TP_STEPS, False)
        with single_rank("nccl"):
            tpl, tp_sps = _tp_rows(model, g, x, y, mask, MESH_TP_STEPS, True)
    launches["mesh_tp_syn1"] = ops.launch_counts()
    err = max_diff(tpl, one)
    print(f"  TP step at world size 1, syn1 (10 -> 20 -> 20, 4 classes), "
          f"{MESH_TP_STEPS} Adam steps (deterministic): loss {tpl[0]:.5f} -> "
          f"{tpl[-1]:.5f}, max |TP - one device| {err:.3g} (tol {MESH_TP_TOL}); "
          f"{tp_sps:.1f} steps/s against {one_sps:.1f} [{CARD}]", flush=True)
    check(err <= MESH_TP_TOL and tpl[-1] < tpl[0], f"TP syn1 losses differ by {err}")
    g, feat, plabels = powerlaw_task(LOWLOC_NODES, LOWLOC_D)
    yp = np.zeros(g.num_nodes_padded, np.int64)
    yp[: len(plabels)] = plabels
    model = GcnEncoderNode(LOWLOC_D, LOWLOC_D, LOWLOC_D, 4, 3,
                           generator=torch.Generator().manual_seed(0))
    ops.reset_launch_counts()
    one_w, one_w_sps = _tp_rows(model, g, feat, yp, g.node_mask.numpy(),
                                MESH_TP_STEPS, False)
    with single_rank("nccl"):
        tp_w, tp_w_sps = _tp_rows(model, g, feat, yp, g.node_mask.numpy(),
                                  MESH_TP_STEPS, True)
    launches["mesh_tp_powerlaw"] = ops.launch_counts()
    err_w = max_diff(tp_w, one_w)
    print(f"  TP step at world size 1, power-law ({LOWLOC_NODES} nodes, width "
          f"{LOWLOC_D}, COO), {MESH_TP_STEPS} Adam steps: {tp_w_sps:.2f} steps/s "
          f"against the single-device COO step's {one_w_sps:.2f}; loss {tp_w[0]:.5f} "
          f"-> {tp_w[-1]:.5f}, max |TP - one device| {err_w:.3g} (tol "
          f"{MESH_TP_WIDE_TOL}) [{CARD}]", flush=True)
    check(err_w <= MESH_TP_WIDE_TOL and bool(np.all(np.isfinite(tp_w))),
          f"TP power-law losses differ by {err_w}")
    check(sum(launches["mesh_tp_syn1"].values()) + sum(
        launches["mesh_tp_powerlaw"].values()) == 0, "the COO TP step launched a kernel")
    results["tp"] = {"syn1_err": err, "syn1_steps_per_s": tp_sps,
                     "syn1_single_steps_per_s": one_sps, "powerlaw_err": err_w,
                     "powerlaw_steps_per_s": tp_w_sps,
                     "powerlaw_single_steps_per_s": one_w_sps}
    del g, feat, model
    torch.cuda.empty_cache()

    # ---- --mesh 2 with fewer cards than ranks: the launcher's error
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "log")
        have = torch.cuda.device_count()
        try:
            cli_explain.main(["--dataset", "syn1", "--mesh", "2", "--ckptdir",
                              os.path.join(keep, "coo"), "--logdir", log])
            raised = ""
        except RuntimeError as e:
            raised = str(e)
        print(f"  cli.explain --mesh 2 on {have} card(s): "
              f"{raised.splitlines()[0] if raised else 'no error'}", flush=True)
        check("2 ranks on NCCL need 2 CUDA devices" in raised
              and f"this host has {have}" in raised,
              "--mesh 2 did not raise the launcher's device-count error")
        check(not os.path.exists(log) and not multiprocessing.active_children(),
              "--mesh 2 wrote or ran something before it raised")
    mesh_s = time.perf_counter() - t_phase
    print(f"  mesh phase {mesh_s:.1f} s", flush=True)
    print("mesh " + json.dumps({**results, "phase_s": mesh_s}), flush=True)
    return {"launches": launches, "shapes": shapes, "results": results}


def pair_csr(pair):
    """A's and A_t's halves of a pair as f32 CSR matrices of their widened
    tile entries: the independent oracle of B5."""
    import torch

    b = pair.block

    def csr(lo, hi, n_rows, n_cols):
        tiles = pair.tiles[lo:hi]
        t, i, j = (tiles != 0).nonzero(as_tuple=True)
        rows = pair.rows[lo:hi].long()[t] * b + i
        cols = pair.col_blk[lo:hi].long()[t] * b + j
        return torch.sparse_coo_tensor(
            torch.stack([rows, cols]), tiles[t, i, j].float(), (n_rows, n_cols)
        ).coalesce().to_sparse_csr()

    return (csr(0, pair.t1, pair.num_mid_nodes, pair.num_nodes),
            csr(pair.t1, pair.num_tiles, pair.num_out_nodes, pair.num_mid_nodes))


def oracle_check(tag, pair, x, z):
    """B5's f32 output ``z`` against two f32 ``torch.sparse.mm`` calls,
    entry by entry within the rounding bound: y's one bf16 rounding
    (``2^-8 |y|`` carried by |A_t|) and f32 sums of at most ``k`` nonzeros
    a row, in either order, in both phases of both sides
    (``5 k u |A_t| |A| |x|``); and, as an extra check, within 3 bf16
    roundings of max|ref|."""
    import torch

    a, a_t = pair_csr(pair)
    k = max(int((c.crow_indices()[1:] - c.crow_indices()[:-1]).max())
            for c in (a, a_t))
    mod = lambda c: torch.sparse_csr_tensor(c.crow_indices(), c.col_indices(),
                                            c.values().abs(), c.shape)
    xf = x.float()
    y = torch.sparse.mm(a, xf)
    ref = torch.sparse.mm(a_t, y)
    bound = (BF16_REL * torch.sparse.mm(mod(a_t), y.abs())
             + 5 * k * F32_U * torch.sparse.mm(mod(a_t),
                                                torch.sparse.mm(mod(a), xf.abs())))
    diff = (z - ref).abs()
    used = float((diff / (bound + TINY)).max())
    err, scale = float(diff.max()), float(ref.abs().max())
    print(f"  {tag}: B5 f32 vs torch.sparse.mm oracle max |err| {err:.4g} "
          f"(max|ref| {scale:.4g}); at most {used:.3g} of each entry's rounding "
          f"bound (k = {k})", flush=True)
    check(bool((diff <= bound + TINY).all()),
          f"{tag}: B5 leaves the oracle beyond the rounding bound ({used:.3g})")
    check(err <= 3 * BF16_REL * scale,
          f"{tag}: B5 leaves the oracle by {err}, over 3 bf16 roundings of max|ref|")


def phase_diffuse(g):
    """The diffusion path at full width: ``DiffusionOperator`` on the
    power-law graph (block 256), seeded N(0, 1) bf16 x with D = 128, one
    ``op(x, hops)`` (B6) and one ``spmm_pair_resident`` (B5) per operator,
    B5's f32 output held against ``oracle_check``, and both kernels
    against their plain versions with their bounds."""
    import torch

    from tpugraph_torch import ops
    from tpugraph_torch.ops import resident_kernels as rk
    from tpugraph_torch.ops.diffusion import DiffusionOperator

    n, d, b = g.num_nodes_padded, LOWLOC_D, LOWLOC_BLOCK
    n_edges = int((g.edge_weight != 0).sum())
    shape = f"powerlaw-{n // 1024}k"
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((n, d), generator=gen, device="cuda").to(torch.bfloat16)
    launches, recs = {}, {"spmm_pair_resident": [], "spmm_power_resident": []}
    no_library = ("no single PyTorch call computes A_t (A x) with y rounded "
                  "to bf16 between the two products")
    for tag, normalize, hops in DIFF_CASES:
        t0 = time.perf_counter()
        op = DiffusionOperator(g, block=b, normalize=normalize)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        pair = op.pair
        kind = str(pair.tiles.dtype).split(".")[1]
        check(kind == ("bfloat16" if normalize else "int8"), f"{tag}: {kind} tiles")
        ops.reset_launch_counts()
        y = op(x, hops)
        z = ops.spmm_pair_resident(pair, x, out_dtype=torch.float32)
        torch.cuda.synchronize()
        launches[f"diffuse_{tag}"] = ops.launch_counts()
        y_max = float(y.float().abs().max())
        lists = [int(p[1] - p[0]) for p in (pair.row_ptr1, pair.row_ptr2)]
        longest = [int((p[1:] - p[:-1]).max()) for p in (pair.row_ptr1, pair.row_ptr2)]
        print(f"  {tag}: pack {pack_s:.2f} s, {pair.num_tiles} {kind} tiles of "
              f"{b}^2 ({pair.tiles.numel() * pair.tiles.element_size() / 1e9:.2f} "
              f"GB) in the pair (t1 {pair.t1}); m = {1 / math.sqrt(op.hop_scale):.1f}, "
              f"hop_scale {op.hop_scale:.6g}; hops {hops}: max|y| {y_max:.6g}; "
              f"row block 0 lists {lists[0]} / {lists[1]} tiles (longest "
              f"{longest[0]} / {longest[1]}); launches "
              f"{ {k: v for k, v in launches[f'diffuse_{tag}'].items() if v} }",
              flush=True)
        check(y.shape == (n, d) and y.dtype == torch.bfloat16
              and bool(torch.isfinite(y.float()).all()) and y_max > 0,
              f"{tag}: diffusion output bad or all zero")
        for k in ("spmm_pair_resident", "spmm_power_resident"):
            check(launches[f"diffuse_{tag}"][k] > 0, f"{tag} did not launch {k}")
        oracle_check(tag, pair, x, z)
        del z, y
        torch.cuda.empty_cache()

        nnz = int((pair.tiles != 0).sum())
        tile_bytes = pair.num_tiles * b * b * pair.tiles.element_size()
        tol_k = max(longest) * b
        extra = {"tile": kind, "x": "bf16", "tiles": pair.num_tiles, "nnz": nnz,
                 "row_block0_tiles": lists, "pack_s": round(pack_s, 3)}
        for od in (torch.float32, torch.bfloat16):
            out_b = 2 if od == torch.bfloat16 else 4
            rec = measure_case(
                "spmm_pair_resident", shape, d,
                lambda: rk.spmm_pair_resident(pair, x, out_dtype=od),
                lambda: rk.spmm_pair_resident_plain(pair, x, od), None,
                tile_bytes + 2 * n * d + out_b * n * d, 2.0 * nnz * d,
                BF16_FLOPS_PER_S, tol_k, 1,
                extra={**extra, "out": "bf16" if out_b == 2 else "f32"}, iters=11)
            rec["library_null_reason"] = no_library
            rec["edges_per_s"] = 2 * n_edges / (rec["ms"] / 1e3)
            recs["spmm_pair_resident"].append(rec)
        rec = measure_case(
            "spmm_power_resident", shape, d, lambda: op(x, hops),
            lambda: rk.spmm_power_resident_plain(pair, x, hops, torch.bfloat16,
                                                 op.hop_scale), None,
            hops * tile_bytes + 2 * n * d + 2 * n * d, 2.0 * hops * nnz * d,
            BF16_FLOPS_PER_S, tol_k, POWER_CARRIED,
            extra={**extra, "hops": hops, "hop_scale": op.hop_scale,
                   "out": "bf16"}, iters=5)
        rec["library_null_reason"] = no_library
        rec["diffusion_edges_per_s"] = 2 * n_edges * hops / (rec["ms"] / 1e3)
        print(f"  {tag}: diffusion {rec['diffusion_edges_per_s']:.4g} edges/s "
              f"(2 * {n_edges} edges * {hops} hops / {rec['ms']:.3f} ms)", flush=True)
        recs["spmm_power_resident"].append(rec)
        del op, pair
        torch.cuda.empty_cache()
    return {"launches": launches, **recs}


def main() -> int:
    # cuBLAS's fixed workspace, which the syn phase's deterministic re-runs
    # ask for (it must be set before the first cuBLAS call); 8 x 4 MiB is
    # the size PyTorch picks on sm_90 anyway, so no other phase changes
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    print("packages " + json.dumps({m: importlib.util.find_spec(m) is not None for m in
                                    ("matplotlib", "scipy", "networkx", "sklearn")}),
          flush=True)
    import numpy as np

    from tpugraph_torch import ops
    from tpugraph_torch.core import graph_from_edge_list
    from tpugraph_torch.data import gen_syn1, preprocess_input_graph
    from tpugraph_torch.explain import Explainer, explanation_auc
    from tpugraph_torch.nn import GcnEncoderNode
    from tpugraph_torch.ops import bcsr
    from tpugraph_torch.ops import bcsr_kernels as bk
    from tpugraph_torch.ops._build import build_kernels
    from tpugraph_torch.train import (TrainConfig, gen_prefix, load_checkpoint,
                                      save_checkpoint, train_node_classifier)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    global CARD
    CARD = smi
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    build_s = build_kernels()
    print(f"kernel build: {build_s:.2f} s")
    from tpugraph_torch import native

    t0 = time.perf_counter()
    print(f"graph engine (g++): native_available {native.native_available()} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)

    # ---- syn1 data, shared by the phases
    G, labels, _ = gen_syn1(seed=0)
    g = graph_from_edge_list(G.number_of_nodes(), G.edges())
    feat = np.stack([G.feat[u] for u in G.nodes()])
    s, r, w = g.senders.numpy(), g.receivers.numpy(), g.edge_weight.numpy()
    m_syn1 = bcsr.bcsr_from_coo(s, r, w, g.num_nodes_padded).to(dev)

    # ---- phase 1: kernels against their plain versions
    print("phase kernels", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [measure_kernels("syn1", m_syn1, d, gen) for d in (10, 20)]
    t0 = time.perf_counter()
    bs, br, bw = banded_edges(65536, 1024, 16, seed=0)
    m_big = bcsr.bcsr_from_coo(bs, br, bw, 65536).to(dev)
    print(f"  scaled graph: {bs.size} edges, {m_big.num_tiles} tiles "
          f"({m_big.num_tiles * 128 * 128 * 4 / 1e9:.2f} GB), packed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    shapes.append(measure_kernels("scaled", m_big, 128, gen))
    del m_big
    torch.cuda.empty_cache()
    b2_mixed = b2_branches(gen)
    crossover = b2_crossover(gen)
    print(f"  B2 crossover in the wrapper: "
          f"{ {d: bk.sddmm_crossover(d) for d in crossover} } nonzeros a 64^2 "
          f"sub-tile by D (measured here: "
          f"{ {d: c['nnz_per_subtile'] for d, c in crossover.items()} })", flush=True)
    b1_mixed = b1_branches(gen)
    b1_cross = b1_crossover(gen)

    # ---- phase 2: training (first 20 epochs held against the CPU)
    print("phase train", flush=True)
    dims = dict(input_dim=10, hidden_dim=20, embedding_dim=20, label_dim=4,
                num_layers=3)
    init = GcnEncoderNode(**dims, generator=torch.Generator().manual_seed(0),
                          device="cpu").state_dict()
    # resident "off": auto would take the resident format (B4) for syn1 on
    # the card; this row holds B1's training path
    pinned = dict(use_bcsr=True, bcsr_resident="off")
    short = TrainConfig(num_epochs=20, **pinned)
    cpu_out = train_node_classifier(GcnEncoderNode(**dims, device="cpu"), g,
                                    feat, labels, short, init_params=init,
                                    device="cpu")
    gpu_out = train_node_classifier(GcnEncoderNode(**dims), g, feat, labels,
                                    short, init_params=init)
    traj_err = float(np.max(np.abs(np.subtract(cpu_out["history"]["loss"],
                                               gpu_out["history"]["loss"]))))
    print(f"  20-epoch loss trajectory, card vs CPU: max |diff| {traj_err:.3g}")
    check(traj_err <= 1e-4, f"card and CPU loss trajectories differ by {traj_err}")

    model = GcnEncoderNode(**dims, generator=torch.Generator().manual_seed(0))
    ops.reset_launch_counts()
    out = train_node_classifier(model, g, feat, labels,
                                TrainConfig(num_epochs=EPOCHS, **pinned))
    train_launches = ops.launch_counts()
    hist = out["history"]
    print(f"  loss {hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f}; "
          f"train acc {out['result_train']['acc']:.4f} test acc "
          f"{out['result_test']['acc']:.4f}; {EPOCHS / out['elapsed']:.1f} "
          f"epochs/s; launches {train_launches}", flush=True)
    check(out["ypred"].shape == (1, m_syn1.num_nodes, 4)
          and bool(np.all(np.isfinite(out["ypred"]))), "non-finite predictions")
    check(out["result_test"]["acc"] >= 0.85,
          f"test acc {out['result_test']['acc']} < 0.85")
    check(train_launches["spmm_bcsr"] > 0, "training did not launch spmm_bcsr")

    # ---- phase 3: checkpoint round trip and explanation
    print("phase explain", flush=True)
    data = preprocess_input_graph(G, labels)
    n = data["adj"].shape[1]
    with tempfile.TemporaryDirectory() as ckptdir:
        prefix = gen_prefix("syn1")
        save_checkpoint(ckptdir, prefix, out["params"], cg_dict={
            "adj": data["adj"], "feat": data["feat"], "label": data["labels"],
            "pred": out["ypred"][:, :n], "train_idx": out["train_idx"]})
        ck = load_checkpoint(ckptdir, prefix)
    cg = ck["cg"]
    ex = Explainer(GcnEncoderNode(**dims), ck["params"], cg["adj"], cg["feat"],
                   cg["label"], cg["pred"])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = ex.explain_nodes_bcsr(EXPLAIN_NODES)
    torch.cuda.synchronize()
    explain_s = time.perf_counter() - t0
    explain_launches = ops.launch_counts()
    auc, _, _ = explanation_auc([res["masked_adj"] for res in results],
                                [res["node_idx_new"] for res in results], "syn1")
    print(f"  AUC {auc:.4f} over nodes {EXPLAIN_NODES}; "
          f"{explain_s / len(EXPLAIN_NODES):.3f} s a node; launches "
          f"{explain_launches}", flush=True)
    for res in results:
        ma = res["masked_adj"]
        check(ma.shape == (len(res["neighbors"]),) * 2 and bool(np.all(np.isfinite(ma)))
              and bool(np.allclose(ma, ma.T, atol=1e-5)), "bad masked_adj")
    check(auc > 0.9, f"explanation AUC {auc} <= 0.9")
    for k in ("spmm_bcsr", "sddmm_bcsr"):
        check(explain_launches[k] > 0, f"explanation did not launch {k}")

    # the same five nodes with bf16 kernel tiles: the explainer's private
    # hook onto run_bcsr_mask_optimization(spmm_dtype=...), which tpugraph's
    # Explainer does not expose either
    ex._spmm_dtype = torch.bfloat16
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results16 = ex.explain_nodes_bcsr(EXPLAIN_NODES)
    torch.cuda.synchronize()
    bf16_s = time.perf_counter() - t0
    bf16_launches = ops.launch_counts()
    ex._spmm_dtype = None
    auc16, _, _ = explanation_auc([res["masked_adj"] for res in results16],
                                  [res["node_idx_new"] for res in results16],
                                  "syn1")
    print(f"  spmm_dtype=bf16: AUC {auc16:.4f}; {bf16_s / len(EXPLAIN_NODES):.3f} "
          f"s a node; launches {bf16_launches}", flush=True)
    check(auc16 > 0.9, f"bf16 explanation AUC {auc16} <= 0.9")
    for k in ("spmm_bcsr", "sddmm_bcsr"):
        check(bf16_launches[k] > 0, f"bf16 explanation did not launch {k}")
    banded = phase_explain_banded(gen)

    # ---- phase 4: low-locality training in every static-weight format
    print("phase lowloc", flush=True)
    low = {}
    phase_lowloc(low, gen)
    low = low["lowloc"]
    dtypes = dtype_cases(low["graph"])

    # ---- phase 5: diffusion on the power-law graph
    print("phase diffuse", flush=True)
    t0 = time.perf_counter()
    diff = phase_diffuse(low.pop("graph"))
    print(f"  diffuse phase {time.perf_counter() - t0:.1f} s", flush=True)

    # checkpoints the baselines phase reads, from the coo, syn and graph phases
    keep_dir = tempfile.TemporaryDirectory()
    keep = keep_dir.name

    # ---- phase 6: the COO main path and the node CLI
    print("phase coo", flush=True)
    t0 = time.perf_counter()
    coo = phase_coo(banded["steps_per_s"]["f32"], keep)
    print(f"  coo phase {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 7: syn2-syn5, attention and batch norm through the CLI
    print("phase syn", flush=True)
    t0 = time.perf_counter()
    syn = phase_syn(gen, keep)
    print(f"  syn phase {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 8: graph classification and graph-mode explanation
    print("phase graph", flush=True)
    t0 = time.perf_counter()
    graph = phase_graph(gen, keep)
    print(f"  graph phase {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 9: optimizers, schedules and --resume through the CLI
    print("phase opt", flush=True)
    t0 = time.perf_counter()
    opt = phase_opt(keep)
    print(f"  opt phase {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 10: the grad/att baselines and the alignment
    print("phase baselines", flush=True)
    t0 = time.perf_counter()
    base_ph = phase_baselines(keep)
    print(f"  baselines phase {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 11: the remaining tasks (--pkl, ppi, enron) through the CLI
    print("phase tasks", flush=True)
    t0 = time.perf_counter()
    tasks_ph = phase_tasks()
    print(f"  tasks phase {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 12: the multi-device paths at the card's one rank
    print("phase parallel", flush=True)
    par = phase_parallel(gen, low["tiles_epochs_per_s"])

    # ---- phase 13: query sharding and tensor parallelism at the one rank
    print("phase mesh", flush=True)
    mesh_ph = phase_mesh(gen, keep)
    keep_dir.cleanup()

    # ---- phase 14: a torch.profiler trace of the host dispatch
    print("phase profile", flush=True)
    t0 = time.perf_counter()
    prof_ph = phase_profile(gen)
    print(f"  profile phase {time.perf_counter() - t0:.1f} s", flush=True)
    print("renders " + json.dumps(RENDERS), flush=True)

    # ---- phase 15: launch probes
    print("phase launch_probes", flush=True)
    probes = phase_probes(gen)

    # ---- report
    paths = {"train": train_launches, "explain": explain_launches,
             "explain_bf16": bf16_launches,
             **{f"explain_banded_{k}": c for k, c in banded["launches"].items()},
             **coo["launches"], **syn["launches"], **graph["launches"],
             **opt["launches"], **base_ph["launches"], **tasks_ph["launches"],
             **prof_ph["launches"], **par["launches"], **mesh_ph["launches"],
             **{f"lowloc_{f}": c for f, c in low["launches"].items()},
             **diff["launches"], "launch_probes": probes["launches"]}
    meta = {
        "spmm_bcsr": ("tpugraph_torch/csrc/bcsr_kernels.cu",
                      "tpugraph/ops/pallas_spmm.py:98", shapes[1]["spmm_bcsr"],
                      [sh["spmm_bcsr"] for sh in shapes] + [low["shapes"]["tiles"],
                       banded["shapes"]["spmm_bcsr"]] + dtypes["spmm_bcsr"]
                      + b1_mixed["spmm_bcsr"] + syn["shapes"]["spmm_bcsr"]
                      + graph["shapes"]["spmm_bcsr"] + par["shapes"]["spmm_bcsr"]
                      + mesh_ph["shapes"]["spmm_bcsr"]),
        "sddmm_bcsr": ("tpugraph_torch/csrc/bcsr_kernels.cu",
                       "tpugraph/ops/pallas_spmm.py:175", shapes[1]["sddmm_bcsr"],
                       [sh["sddmm_bcsr"] for sh in shapes]
                       + [banded["shapes"]["sddmm_bcsr"]] + b2_mixed
                       + syn["shapes"]["sddmm_bcsr"] + graph["shapes"]["sddmm_bcsr"]
                       + par["shapes"]["sddmm_bcsr"] + mesh_ph["shapes"]["sddmm_bcsr"]),
        "spmm_bcsr_packed": ("tpugraph_torch/csrc/bcsr_kernels.cu",
                             "tpugraph/ops/pallas_spmm.py:312",
                             low["shapes"]["k_pack4"],
                             [low["shapes"]["k_pack4"]] + dtypes["spmm_bcsr_packed"]
                             + b1_mixed["spmm_bcsr_packed"]),
        "spmm_stacked_resident": (
            "tpugraph_torch/csrc/resident_kernels.cu",
            "tpugraph/ops/pallas_resident.py:281", low["shapes"]["resident"],
            [low["shapes"]["resident"]] + low["variants"][:4] + [low["variants"][5]]
            + coo["shapes"]["spmm_stacked_resident"]
            + syn["shapes"]["spmm_stacked_resident"]),
        "spmm_pair_resident": ("tpugraph_torch/csrc/resident_kernels.cu",
                               "tpugraph/ops/pallas_resident.py:476",
                               diff["spmm_pair_resident"][0],
                               diff["spmm_pair_resident"]),
        "spmm_power_resident": ("tpugraph_torch/csrc/resident_kernels.cu",
                                "tpugraph/ops/pallas_resident.py:622",
                                diff["spmm_power_resident"][0],
                                diff["spmm_power_resident"]),
        "spmm_packets": ("tpugraph_torch/csrc/packets_kernels.cu",
                         "tpugraph/ops/pallas_packets.py:146",
                         low["shapes"]["packets"],
                         [low["shapes"]["packets"], low["variants"][4]]
                         + coo["shapes"]["spmm_packets"]),
    }
    for name, rec in probes["kernels"].items():
        meta[name] = ("tpugraph_torch/csrc/probe_kernels.cu",
                      "bench_palcall_diag.py:71" if name == "probe_tiny"
                      else "bench_palcall_diag.py:104", rec, rec.pop("shapes"))
    extras = {
        "spmm_stacked_resident": {"resident_ablation": low["resident_ablation"],
                                  "ablation_replaces": "bench_resident_diag2.py:105 "
                                  "(D1), bench_resident_diag3.py:63 (D4)"},
        "probe_tiny": {"launch_probes": probes["record"]},
        "sddmm_bcsr": {"crossover": {d: bk.sddmm_crossover(d) for d in crossover},
                       "crossover_measured": crossover},
        "spmm_bcsr": {"crossover_measured": b1_cross, "b1_vs_b4": dtypes["b1_vs_b4"]},
        "spmm_packets": {
            "reduce_launches": sum(c["spmm_packets_reduce"] for c in paths.values()),
            "packets_ablation": low["packets_ablation"]},
    }
    report = []
    for name, (src, replaces, main_shape, all_shapes) in meta.items():
        by_path = {p: c[name] for p, c in paths.items() if c[name]}
        check(sum(by_path.values()) > 0, f"{name} was never launched on its path")
        report.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **{k: main_shape[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by", "library_ms")},
            **({"library_null_reason": main_shape["library_null_reason"]}
               if "library_null_reason" in main_shape else {}),
            "shapes": all_shapes,
            **extras.get(name, {}),
        })
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
