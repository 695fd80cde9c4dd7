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
   epochs on the BCSR path; first holds 20 epochs on the card against the
   CPU run from the same initial parameters;
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
6. launch_probes — D3's probes (``bench_palcall_diag.py``): chains of 200
   dependent launches of ``probe_tiny`` (grid 1 and 2) and
   ``probe_resident`` (n = 4,096, 16,384, 65,536), a fit of the time a
   launch against the bytes it writes, and the host cost of one wrapper
   call, printed as ``launch_probes``.

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

import json
import math
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
FORMATS = {  # TrainConfig fields of each static-weight format
    "tiles": {},
    "k_pack4": {"bcsr_k_pack": 4},
    "resident": {"bcsr_resident": "on"},
    "packets": {"bcsr_format": "packets"},
}
FORMAT_KERNEL = {"tiles": "spmm_bcsr", "k_pack4": "spmm_bcsr_packed",
                 "resident": "spmm_stacked_resident", "packets": "spmm_packets"}


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


def measure_spmm(shape, m, x, out_dtype=None):
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
        extra={"tiles": t, "nnz": nnz, **labels, **_branches(m, d)})


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

    from tpugraph_torch.ops import bcsr_kernels as bk

    dev = m.tiles.device
    x = torch.randn((m.num_nodes, d), generator=gen, device=dev)
    dy = torch.randn((m.num_row_nodes, d), generator=gen, device=dev)
    nnz = int((m.tiles != 0).sum())
    t, b = m.num_tiles, m.block
    return {
        "spmm_bcsr": measure_spmm(shape_name, m, x),
        "sddmm_bcsr": measure_case(
            "sddmm_bcsr", shape_name, d, lambda: bk.sddmm_bcsr(m, dy, x),
            lambda: bk.sddmm_bcsr_plain(m, dy, x),
            lambda: library_sddmm(m, dy, x),
            (m.tiles.element_size() + 4) * t * b * b
            + 4 * (m.num_nodes + m.num_row_nodes) * d
            + 4 * (2 * t + m.num_row_blocks + 1),
            2.0 * nnz * d, F32_FLOPS_PER_S, d,
            extra={"tiles": t, "nnz": nnz,
                   "support": str(m.tiles.dtype).split(".")[1]},
            scale=lambda: bk.sddmm_bcsr_plain(m, dy.abs(), x.abs())),
    }


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
    from tpugraph_torch.ops import bcsr, packets
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
        print(f"  reduced {fmt:8s} {REDUCED_NODES} nodes: card vs CPU "
              f"{REDUCED_EPOCHS}-epoch loss max |diff| {diff:.3g}", flush=True)
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
        hist = out["history"]["loss"]
        runs[fmt] = out
        adj = out["adj"]
        if fmt in ("tiles", "k_pack4"):
            size = f"{adj.m.num_tiles} tiles ({adj.m.tiles.numel() * 4 / 1e9:.2f} GB)"
        elif fmt == "resident":
            size = (f"{adj.st.num_tiles} int8 tiles "
                    f"({adj.st.tiles.numel() / 1e9:.2f} GB)")
        else:
            size = f"{adj.p.num_packets} packets of {adj.p.k}"
        print(f"  full {fmt:8s} pack {out['pack_s']:.2f} s, {size} a direction; "
              f"{LOWLOC_EPOCHS / out['elapsed']:.2f} epochs/s; loss "
              f"{hist[0]:.4f} -> {hist[-1]:.4f}; train acc "
              f"{out['result_train']['acc']:.4f} test acc "
              f"{out['result_test']['acc']:.4f}; launches "
              f"{ {k: v for k, v in launches[fmt].items() if v} }", flush=True)
        check(bool(np.all(np.isfinite(hist))) and hist[-1] < hist[0],
              f"{fmt}: losses not finite or not decreasing")
        check(out["ypred"].shape == (1, LOWLOC_NODES, 4)
              and bool(np.all(np.isfinite(out["ypred"]))),
              f"{fmt}: bad predictions")
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
        else:
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
        out.pop("adj")
        del adj
        torch.cuda.empty_cache()
    print(f"  H100 format-rule rates (fwd+bwd SpMM pair at D={LOWLOC_D}; pack "
          f"of A and A^T incl. upload, over A's tiles / edges): "
          f"{json.dumps({**res_rates, **pkt_rates})}", flush=True)
    print(f"  full-size phase {time.perf_counter() - t0:.1f} s", flush=True)
    report["lowloc"] = {"launches": launches, "shapes": shapes,
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
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
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
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    build_s = build_kernels()
    print(f"kernel build: {build_s:.2f} s")

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
    short = TrainConfig(num_epochs=20)
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
                                TrainConfig(num_epochs=EPOCHS))
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

    # ---- phase 6: launch probes
    print("phase launch_probes", flush=True)
    probes = phase_probes(gen)

    # ---- report
    paths = {"train": train_launches, "explain": explain_launches,
             "explain_bf16": bf16_launches,
             **{f"explain_banded_{k}": c for k, c in banded["launches"].items()},
             **{f"lowloc_{f}": c for f, c in low["launches"].items()},
             **diff["launches"], "launch_probes": probes["launches"]}
    meta = {
        "spmm_bcsr": ("tpugraph_torch/csrc/bcsr_kernels.cu",
                      "tpugraph/ops/pallas_spmm.py:98", shapes[1]["spmm_bcsr"],
                      [sh["spmm_bcsr"] for sh in shapes] + [low["shapes"]["tiles"],
                       banded["shapes"]["spmm_bcsr"]] + dtypes["spmm_bcsr"]
                      + b1_mixed["spmm_bcsr"]),
        "sddmm_bcsr": ("tpugraph_torch/csrc/bcsr_kernels.cu",
                       "tpugraph/ops/pallas_spmm.py:175", shapes[1]["sddmm_bcsr"],
                       [sh["sddmm_bcsr"] for sh in shapes]
                       + [banded["shapes"]["sddmm_bcsr"]] + b2_mixed),
        "spmm_bcsr_packed": ("tpugraph_torch/csrc/bcsr_kernels.cu",
                             "tpugraph/ops/pallas_spmm.py:312",
                             low["shapes"]["k_pack4"],
                             [low["shapes"]["k_pack4"]] + dtypes["spmm_bcsr_packed"]
                             + b1_mixed["spmm_bcsr_packed"]),
        "spmm_stacked_resident": (
            "tpugraph_torch/csrc/resident_kernels.cu",
            "tpugraph/ops/pallas_resident.py:281", low["shapes"]["resident"],
            [low["shapes"]["resident"]] + low["variants"][:4] + [low["variants"][5]]),
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
                         [low["shapes"]["packets"], low["variants"][4]]),
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
