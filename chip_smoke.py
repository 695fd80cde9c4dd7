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
   never calls it);
2. train — ``train_node_classifier`` on syn1 (seed 0) at its published
   widths (10 -> 20 -> 20 -> 20, 3 GraphConv layers, 4 classes), 1000
   epochs on the BCSR path; first holds 20 epochs on the card against the
   CPU run from the same initial parameters;
3. explain — writes and reloads the checkpoint, then ``explain_nodes_bcsr``
   on five house nodes and the motif AUC;
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
   (D = 128).  Small-shape variants (B4 with bf16 tiles, stack=2, int4 and
   a bf16 output; B7 with f32 compute) are checked on the reduced graph.

Each phase fails the run if its check fails.  The last two lines are the
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
EPOCHS = 1000
EXPLAIN_NODES = list(range(400, 700, 60))
LOWLOC_NODES, LOWLOC_DEG, LOWLOC_D, LOWLOC_BLOCK = 65536, 32, 128, 256
LOWLOC_EPOCHS = 100
REDUCED_NODES, REDUCED_BLOCK, REDUCED_EPOCHS = 4096, 128, 10
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
    """One PyTorch call for y = A @ x: a BSR sparse tensor times x."""
    import torch

    a = torch.sparse_bsr_tensor(m.row_ptr, m.col_blk, m.tiles,
                                size=(m.num_row_nodes, m.num_nodes))
    return lambda: a @ x


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
    """One PyTorch call for B4's function: a BSR tensor of the widened
    stack=1 tiles (all-zero padding stacks dropped) times the
    bf16-rounded x."""
    import torch

    from tpugraph_torch.ops.resident_kernels import widen_tiles

    tiles = widen_tiles(st)
    live = (tiles != 0).flatten(1).any(1)
    rows = st.rows.long()[live]
    order = torch.argsort(rows * (st.num_nodes // st.block)
                          + st.col_blk.long()[live])
    crow = torch.zeros(st.num_row_blocks + 1, dtype=torch.int64,
                       device=x.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=st.num_row_blocks), 0)
    a = torch.sparse_bsr_tensor(crow, st.col_blk.long()[live][order],
                                tiles[live][order],
                                size=(st.num_row_nodes, st.num_nodes))
    xr = x.to(torch.bfloat16).float()
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
                 tol_k, bf16_out=False, extra=None):
    """One kernel against its plain version on one input: max |err| within
    ``1e-5 * max|ref| * sqrt(tol_k)`` (f32 sums in another order; plus
    one bf16 rounding for a bf16 output), then kernel, plain and library
    times and the bound, the larger of bytes over HBM rate and ``ops``
    over ``peak``."""
    import torch

    got = run()
    ref = plain()
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    tol = 1e-5 * scale * math.sqrt(tol_k) + (BF16_REL * scale if bf16_out else 0.0)
    check(err <= tol, f"{name} on {shape} D={d}: max |err| {err} > {tol}")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    try:
        lib_ms = time_ms(library()) if library is not None else None
    except (RuntimeError, NotImplementedError) as e:
        print(f"  {name}: library call unsupported here ({type(e).__name__}: "
              f"{str(e).splitlines()[0][:120]})")
        lib_ms = None
    torch.cuda.empty_cache()
    rec = {
        "shape": shape, "d": d, **(extra or {}),
        "max_abs_err": err, "tol": tol,
        "ms": time_ms(run), "plain_ms": time_ms(plain),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
    }
    torch.cuda.empty_cache()
    extra_s = " ".join(f"{k}={v}" for k, v in (extra or {}).items())
    print(f"  {name:21s} {shape:16s} D={d:<3d} {extra_s} "
          f"kernel_ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
          f"library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)} "
          f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) "
          f"max_abs_err={err:.3g} tol={tol:.3g}", flush=True)
    return rec


def measure_spmm(shape, m, x):
    """B1 against its plain version on one BCSR."""
    from tpugraph_torch.ops import bcsr_kernels as bk

    t, b, d = m.num_tiles, m.block, x.shape[1]
    nnz = int((m.tiles != 0).sum())
    max_row_tiles = int((m.row_ptr[1:] - m.row_ptr[:-1]).max())
    return measure_case(
        "spmm_bcsr", shape, d, lambda: bk.spmm_bcsr(m, x),
        lambda: bk.spmm_bcsr_plain(m, x), lambda: library_spmm(m, x),
        4 * t * b * b + 4 * (m.num_nodes + m.num_row_nodes) * d
        + 4 * (2 * t + m.num_row_blocks + 1),
        2.0 * nnz * d, F32_FLOPS_PER_S, max_row_tiles * b,
        extra={"tiles": t, "nnz": nnz})


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
            4 * 2 * t * b * b + 4 * (m.num_nodes + m.num_row_nodes) * d
            + 4 * (2 * t + m.num_row_blocks + 1),
            2.0 * nnz * d, F32_FLOPS_PER_S, d,
            extra={"tiles": t, "nnz": nnz}),
    }


def measure_packed(shape, m, k_pack, x):
    """B3 against its plain version on a k_pack-padded BCSR."""
    from tpugraph_torch.ops import bcsr_kernels as bk

    t, b, d = m.num_tiles, m.block, x.shape[1]
    nnz = int((m.tiles != 0).sum())
    max_row_tiles = int((m.row_ptr[1:] - m.row_ptr[:-1]).max())
    return measure_case(
        "spmm_bcsr_packed", shape, d, lambda: bk.spmm_bcsr_packed(m, x, k_pack),
        lambda: bk.spmm_bcsr_packed_plain(m, x, k_pack),
        lambda: library_spmm(m, x),
        4 * t * b * b + 4 * (m.num_nodes + m.num_row_nodes) * d
        + 4 * (2 * t + m.num_row_blocks + 1),
        2.0 * nnz * d, F32_FLOPS_PER_S, max_row_tiles * b,
        extra={"tiles": t, "nnz": nnz, "k_pack": k_pack})


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
    out_b = 2 if out_dtype == torch.bfloat16 else 4
    per_rb = int((st.row_ptr[1:] - st.row_ptr[:-1]).max())
    peak = F32_FLOPS_PER_S if st.tiles.dtype == torch.float32 else BF16_FLOPS_PER_S
    kind = "int4" if st.packed4 else str(st.tiles.dtype).split(".")[1]
    return measure_case(
        "spmm_stacked_resident", shape, d,
        lambda: rk.spmm_stacked_resident(st, x, out_dtype=out_dtype),
        lambda: rk.spmm_stacked_resident_plain(st, x, out_dtype),
        (lambda: library_stacked(st, x)) if st.stack == 1 else None,
        tile_bytes + 4 * st.num_nodes * d + out_b * st.num_row_nodes * d
        + 4 * (st.num_tiles + 2 * n_slices + st.num_row_blocks + 1),
        2.0 * nnz * d, peak, per_rb * st.block,
        bf16_out=out_dtype == torch.bfloat16,
        extra={"tiles": st.num_tiles, "stack": st.stack, "tile": kind,
               "out": "bf16" if out_b == 2 else "f32", "nnz": nnz})


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
               "heaviest_block_share": round(hub, 4)})


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
            pair_ms = time_ms(lambda: (rk.spmm_stacked_resident(adj.st, x),
                                       rk.spmm_stacked_resident(adj.st_t, x)))
            res_rates = {"res_edges_per_s": n_live / (pair_ms / 1e3),
                         "res_pack_s_per_tile": out["pack_s"] / adj.st.num_tiles}
        else:
            shapes[fmt] = measure_packets(shape, adj.p, x, torch.bfloat16)
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
                        "variants": variants}


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

    # ---- phase 4: low-locality training in every static-weight format
    print("phase lowloc", flush=True)
    low = {}
    phase_lowloc(low, gen)
    low = low["lowloc"]

    # ---- report
    paths = {"train": train_launches, "explain": explain_launches,
             **{f"lowloc_{f}": c for f, c in low["launches"].items()}}
    meta = {
        "spmm_bcsr": ("tpugraph_torch/csrc/bcsr_kernels.cu",
                      "tpugraph/ops/pallas_spmm.py:98", shapes[1]["spmm_bcsr"],
                      [sh["spmm_bcsr"] for sh in shapes] + [low["shapes"]["tiles"]]),
        "sddmm_bcsr": ("tpugraph_torch/csrc/bcsr_kernels.cu",
                       "tpugraph/ops/pallas_spmm.py:175", shapes[1]["sddmm_bcsr"],
                       [sh["sddmm_bcsr"] for sh in shapes]),
        "spmm_bcsr_packed": ("tpugraph_torch/csrc/bcsr_kernels.cu",
                             "tpugraph/ops/pallas_spmm.py:312",
                             low["shapes"]["k_pack4"], [low["shapes"]["k_pack4"]]),
        "spmm_stacked_resident": (
            "tpugraph_torch/csrc/resident_kernels.cu",
            "tpugraph/ops/pallas_resident.py:281", low["shapes"]["resident"],
            [low["shapes"]["resident"]] + low["variants"][:3]),
        "spmm_packets": ("tpugraph_torch/csrc/packets_kernels.cu",
                         "tpugraph/ops/pallas_packets.py:146",
                         low["shapes"]["packets"],
                         [low["shapes"]["packets"], low["variants"][3]]),
    }
    report = []
    for name, (src, replaces, main_shape, all_shapes) in meta.items():
        by_path = {p: c[name] for p, c in paths.items() if c[name]}
        report.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **{k: main_shape[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by", "library_ms")},
            "shapes": all_shapes,
        })
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
