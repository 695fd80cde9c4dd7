"""Smoke test of the PyTorch/CUDA port (``tpugraph_torch``) on one NVIDIA card.

Run from the repository root:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``tpugraph_torch/csrc`` (nvcc,
sm_90a), then:

1. kernels — holds each kernel (B1 ``spmm_bcsr``, B2 ``sddmm_bcsr``) against
   its plain PyTorch version on the card at the syn1 shapes of the main path
   (768 nodes, D = 10 and 20) and at a scaled shape (a seeded banded graph,
   65,536 nodes, +-1,024 band, 16 neighbours a node, D = 128), and times the
   kernel, the plain version and, where one exists, a single PyTorch library
   call computing the same function (a yardstick only; the port never calls
   it);
2. train — ``train_node_classifier`` on syn1 (seed 0) at its published widths
   (10 -> 20 -> 20 -> 20, 3 GraphConv layers, 4 classes), 1000 epochs on the
   BCSR path; first holds 20 epochs on the card against the CPU run from the
   same initial parameters;
3. explain — writes and reloads the checkpoint, then ``explain_nodes_bcsr``
   on five house nodes and the motif AUC.

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
EPOCHS = 1000
EXPLAIN_NODES = list(range(400, 700, 60))


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


def measure_kernels(shape_name, m, d, gen, kernels_mod):
    """Both kernels against their plain versions on one shape."""
    import torch

    dev = m.tiles.device
    x = torch.randn((m.num_nodes, d), generator=gen, device=dev)
    dy = torch.randn((m.num_row_nodes, d), generator=gen, device=dev)
    nnz = int((m.tiles != 0).sum())
    t, b = m.num_tiles, m.block
    max_row_tiles = int((m.row_ptr[1:] - m.row_ptr[:-1]).max())
    idx_bytes = 4 * (m.col_blk.numel() + m.row_ptr.numel() + m.row_of.numel())
    out = {}
    cases = {
        "spmm_bcsr": dict(
            run=lambda: kernels_mod.spmm_bcsr(m, x),
            plain=lambda: kernels_mod.spmm_bcsr_plain(m, x),
            library=lambda: library_spmm(m, x),
            k=max_row_tiles * b,
            bytes=4 * (t * b * b + m.num_nodes * d + m.num_row_nodes * d) + idx_bytes,
        ),
        "sddmm_bcsr": dict(
            run=lambda: kernels_mod.sddmm_bcsr(m, dy, x),
            plain=lambda: kernels_mod.sddmm_bcsr_plain(m, dy, x),
            library=lambda: library_sddmm(m, dy, x),
            k=d,
            bytes=4 * (2 * t * b * b + m.num_nodes * d + m.num_row_nodes * d) + idx_bytes,
        ),
    }
    for name, c in cases.items():
        got = c["run"]()
        ref = c["plain"]()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tol = 1e-5 * float(ref.abs().max()) * math.sqrt(c["k"])
        check(err <= tol, f"{name} on {shape_name} D={d}: max |err| {err} > {tol}")
        t_bytes = c["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = 2.0 * nnz * d / F32_FLOPS_PER_S * 1e3
        try:
            lib = c["library"]()
            lib_ms = time_ms(lib)
        except (RuntimeError, NotImplementedError) as e:
            print(f"  {name}: library call unsupported here ({type(e).__name__}: "
                  f"{str(e).splitlines()[0][:120]})")
            lib_ms = None
        rec = {
            "shape": shape_name, "d": d, "tiles": t, "nnz": nnz,
            "max_abs_err": err, "tol": tol,
            "ms": time_ms(c["run"]), "plain_ms": time_ms(c["plain"]),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
        }
        print(f"  {name:10s} {shape_name:6s} D={d:<3d} T={t:<5d} nnz={nnz:<8d} "
              f"kernel_ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
              f"library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)} "
              f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) "
              f"max_abs_err={err:.3g} tol={tol:.3g}", flush=True)
        out[name] = rec
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    from tpugraph_torch.core import graph_from_edge_list
    from tpugraph_torch.data import gen_syn1, preprocess_input_graph
    from tpugraph_torch.explain import Explainer, explanation_auc
    from tpugraph_torch.nn import GcnEncoderNode
    from tpugraph_torch.ops import bcsr, bcsr_kernels
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
    build_s = bcsr_kernels.build_kernels()
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
    shapes = [measure_kernels("syn1", m_syn1, d, gen, bcsr_kernels)
              for d in (10, 20)]
    t0 = time.perf_counter()
    bs, br, bw = banded_edges(65536, 1024, 16, seed=0)
    m_big = bcsr.bcsr_from_coo(bs, br, bw, 65536).to(dev)
    print(f"  scaled graph: {bs.size} edges, {m_big.num_tiles} tiles "
          f"({m_big.num_tiles * 128 * 128 * 4 / 1e9:.2f} GB), packed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    shapes.append(measure_kernels("scaled", m_big, 128, gen, bcsr_kernels))
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
    bcsr_kernels.reset_launch_counts()
    out = train_node_classifier(model, g, feat, labels,
                                TrainConfig(num_epochs=EPOCHS))
    train_launches = dict(bcsr_kernels.LAUNCHES)
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
    bcsr_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    results = ex.explain_nodes_bcsr(EXPLAIN_NODES)
    torch.cuda.synchronize()
    explain_s = time.perf_counter() - t0
    explain_launches = dict(bcsr_kernels.LAUNCHES)
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

    # ---- report
    meta = {
        "spmm_bcsr": ("tpugraph_torch/csrc/bcsr_kernels.cu",
                      "tpugraph/ops/pallas_spmm.py:98"),
        "sddmm_bcsr": ("tpugraph_torch/csrc/bcsr_kernels.cu",
                       "tpugraph/ops/pallas_spmm.py:175"),
    }
    report = []
    for name, (src, replaces) in meta.items():
        main_shape = shapes[1][name]  # syn1, D = 20
        report.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": train_launches[name] + explain_launches[name],
            "launches_train": train_launches[name],
            "launches_explain": explain_launches[name],
            **{k: main_shape[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by", "library_ms")},
            "shapes": [sh[name] for sh in shapes],
        })
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
