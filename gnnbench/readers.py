"""The arithmetic of the per-layer metrics of training cells, which the
readers ``gnnbench/metrics/<metric>.py`` share.  Each metric comes once
for each family of cells whose jobs report one end-to-end rate
(``.bcsr``, ``.coo``); ``ctx`` is the driver's traced context
(``gnnbench/drivers/train_node.py:traced``)."""

from __future__ import annotations

import statistics

from gnnbench import peaks
from gnnbench.trace import matched_device_time

# The hand-written SpMM kernels of the program and torch's gather and
# scatter kernels of its COO path (``index_select``, ``index_add_``, each
# the other's backward), matched by name until the program carries a span
# around its adjacency product.
AGGREGATE_KERNELS = (
    "spmm_packets_kernel", "spmm_packets_reduce_kernel",  # B7
    "spmm_bcsr_kernel",                                   # B1/B3
    "spmm_phase_f32", "spmm_phase_mma",                   # B4
    "indexSelectLargeIndex", "indexSelectSmallIndex",     # COO gather
    "vectorized_gather_kernel",                           # COO gather (torch 2.11)
    "indexFuncLargeIndex", "indexFuncSmallIndex",         # COO index_add_
)


def forward_flops(n: int, nnz: int, dims_in, dims_out, head_in: int, classes: int) -> int:
    """Model operations of one forward: for each layer the adjacency
    product ``2 nnz D_in`` and the dense transform ``2 N D_in D_out``,
    then the head ``2 N F C``."""
    f = sum(2 * nnz * a + 2 * n * a * b for a, b in zip(dims_in, dims_out))
    return f + 2 * n * head_in * classes


def epoch_flops(n: int, nnz: int, dims_in, dims_out, head_in: int, classes: int) -> int:
    """Model operations of one training epoch: the forward; backward the
    transform's weight gradient for every layer, its input gradient and
    the adjacency product for every layer but the first (the input
    features need no gradient), and twice the head's."""
    fwd = forward_flops(n, nnz, dims_in, dims_out, head_in, classes)
    bwd = sum(2 * n * a * b for a, b in zip(dims_in, dims_out))  # weight gradients
    bwd += sum(2 * n * a * b + 2 * nnz * a
               for a, b in zip(dims_in[1:], dims_out[1:]))  # input gradients
    bwd += 4 * n * head_in * classes
    return fwd + bwd


def step_mfu(ctx):
    """The model operations of the traced job (every epoch and the closing
    evaluation's forward) over its wall time, in % of the chip's float32
    peak.  The profiler stretches that wall a little (about 1% on the
    arxiv cells), so the share reads low, never high.  Optimizer, normalisation and activation operations are
    not counted, nor is anything recomputed; the count is the same
    whichever format runs."""
    jobs = ctx.get("jobs") or []
    if not jobs:
        return None
    m = ctx["model"]
    args = (ctx["num_nodes"], ctx["nnz"], m["layer_inputs"], m["layer_outputs"],
            m["head_input"], m["classes"])
    flops = sum(j["epochs"] * epoch_flops(*args) + forward_flops(*args) for j in jobs)
    wall = sum(j["wall_s"] for j in jobs)
    return 100.0 * flops / wall / peaks.F32_FLOPS


def idle_share(ctx):
    """The share (%) of the traced job (graph build, packing, every epoch
    and the closing evaluation, as the end-to-end rate counts them) in
    which no operation ran on the device: ``1 - busy / window``."""
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def product_widths(dims, epochs: int, evals: int = 1):
    """The feature width of every adjacency product of ``epochs`` training
    epochs and ``evals`` evaluation forwards; ``dims`` the layers' input
    widths, first to last (backward has no product for the first layer)."""
    train = list(dims) + list(dims[1:])
    return train * epochs + list(dims) * evals


def least_seconds(num_nodes: int, nnz: int, widths) -> float:
    """The least time of the products of ``widths`` on the chip: for each,
    the larger of its bytes over the HBM rate and its operations over the
    float32 rate.  Bytes: the edge list (sender, receiver, weight: 12
    bytes an edge) read once, ``x [N, D]`` read once, ``y [N, D]`` written
    once; operations ``2 nnz D``."""
    total = 0.0
    for d in widths:
        nbytes = 12 * nnz + 2 * 4 * num_nodes * d
        flops = 2 * nnz * d
        total += max(nbytes / peaks.HBM_BYTES, flops / peaks.F32_FLOPS)
    return total


def aggregate_roofline(ctx):
    """The traced job's adjacency products' least time over the device time
    of the kernels that performed them (``AGGREGATE_KERNELS``), in %.  The
    COO path's scaling of the messages by the edge weights is an
    elementwise kernel that no name singles out, so its time is not
    counted: there the share reads high, never low.  Other gathers (the
    loss's, a few rows) match too; they are small against the products."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    kernel_s = matched_device_time(tr, AGGREGATE_KERNELS)
    if kernel_s <= 0:
        return None
    m = ctx["model"]
    widths = product_widths(m["layer_inputs"], ctx["traced_epochs"])
    return 100.0 * least_seconds(ctx["num_nodes"], ctx["nnz"], widths) / kernel_s


def pack_s(ctx):
    """The median over the traced jobs of the seconds
    ``train_node_classifier`` reports for packing the adjacency and
    uploading it (its ``pack_s``, a host clock around
    ``build_adjacency``).  Every job packs, so it moves the rate."""
    packs = [j["pack_s"] for j in ctx.get("jobs") or [] if j.get("pack_s") is not None]
    return statistics.median(packs) if packs else None
