"""The arithmetic of the DeeperGCN cells' per-layer metrics (``.deepergcn``),
over the traced job of ``gnnbench/drivers/train_deepergcn.py:traced`` and
the program's spans (``train_epoch``, ``train.optimizer``,
``nn.softmax_aggr`` and ``nn.softmax_aggr.backward``;
:mod:`gnnbench.spans`).  A metric whose spans the program does not carry
reads ``None``."""

from __future__ import annotations

from gnnbench import deepergcn_counts, peaks, spans
from gnnbench.spans import under

AGGR = ("nn.softmax_aggr", "nn.softmax_aggr.backward")


def _ops(ctx):
    """The traced job's device operations with their paths (kept in
    ``ctx``), or ``None`` without a trace or epochs."""
    tr = ctx.get("trace")
    if tr is None or not ctx.get("traced_epochs"):
        return None
    if "span_paths" not in ctx:
        ctx["span_paths"] = spans.attributed(tr)
    return ctx["span_paths"]


def _carries(ops, *names) -> bool:
    return any(under(path, *names) for _, path in ops)


def step_mfu(ctx):
    """The DeeperGCN model operations of the traced job (every epoch and
    the closing evaluation's forward, :mod:`gnnbench.deepergcn_counts`)
    over its wall time, in % of the chip's float32 peak."""
    jobs = ctx.get("jobs") or []
    if not jobs or "deepergcn_dims" not in ctx:
        return None
    n, e, d = ctx["num_nodes"], ctx["attended_edges"], ctx["deepergcn_dims"]
    flops = sum(j["epochs"] * deepergcn_counts.epoch_flops(n, e, d)
                + deepergcn_counts.forward_flops(n, e, d) for j in jobs)
    return 100.0 * flops / sum(j["wall_s"] for j in jobs) / peaks.F32_FLOPS


def softmax_aggr_ms_per_epoch(ctx):
    """Device ms an epoch launched under ``nn.softmax_aggr*`` within
    ``train_epoch``."""
    ops = _ops(ctx)
    if ops is None or not _carries(ops, *AGGR):
        return None
    dev_s = spans.seconds(ops, lambda p: under(p, "train_epoch") and under(p, *AGGR))
    return 1e3 * dev_s / ctx["traced_epochs"]


def _roofline(ctx, span: str, backward: bool):
    ops = _ops(ctx)
    if ops is None or "deepergcn_dims" not in ctx:
        return None
    dev_s = spans.seconds(ops, lambda p: under(p, span))
    if dev_s <= 0:
        return None
    epochs = ctx["traced_epochs"]
    calls = epochs if backward else epochs + 1  # the closing evaluation's forward
    least = deepergcn_counts.aggregation_least_seconds(
        ctx["num_nodes"], ctx["attended_edges"], ctx["deepergcn_dims"], calls, backward)
    return 100.0 * least / dev_s


def softmax_aggr_roofline(ctx):
    """The aggregation forwards' least time (every epoch's and the closing
    evaluation's, every layer's) over the device time launched under
    ``nn.softmax_aggr``, in %."""
    return _roofline(ctx, "nn.softmax_aggr", backward=False)


def softmax_aggr_backward_roofline(ctx):
    """The aggregation backwards' least time over the device time launched
    under ``nn.softmax_aggr.backward``, in %."""
    return _roofline(ctx, "nn.softmax_aggr.backward", backward=True)


def dense_ms_per_epoch(ctx):
    """Device ms an epoch launched under ``train_epoch`` but under neither
    ``nn.softmax_aggr*`` nor ``train.optimizer``: the linears, batch norm,
    activations, residual adds, the loss and the metrics."""
    ops = _ops(ctx)
    if ops is None or not (_carries(ops, *AGGR) and _carries(ops, "train.optimizer")):
        return None
    dev_s = spans.seconds(ops, lambda p: under(p, "train_epoch") and not under(
        p, *AGGR, "train.optimizer"))
    return 1e3 * dev_s / ctx["traced_epochs"]
