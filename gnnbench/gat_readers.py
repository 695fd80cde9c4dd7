"""The arithmetic of the GAT cells' per-layer metrics (``.gat``), over the
traced job of ``gnnbench/drivers/train_gat.py:traced`` and the program's
spans (``train_epoch``, ``train.optimizer``, ``nn.attention`` and
``nn.attention.backward``; :mod:`gnnbench.spans`).  A metric whose spans
the program does not carry reads ``None``."""

from __future__ import annotations

from gnnbench import gat_counts, peaks, spans
from gnnbench.spans import under

ATTENTION = ("nn.attention", "nn.attention.backward")


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
    """The GAT model operations of the traced job (every epoch and the
    closing evaluation's forward, :mod:`gnnbench.gat_counts`) over its
    wall time, in % of the chip's float32 peak."""
    jobs = ctx.get("jobs") or []
    if not jobs or "gat_layers" not in ctx:
        return None
    n, e, dims = ctx["num_nodes"], ctx["attended_edges"], ctx["gat_layers"]
    flops = sum(j["epochs"] * gat_counts.epoch_flops(n, e, dims)
                + gat_counts.forward_flops(n, e, dims) for j in jobs)
    return 100.0 * flops / sum(j["wall_s"] for j in jobs) / peaks.F32_FLOPS


def attention_ms_per_epoch(ctx):
    """Device ms an epoch launched under ``nn.attention*`` within
    ``train_epoch``."""
    ops = _ops(ctx)
    if ops is None or not _carries(ops, *ATTENTION):
        return None
    dev_s = spans.seconds(ops, lambda p: under(p, "train_epoch") and under(p, *ATTENTION))
    return 1e3 * dev_s / ctx["traced_epochs"]


def _roofline(ctx, span: str, backward: bool):
    ops = _ops(ctx)
    if ops is None or "gat_layers" not in ctx:
        return None
    dev_s = spans.seconds(ops, lambda p: under(p, span))
    if dev_s <= 0:
        return None
    epochs = ctx["traced_epochs"]
    calls = epochs if backward else epochs + 1  # the closing evaluation's forward
    least = gat_counts.attention_least_seconds(ctx["num_nodes"], ctx["attended_edges"],
                                               ctx["gat_layers"], calls, backward)
    return 100.0 * least / dev_s


def attention_roofline(ctx):
    """The attention forwards' least time (every epoch's and the closing
    evaluation's) over the device time launched under ``nn.attention``, in
    %: the scores, the softmax and the weighted sum, whatever kernels
    ran them."""
    return _roofline(ctx, "nn.attention", backward=False)


def attention_backward_roofline(ctx):
    """The attention backwards' least time over the device time launched
    under ``nn.attention.backward``, in %."""
    return _roofline(ctx, "nn.attention.backward", backward=True)


def dense_ms_per_epoch(ctx):
    """Device ms an epoch launched under ``train_epoch`` but under neither
    ``nn.attention*`` nor ``train.optimizer``: the GEMMs, batch norm,
    activations, residual adds, the loss and the metrics."""
    ops = _ops(ctx)
    if ops is None or not (_carries(ops, *ATTENTION) and _carries(ops, "train.optimizer")):
        return None
    dev_s = spans.seconds(ops, lambda p: under(p, "train_epoch") and not under(
        p, *ATTENTION, "train.optimizer"))
    return 1e3 * dev_s / ctx["traced_epochs"]
