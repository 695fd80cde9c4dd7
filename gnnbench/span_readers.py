"""The arithmetic of the per-layer metrics that read the program's own
spans (``train_epoch``, ``train.optimizer``, ``nn.aggregate`` and
``nn.aggregate.backward``), over the traced job's device time attributed
to them by launch (:mod:`gnnbench.spans`).  Each comes once for each
family of cells (``.bcsr``, ``.coo``); ``ctx`` is the traced context
that ``gnnbench/drivers/train_node.py:traced`` returns.  A metric whose
spans the program does not carry reads ``None``."""

from __future__ import annotations

from gnnbench import readers, spans
from gnnbench.spans import AGGREGATE, under


def _ops(ctx):
    """The traced job's device operations with their paths, or ``None``
    where the run has no trace or no epochs.  The attribution is made once
    and kept in ``ctx``, which every reader of the run is handed."""
    tr = ctx.get("trace")
    if tr is None or not ctx.get("traced_epochs"):
        return None
    if "span_paths" not in ctx:
        ctx["span_paths"] = spans.attributed(tr)
    return ctx["span_paths"]


def _carries(ops, *names) -> bool:
    return any(under(path, *names) for _, path in ops)


def product_roofline(ctx):
    """The traced job's adjacency products' least time
    (:func:`gnnbench.readers.least_seconds`) over the device time launched
    under ``nn.aggregate`` and ``nn.aggregate.backward``, in %: every
    operation of every product, forward and backward, the closing
    evaluation's too, whatever its kernels' names."""
    ops = _ops(ctx)
    if ops is None:
        return None
    dev_s = spans.seconds(ops, lambda p: under(p, *AGGREGATE))
    if dev_s <= 0:
        return None
    m = ctx["model"]
    widths = readers.product_widths(m["layer_inputs"], ctx["traced_epochs"])
    return 100.0 * readers.least_seconds(ctx["num_nodes"], ctx["nnz"], widths) / dev_s


def product_ms_per_epoch(ctx):
    """Device ms an epoch launched under ``nn.aggregate*`` within
    ``train_epoch``."""
    ops = _ops(ctx)
    if ops is None or not _carries(ops, *AGGREGATE):
        return None
    dev_s = spans.seconds(ops, lambda p: under(p, "train_epoch")
                          and under(p, *AGGREGATE))
    return 1e3 * dev_s / ctx["traced_epochs"]


def dense_ms_per_epoch(ctx):
    """Device ms an epoch launched under ``train_epoch`` but under neither
    ``nn.aggregate*`` nor ``train.optimizer``: the dense transforms, batch
    norm, normalisation, activations, the loss and the metrics."""
    ops = _ops(ctx)
    if ops is None or not (_carries(ops, *AGGREGATE)
                           and _carries(ops, "train.optimizer")):
        return None
    dev_s = spans.seconds(ops, lambda p: under(p, "train_epoch") and not under(
        p, *AGGREGATE, "train.optimizer"))
    return 1e3 * dev_s / ctx["traced_epochs"]


def optimizer_ms_per_epoch(ctx):
    """Device ms an epoch launched under ``train.optimizer`` (the clip,
    the decay and Adam)."""
    ops = _ops(ctx)
    if ops is None or not _carries(ops, "train.optimizer"):
        return None
    return 1e3 * spans.seconds(ops, lambda p: under(p, "train.optimizer")) \
        / ctx["traced_epochs"]


def loop_idle_share(ctx):
    """The share (%) of the device window of the epoch loop, from the first
    operation launched under ``train_epoch`` to the end of the last, in
    which none of them ran: packing and evaluation lie outside it."""
    ops = _ops(ctx)
    if ops is None:
        return None
    share = spans.busy_share([(s, e) for (_, s, e), p in ops
                              if under(p, "train_epoch")])
    return None if share is None else 100.0 * (1.0 - share)


def launches_per_epoch(ctx):
    """Device operations (kernels, copies, sets) launched under
    ``train_epoch``, an epoch."""
    ops = _ops(ctx)
    if ops is None:
        return None
    n = sum(1 for _, p in ops if under(p, "train_epoch"))
    return n / ctx["traced_epochs"] if n else None
