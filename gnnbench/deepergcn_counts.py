"""The operations and bytes of the DeeperGCN cells' model step and
softmax-aggregation kernels, from the configuration's shapes alone
(whatever implements them), for the per-layer metrics of
``gnnbench/deepergcn_readers.py``.

The model takes ``x [N, D_in]`` to ``H`` channels by the input linear, runs
``L`` GENConv layers of ``H`` channels over ``E`` attended edges (one
self-loop a node among them), each a softmax aggregation and the linear
``(x + m) W + b``, and maps to ``C`` classes by the head."""

from __future__ import annotations

from typing import Dict, NamedTuple

from gnnbench import peaks


class Dims(NamedTuple):
    d_in: int
    hidden: int
    classes: int
    layers: int


def dims(config: Dict) -> Dims:
    """The configuration's model widths and depth."""
    m = config["model"]
    return Dims(m["input_dim"], m["hidden_dim"], m["label_dim"], m["num_layers"])


def aggregation_flops(e: int, h: int, backward: bool) -> int:
    """One aggregation's operations, 4 an edge and channel either way:
    forward the exp, the sum of the weights and the weighted sum (2);
    backward the difference, the exp and the weighted sum (2)."""
    return 4 * e * h


def aggregation_bytes(n: int, e: int, h: int, backward: bool) -> int:
    """Bytes one aggregation must move: the CSR's column index an edge and
    row offset a node; forward ``x`` read once and ``m`` and ``lse`` written
    once; backward ``x``, ``g`` and ``lse`` read once and ``dx`` written
    once."""
    index = 4 * e + 4 * (n + 1)
    rows = 4 if backward else 3
    return 4 * rows * n * h + index


def forward_flops(n: int, e: int, d: Dims) -> int:
    """Model operations of one forward: the input linear ``2 N D_in H``, per
    layer the linear ``2 N H H`` and the aggregation, and the head ``2 N H
    C``."""
    return (2 * n * d.d_in * d.hidden + 2 * n * d.hidden * d.classes
            + d.layers * (2 * n * d.hidden * d.hidden + aggregation_flops(e, d.hidden, False)))


def epoch_flops(n: int, e: int, d: Dims) -> int:
    """Model operations of one training epoch: the forward; backward every
    linear's weight gradient and every input gradient but the input
    linear's (the features need none), and each aggregation's backward."""
    bwd = (2 * n * d.d_in * d.hidden + 4 * n * d.hidden * d.classes
           + d.layers * (4 * n * d.hidden * d.hidden + aggregation_flops(e, d.hidden, True)))
    return forward_flops(n, e, d) + bwd


def aggregation_least_seconds(n: int, e: int, d: Dims, calls: int, backward: bool) -> float:
    """The least time of ``calls`` passes over every layer's aggregation
    (forward or backward) on the chip: for each layer the larger of its
    bytes over the HBM rate and its operations over the float32 rate."""
    one = max(aggregation_bytes(n, e, d.hidden, backward) / peaks.HBM_BYTES,
              aggregation_flops(e, d.hidden, backward) / peaks.F32_FLOPS)
    return calls * d.layers * one
