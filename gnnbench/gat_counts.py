"""The operations and bytes of the GAT cells' model step and attention
kernels, from the configuration's shapes alone (whatever implements them),
for the per-layer metrics of ``gnnbench/gat_readers.py``.

A layer takes ``x [N, D_in]`` to ``H`` heads of ``F`` columns (``D = H
F``) over ``E`` attended edges (self-loops included): the two GEMMs ``x
W`` and ``x W_res``, each node's two scores by head, and the attention,
a softmax over each receiver's in-edges and the weighted sum of the
senders' ``z`` rows."""

from __future__ import annotations

from typing import Dict, List, Tuple

from gnnbench import peaks

Layer = Tuple[int, int, int]  # (D_in, heads, F)


def layers(config: Dict) -> List[Layer]:
    """``(D_in, H, F)`` of each layer of the configuration's model."""
    m = config["model"]
    out, d = [], m["input_dim"]
    for i in range(m["num_layers"]):
        f = m["head_dim"] if i < m["num_layers"] - 1 else m["label_dim"]
        out.append((d, m["num_heads"], f))
        d = m["num_heads"] * f
    return out


def forward_flops(n: int, e: int, dims: List[Layer]) -> int:
    """Model operations of one forward: per layer the two GEMMs ``2 (2 N
    D_in D)``, the scores ``2 (2 N D)`` and the attention's weighted sum
    ``2 E D``."""
    return sum(4 * n * a * h * f + 4 * n * h * f + 2 * e * h * f for a, h, f in dims)


def epoch_flops(n: int, e: int, dims: List[Layer]) -> int:
    """Model operations of one training epoch: the forward; backward both
    GEMMs' weight gradients in every layer and their input gradients in
    every layer but the first (the features need none), the scores'
    gradients, and the attention's ``4 E D`` (``dz = sum alpha g`` and
    ``<g_i, z_j>`` on every edge) in every layer (``z`` needs its gradient
    for ``W``'s)."""
    bwd = 0
    for i, (a, h, f) in enumerate(dims):
        d = h * f
        bwd += 4 * n * a * d + (4 * n * a * d if i else 0) + 8 * n * d + 4 * e * d
    return forward_flops(n, e, dims) + bwd


def attention_bytes(n: int, e: int, h: int, f: int, backward: bool) -> int:
    """Bytes one attention call must move: ``z`` read once, each node's two
    scores, the CSR's column index a edge and row offset a node, and the
    output ``y [N, D]`` with its row statistics ``[N, H]``; backward
    ``z`` and ``g`` read, the scores and the statistics read, and ``dz``
    and both scores' gradients written."""
    d = h * f
    index = 4 * e + 4 * (n + 1)
    if backward:
        return 4 * (2 * n * d + 3 * n * h) + index + 4 * (n * d + 2 * n * h)
    return 4 * (n * d + 2 * n * h) + index + 4 * (n * d + n * h)


def attention_flops(e: int, h: int, f: int, backward: bool) -> int:
    """The attention's operations: ``2 E D`` forward, ``4 E D`` backward."""
    return (4 if backward else 2) * e * h * f


def attention_least_seconds(n: int, e: int, dims: List[Layer], calls: int,
                            backward: bool) -> float:
    """The least time of ``calls`` passes over every layer's attention
    (forward or backward) on the chip: for each layer the larger of its
    bytes over the HBM rate and its operations over the float32 rate."""
    one = sum(max(attention_bytes(n, e, h, f, backward) / peaks.HBM_BYTES,
                  attention_flops(e, h, f, backward) / peaks.F32_FLOPS)
              for _, h, f in dims)
    return calls * one
