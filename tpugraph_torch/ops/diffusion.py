"""Port of ``tpugraph/ops/diffusion.py``: graph diffusion
``(S^T S)^H x`` through the fused power kernel B6.

SGC- and APPNP-style models propagate features through the (normalized)
adjacency without nonlinearities between hops, so the whole propagation
is one call of :func:`tpugraph_torch.ops.resident_kernels.spmm_power_resident`
on a pair layout packed once.  Static weights only: precomputed features
for an SGC head, label propagation, spectral smoothing; not training-time
message passing (use ``GraphConv``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpugraph_torch._device import DeviceLike, default_device
from tpugraph_torch.native import sym_normalize
from tpugraph_torch.ops.bcsr import bcsr_from_coo, bcsr_transpose_host
from tpugraph_torch.ops.resident_kernels import (pack_pair, spmm_power_resident,
                                                 stack_bcsr)


class DiffusionOperator:
    """A packed, reusable ``(S^T S)^H`` propagation operator
    (``tpugraph/ops/diffusion.py:30``) on ``device`` (default CUDA).

    ``S`` is the adjacency (row = receiver) packed once into the pair
    layout.  ``normalize=True`` sym-normalizes it into bf16 tiles (the GCN
    propagation matrix; spectral radius <= 1, so ``hop_scale`` is 1).
    ``normalize=False`` keeps the weights, as int8 tiles when every one is
    an integer of magnitude <= 127 and bf16 otherwise, with ``hop_scale =
    1 / m**2`` for ``m`` the largest row sum, to keep the powers inside
    bf16's range.

    ``block`` may be any size on the CPU (the plain versions), as in
    ``tpugraph``'s interpret path.  On the card the tensor-core kernel
    needs ``block % 128 == 0`` for bf16 and int8 tiles (the wrappers raise
    otherwise); 128 and 256 are the sizes in use."""

    def __init__(self, g, block: int = 256, normalize: bool = True,
                 k_pack: int = 128, device: DeviceLike = None):
        dev = default_device(device)
        s = g.senders.numpy()
        r = g.receivers.numpy()
        w = g.edge_weight.numpy().astype(np.float32)
        n = g.num_nodes_padded
        if normalize:
            w = sym_normalize(r, s, w, n)
            tdt = torch.bfloat16
            self.hop_scale = 1.0
        else:
            live = w != 0
            row_sum = np.zeros(n)
            np.add.at(row_sum, r[live], w[live])
            m = float(row_sum.max(initial=1.0))
            integral = bool(np.all(w == np.rint(w))
                            and np.abs(w).max(initial=0) <= 127)
            tdt = torch.int8 if integral else torch.bfloat16
            self.hop_scale = 1.0 / (m * m)
        m_ = bcsr_from_coo(s, r, w, n, block=block, tile_dtype=tdt)
        m_t = bcsr_transpose_host(s, r, w, n, block=block, tile_dtype=tdt)
        self.pair = pack_pair(stack_bcsr(m_, 1, k_pack).to(dev),
                              stack_bcsr(m_t, 1, k_pack).to(dev))
        self.k_pack = k_pack
        self.num_nodes = self.pair.num_nodes

    def __call__(self, x: torch.Tensor, hops: int) -> torch.Tensor:
        """``(hop_scale * S^T S)^hops @ x`` in bf16 for ``x [num_nodes, D]``
        (float32 or bfloat16) on the operator's device."""
        if x.shape[0] != self.num_nodes:
            raise ValueError(f"x must have {self.num_nodes} rows, got "
                             f"{x.shape[0]}")
        return spmm_power_resident(self.pair, x, hops=hops, k_pack=self.k_pack,
                                   hop_scale=self.hop_scale)


def diffuse(g, x: torch.Tensor, hops: int, block: int = 256,
            normalize: bool = True, device: DeviceLike = None) -> torch.Tensor:
    """Pack ``g`` and propagate ``x`` ``hops`` times
    (``tpugraph/ops/diffusion.py:88``): ``x``'s rows are padded to the
    operator's node count and the result cut back to them.  For repeated
    use build a :class:`DiffusionOperator` once.  ``block``: any size on
    the CPU; a multiple of 128 on the card (see :class:`DiffusionOperator`)."""
    op = DiffusionOperator(g, block=block, normalize=normalize, device=device)
    n = x.shape[0]
    x = x.to(op.pair.tiles.device)
    if n < op.num_nodes:
        x = torch.nn.functional.pad(x, (0, 0, 0, op.num_nodes - n))
    return op(x, hops)[:n]
