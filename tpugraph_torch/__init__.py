"""tpugraph_torch — the PyTorch/CUDA port of ``tpugraph/__init__.py``.

The same GNN training + GNNExplainer system as ``tpugraph``, written for
an NVIDIA H100: plain tensor code is PyTorch, and every Pallas TPU kernel
on a ported path is a hand-written CUDA C++ kernel for ``sm_90a``
(``tpugraph_torch/csrc``), built with ``nvcc`` at first use.

The package imports ``torch`` and never ``jax`` or ``tpugraph``: the
host-side numpy code it needs from ``tpugraph`` is carried over, not
imported.  Entry points take ``device=None``, meaning CUDA; without a
card they raise unless the caller passes ``device="cpu"``.

Ported so far: syn1 generation, the BCSR layout, ``GcnEncoderNode`` on
``BCSRAdj``, full-batch node training in every static-weight format, the
checkpoint + cg bundle, the tile-space GNNExplainer (with bf16 kernel
tiles) and its motif AUC, and graph diffusion (``ops.DiffusionOperator``,
``ops.diffuse``).
"""

__version__ = "0.1.0"

from tpugraph_torch._device import default_device  # noqa: F401
from tpugraph_torch.core.graph import Graph  # noqa: F401
