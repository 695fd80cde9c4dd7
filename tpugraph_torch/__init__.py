"""tpugraph_torch — the PyTorch/CUDA port of ``tpugraph/__init__.py``.

The same GNN training + GNNExplainer system as ``tpugraph``, written for
an NVIDIA H100: plain tensor code is PyTorch, and every Pallas TPU kernel
on a ported path is a hand-written CUDA C++ kernel for ``sm_90a``
(``tpugraph_torch/csrc``), built with ``nvcc`` at first use.

The package imports ``torch`` and never ``jax`` or ``tpugraph``: the
host-side numpy code it needs from ``tpugraph`` is carried over, not
imported.  Entry points take ``device=None``, meaning CUDA; without a
card they raise unless the caller passes ``device="cpu"``.

Ported so far: syn1 generation, the COO message-passing ops and the BCSR
layout, ``GcnEncoderNode`` on ``SparseAdj`` and ``BCSRAdj``, full-batch
node training on COO and in every static-weight format, the checkpoint +
cg bundle, the batched COO GNNExplainer and the tile-space one (with bf16
kernel tiles) and their motif AUC, graph diffusion
(``ops.DiffusionOperator``, ``ops.diffuse``), the node CLI
(``python -m tpugraph_torch.cli.train`` / ``.explain``, syn1–syn5), and
graph classification on TU-format datasets (the reader, the batching
pipeline, ``GcnEncoderGraph``, the DiffPool ``SoftPoolingGcnEncoder``,
``train_graph_classifier``, ``--bmname``) with its graph-mode explainer
on COO and on the tile kernels; every optimizer chain and schedule of
``tpugraph`` with ``--resume``, the grad/att baselines, representer
scores, ``denoise_graph`` and the explanation alignment; the TensorBoard
event writer, the profiling helpers and every figure ``tpugraph`` draws
(``utils``, ``viz``); and the ``--pkl``, ppi_essential, enron,
enron_multigraph and cross-validated tasks.  Not ported: the
multi-device paths and the native graph engine.
"""

__version__ = "0.1.0"

from tpugraph_torch._device import default_device  # noqa: F401
from tpugraph_torch.core.graph import Graph  # noqa: F401
