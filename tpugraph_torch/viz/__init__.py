"""Visualization helpers (port of ``tpugraph/viz``): so far only the mask
thresholding that the alignment experiment reads; rendering is not
ported yet (ROADMAP section 1 item 10)."""

from tpugraph_torch.viz.graphs import denoise_graph  # noqa: F401
