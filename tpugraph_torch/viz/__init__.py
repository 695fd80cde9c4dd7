"""Port of ``tpugraph/viz``: mask thresholding, networkx's layouts, the
figure records of every ``tpugraph`` render and the PNG/PDF writers that
draw them."""

from tpugraph_torch.viz.graphs import (denoise_graph, log_graph,  # noqa: F401
                                       save_matrix_image)
