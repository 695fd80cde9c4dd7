"""Graph containers and k-hop extraction (port of ``tpugraph/core``)."""

from tpugraph_torch.core.graph import (  # noqa: F401
    Graph,
    graph_from_dense,
    graph_from_edge_list,
    graph_from_edges,
)
from tpugraph_torch.core.khop import khop_subgraph  # noqa: F401
