"""Graph containers and k-hop extraction (port of ``tpugraph/core``)."""

from tpugraph_torch.core.graph import (  # noqa: F401
    BatchedGraphs,
    Graph,
    batch_graphs,
    graph_from_dense,
    graph_from_edge_list,
    graph_from_edges,
    graph_from_networkx,
    graph_to_dense,
    pad_graph,
)
from tpugraph_torch.core.khop import (  # noqa: F401
    extract_dense_subgraph,
    khop_reachability,
    khop_subgraph,
)
