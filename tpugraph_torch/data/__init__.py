"""Datasets (port of ``tpugraph/data``): syn1–syn5, the TU-format reader
and the graph-classification batching pipeline."""

from tpugraph_torch.data.featgen import (  # noqa: F401
    ConstFeatureGen,
    GaussianFeatureGen,
    GridFeatureGen,
)
from tpugraph_torch.data.gengraph import (  # noqa: F401
    GENERATORS,
    gen_syn1,
    gen_syn2,
    gen_syn3,
    gen_syn4,
    gen_syn5,
    join_graph,
    perturb,
    preprocess_input_graph,
)
from tpugraph_torch.data.shapes import SimpleGraph, build_graph  # noqa: F401
from tpugraph_torch.data.pipeline import (  # noqa: F401
    DenseGraphBatch,
    GraphBatcher,
    prepare_data,
)
from tpugraph_torch.data.readers import LabeledGraph, read_graphfile  # noqa: F401
