"""Synthetic datasets (port of ``tpugraph/data``: syn1–syn5)."""

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
