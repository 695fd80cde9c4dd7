"""Synthetic datasets (port of ``tpugraph/data``; syn1 so far)."""

from tpugraph_torch.data.featgen import ConstFeatureGen  # noqa: F401
from tpugraph_torch.data.gengraph import (  # noqa: F401
    gen_syn1,
    perturb,
    preprocess_input_graph,
)
from tpugraph_torch.data.shapes import SimpleGraph, build_graph  # noqa: F401
