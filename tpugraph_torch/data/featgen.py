"""Port of ``tpugraph/data/featgen.py`` (``ConstFeatureGen`` only)."""

from __future__ import annotations

import numpy as np

from tpugraph_torch.data.shapes import SimpleGraph


class ConstFeatureGen:
    """The same feature vector for every node
    (``tpugraph/data/featgen.py:24``)."""

    def __init__(self, val):
        self.val = val

    def gen_node_features(self, G: SimpleGraph) -> None:
        feat = np.array(self.val, dtype=np.float32)
        G.feat = {u: feat.copy() for u in G.nodes()}
