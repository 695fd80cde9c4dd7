"""Port of ``tpugraph/data/featgen.py``: node feature generators on
:class:`tpugraph_torch.data.shapes.SimpleGraph`, with the same draws from
the caller's ``numpy.random.Generator``."""

from __future__ import annotations

from typing import Dict, Optional

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


class GaussianFeatureGen:
    """Multivariate-normal features, one draw of all nodes in
    ``G.nodes()`` order (``tpugraph/data/featgen.py:35``)."""

    def __init__(self, mu, sigma, rng: Optional[np.random.Generator] = None):
        self.mu = np.asarray(mu, dtype=np.float64)
        sigma = np.asarray(sigma, dtype=np.float64)
        self.sigma = np.diag(sigma) if sigma.ndim < 2 else sigma
        self.rng = rng or np.random.default_rng()

    def gen_node_features(self, G: SimpleGraph) -> None:
        feat = self.rng.multivariate_normal(
            self.mu, self.sigma, G.number_of_nodes()).astype(np.float32)
        G.feat = {n: feat[i] for i, n in enumerate(G.nodes())}


class GridFeatureGen:
    """``[community, noise]`` features: community ``com_choices[0]`` for
    nodes of degree < 4, else ``com_choices[1]``, and one normal draw a
    node (``tpugraph/data/featgen.py:52``).  Returns the communities."""

    def __init__(self, mu, sigma, com_choices,
                 rng: Optional[np.random.Generator] = None):
        self.mu = mu
        self.sigma = sigma
        self.com_choices = com_choices
        self.rng = rng or np.random.default_rng()

    def gen_node_features(self, G: SimpleGraph) -> Dict[int, float]:
        nodes = G.nodes()
        deg = dict(G.degree())
        degrees = np.array([deg[n] for n in nodes])
        communities = np.where(degrees < 4, self.com_choices[0],
                               self.com_choices[1])
        noise = self.rng.normal(self.mu, self.sigma, len(nodes))
        feats = np.stack([communities, noise], axis=1).astype(np.float32)
        G.feat = {n: feats[i] for i, n in enumerate(nodes)}
        return dict(zip(nodes, communities.tolist()))
