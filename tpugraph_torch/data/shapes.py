"""Port of ``tpugraph/data/shapes.py`` (the ``ba`` and ``house`` shapes and
``build_graph``), without networkx.

:class:`SimpleGraph` stands in for ``nx.Graph``: an undirected graph
whose node and neighbor dicts keep insertion order, with the same
``edges()`` iteration order as networkx.  ``ba`` reproduces
``nx.barabasi_albert_graph(width, m, seed=int)`` of networkx 3.6.1
exactly — a star on m+1 nodes, then ``_random_subset`` through
``random.Random(seed).choice`` over the repeated-node list, targets added
in set-iteration order — so a seed gives the same graph in both packages.
Randomness otherwise flows through an explicit ``numpy.random.Generator``.
"""

from __future__ import annotations

import math
import random
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


class SimpleGraph:
    """Undirected simple graph with insertion-ordered nodes and neighbors
    (the subset of ``nx.Graph`` the generators use).  ``feat`` holds the
    per-node feature vectors a feature generator attaches."""

    def __init__(self):
        self._adj: Dict[int, Dict[int, None]] = {}
        self.feat: Dict[int, np.ndarray] = {}

    def add_node(self, u: int) -> None:
        if u not in self._adj:
            self._adj[u] = {}

    def add_nodes_from(self, nodes) -> None:
        for u in nodes:
            self.add_node(u)

    def add_edge(self, u: int, v: int) -> None:
        self.add_node(u)
        self.add_node(v)
        self._adj[u][v] = None
        self._adj[v][u] = None

    def add_edges_from(self, edges) -> None:
        for u, v in edges:
            self.add_edge(u, v)

    def has_edge(self, u: int, v: int) -> bool:
        return u in self._adj and v in self._adj[u]

    def nodes(self) -> List[int]:
        return list(self._adj)

    def number_of_nodes(self) -> int:
        return len(self._adj)

    def number_of_edges(self) -> int:
        return sum(1 for _ in self.edges())

    def degree(self) -> Iterator[Tuple[int, int]]:
        for u, nbrs in self._adj.items():
            yield u, len(nbrs) + (1 if u in nbrs else 0)

    def edges(self) -> Iterator[Tuple[int, int]]:
        """Each undirected edge once, in networkx's ``Graph.edges()``
        order: by node, then by neighbor insertion, skipping neighbors
        already visited."""
        seen = set()
        for u, nbrs in self._adj.items():
            for v in nbrs:
                if v not in seen:
                    yield u, v
            seen.add(u)

    def copy(self) -> "SimpleGraph":
        """``nx.Graph.copy``: nodes in order, then every adjacency entry
        re-added (which fixes the neighbor order networkx's copy has)."""
        h = SimpleGraph()
        h.add_nodes_from(self._adj)
        for u, nbrs in self._adj.items():
            for v in nbrs:
                h.add_edge(u, v)
        h.feat = {u: f.copy() for u, f in self.feat.items()}
        return h

    def relabeled(self, mapping: Dict[int, int]) -> "SimpleGraph":
        """``nx.relabel_nodes(G, mapping)`` with ``copy=True``."""
        h = SimpleGraph()
        h.add_nodes_from(mapping.get(u, u) for u in self._adj)
        h.add_edges_from(
            (mapping.get(u, u), mapping.get(v, v)) for u, v in self.edges()
        )
        return h


Shape = Tuple[SimpleGraph, List[int]]


def _barabasi_albert(n: int, m: int, seed: int) -> SimpleGraph:
    """``nx.barabasi_albert_graph(n, m, seed=seed)`` (networkx 3.6.1)."""
    if m < 1 or m >= n:
        raise ValueError(f"Barabasi-Albert needs 1 <= m < n, m = {m}, n = {n}")
    rnd = random.Random(seed)
    g = SimpleGraph()
    g.add_nodes_from(range(m + 1))
    g.add_edges_from((0, k) for k in range(1, m + 1))
    repeated = [u for u, d in g.degree() for _ in range(d)]
    source = len(g._adj)
    while source < n:
        targets = set()
        while len(targets) < m:
            targets.add(rnd.choice(repeated))
        g.add_edges_from(zip([source] * m, targets))
        repeated.extend(targets)
        repeated.extend([source] * m)
        source += 1
    return g


def ba(start, width, role_start=0, m=5, rng=None) -> Shape:
    """Barabasi-Albert basis (``tpugraph/data/shapes.py:98``)."""
    rng = rng or np.random.default_rng()
    seed = int(rng.integers(0, 2**31 - 1))
    g = _barabasi_albert(width, m, seed)
    g = g.relabeled({nid: start + i for i, nid in enumerate(sorted(g._adj))})
    return g, [role_start] * width


def house(start, role_start=0, rng=None) -> Shape:
    """5-node house (``tpugraph/data/shapes.py:108``): roles bottom pair
    role_start, middle pair role_start+1, roof role_start+2."""
    g = SimpleGraph()
    g.add_nodes_from(range(start, start + 5))
    g.add_edges_from(
        [(start, start + 1), (start + 1, start + 2), (start + 2, start + 3),
         (start + 3, start)]
    )
    g.add_edges_from([(start + 4, start), (start + 4, start + 1)])
    roles = [role_start, role_start, role_start + 1, role_start + 1,
             role_start + 2]
    return g, roles


SHAPES = {"ba": ba, "house": house}


def build_graph(
    width_basis: int,
    basis_type: str,
    list_shapes: List[list],
    start: int = 0,
    m: int = 5,
    rng: Optional[np.random.Generator] = None,
):
    """Basis graph with shapes attached by one edge each at regularly
    spaced plugin nodes (``tpugraph/data/shapes.py:156`` with its
    defaults ``rdm_basis_plugins=False``, ``add_random_edges=0``).
    Role ids: basis 0; each shape type claims the next block of ids.
    Returns ``(G, role_ids, plugins)``."""
    rng = rng or np.random.default_rng()
    if basis_type == "ba":
        basis, role_id = SHAPES[basis_type](start, width_basis, m=m, rng=rng)
    else:
        basis, role_id = SHAPES[basis_type](start, width_basis, rng=rng)

    n_basis, n_shapes = basis.number_of_nodes(), len(list_shapes)
    start += n_basis
    spacing = math.floor(n_basis / n_shapes)
    plugins = [int(k * spacing) for k in range(n_shapes)]
    seen_shapes = {"basis": [0, n_basis]}

    for shape_id, shape in enumerate(list_shapes):
        shape_type = shape[0]
        args = [start] + list(shape[1:]) + [0]
        graph_s, roles_graph_s = SHAPES[shape_type](*args, rng=rng)
        n_s = graph_s.number_of_nodes()
        if shape_type in seen_shapes:
            col_start = seen_shapes[shape_type][0]
        else:
            col_start = int(np.max(role_id)) + 1
            seen_shapes[shape_type] = [col_start, n_s]
        basis.add_nodes_from(graph_s.nodes())
        basis.add_edges_from(graph_s.edges())
        basis.add_edge(start, plugins[shape_id])
        role_id += [r + col_start for r in roles_graph_s]
        start += n_s
    return basis, role_id, plugins
