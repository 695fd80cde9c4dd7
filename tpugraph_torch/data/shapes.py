"""Port of ``tpugraph/data/shapes.py`` (every shape and ``build_graph``),
without networkx.

:class:`SimpleGraph` stands in for ``nx.Graph``: an undirected graph
whose node and neighbor dicts keep insertion order, with the same
``edges()`` iteration order as networkx.  Every shape is built in the
order networkx 3.6.1 builds it, relabelling copies included, so later
draws that follow node or edge order see the same order in both
packages.  ``ba`` reproduces ``nx.barabasi_albert_graph(width, m,
seed=int)`` exactly — a star on m+1 nodes, then ``_random_subset``
through ``random.Random(seed).choice`` over the repeated-node list,
targets added in set-iteration order.  ``tree`` is
``nx.balanced_tree`` (edges in ``_tree_edges``' breadth-first order),
``grid`` is ``nx.grid_graph([dim, dim])`` (a cartesian product of two
paths, relabelled twice) and ``clique`` is ``nx.complete_graph`` (edges
in ``itertools.combinations`` order).  Randomness otherwise flows
through an explicit ``numpy.random.Generator``.
"""

from __future__ import annotations

import itertools
import math
import random
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


class SimpleGraph:
    """Undirected simple graph with insertion-ordered nodes and neighbors
    (the subset of ``nx.Graph`` the generators use).  ``feat`` holds the
    per-node feature vectors a feature generator attaches; ``attrs`` any
    other node attributes (``G.nodes[u]`` in networkx); an edge may carry
    a ``weight`` (``None``: unweighted, read as 1)."""

    def __init__(self):
        self._adj: Dict[int, Dict[int, Optional[float]]] = {}
        self.feat: Dict[int, np.ndarray] = {}
        self.attrs: Dict[int, Dict[str, object]] = {}

    def add_node(self, u: int) -> None:
        if u not in self._adj:
            self._adj[u] = {}

    def add_nodes_from(self, nodes) -> None:
        for u in nodes:
            self.add_node(u)

    def add_edge(self, u: int, v: int, weight: Optional[float] = None) -> None:
        """Add ``u - v``; re-adding an edge keeps its place and takes the
        new weight, as networkx's ``add_edge`` does."""
        self.add_node(u)
        self.add_node(v)
        self._adj[u][v] = weight
        self._adj[v][u] = weight

    def weight(self, u: int, v: int) -> float:
        w = self._adj[u][v]
        return 1.0 if w is None else w

    def neighbors(self, u: int) -> List[int]:
        return list(self._adj[u])

    def add_edges_from(self, edges) -> None:
        for u, v in edges:
            self.add_edge(u, v)

    def remove_edge(self, u: int, v: int) -> None:
        del self._adj[u][v]
        if u != v:
            del self._adj[v][u]

    def remove_nodes_from(self, nodes) -> None:
        """``nx.Graph.remove_nodes_from``: each node, its edges and its
        features and attributes go; absent nodes are skipped."""
        for u in nodes:
            if u not in self._adj:
                continue
            for v in list(self._adj[u]):
                del self._adj[v][u]
            del self._adj[u]
            self.feat.pop(u, None)
            self.attrs.pop(u, None)

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
            for v, w in nbrs.items():
                h.add_edge(u, v, w)
        h.feat = {u: f.copy() for u, f in self.feat.items()}
        h.attrs = {u: dict(a) for u, a in self.attrs.items()}
        return h

    def relabeled(self, mapping: Dict[int, int]) -> "SimpleGraph":
        """``nx.relabel_nodes(G, mapping)`` with ``copy=True``: nodes in
        order, then the edges in ``edges()`` order, features carried."""
        h = SimpleGraph()
        h.add_nodes_from(mapping.get(u, u) for u in self._adj)
        h.add_edges_from(
            (mapping.get(u, u), mapping.get(v, v)) for u, v in self.edges()
        )
        h.feat = {mapping.get(u, u): f for u, f in self.feat.items()}
        return h


def compose(g: SimpleGraph, h: SimpleGraph) -> SimpleGraph:
    """``nx.compose(g, h)``: ``g``'s nodes and edges, then ``h``'s, each in
    its own order; ``h``'s features win on shared nodes."""
    out = SimpleGraph()
    for part in (g, h):
        out.add_nodes_from(part.nodes())
        out.add_edges_from(part.edges())
        out.feat.update(part.feat)
    return out


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


def clique(start, nb_nodes, nb_to_remove=0, role_start=0, rng=None) -> Shape:
    """Complete graph with ``nb_to_remove`` random edges removed (their
    endpoints' roles go up by one; ``tpugraph/data/shapes.py:23``)."""
    rng = rng or np.random.default_rng()
    g = SimpleGraph()
    g.add_nodes_from(range(nb_nodes))
    g.add_edges_from(itertools.combinations(range(nb_nodes), 2))
    roles = [role_start] * nb_nodes
    if nb_to_remove > 0:
        edges = list(g.edges())
        for e in rng.choice(len(edges), nb_to_remove, replace=False):
            u, v = edges[int(e)]
            g.remove_edge(u, v)
            roles[u] += 1
            roles[v] += 1
    return g.relabeled({k: k + start for k in range(nb_nodes)}), roles


def cycle(start, len_cycle, role_start=0, rng=None) -> Shape:
    """Cycle on ``len_cycle`` nodes (``tpugraph/data/shapes.py:43``)."""
    g = SimpleGraph()
    g.add_nodes_from(range(start, start + len_cycle))
    for i in range(len_cycle - 1):
        g.add_edge(start + i, start + i + 1)
    g.add_edge(start + len_cycle - 1, start)
    return g, [role_start] * len_cycle


def diamond(start, role_start=0, rng=None) -> Shape:
    """A 4-cycle and two apexes joined to all of it
    (``tpugraph/data/shapes.py:53``)."""
    g = SimpleGraph()
    g.add_nodes_from(range(start, start + 6))
    g.add_edges_from([(start, start + 1), (start + 1, start + 2),
                      (start + 2, start + 3), (start + 3, start)])
    for apex in (start + 4, start + 5):
        g.add_edges_from([(apex, start + i) for i in range(4)])
    return g, [role_start] * 6


def _balanced_tree(r: int, h: int) -> SimpleGraph:
    """``nx.balanced_tree(r, h)``: ``1 + r + ... + r^h`` nodes, each
    parent's children attached breadth first (``_tree_edges``)."""
    n = h + 1 if r == 1 else (1 - r ** (h + 1)) // (1 - r)
    g = SimpleGraph()
    g.add_nodes_from(range(n))
    nodes = iter(range(n))
    parents = [next(nodes)] if n else []
    while parents:
        source = parents.pop(0)
        for _ in range(r):
            target = next(nodes, None)
            if target is None:
                break
            parents.append(target)
            g.add_edge(source, target)
    return g


def tree(start, height, r=2, role_start=0, rng=None) -> Shape:
    """Balanced r-ary tree relabelled to start at ``start``
    (``tpugraph/data/shapes.py:64``)."""
    g = _balanced_tree(r, height)
    n = g.number_of_nodes()
    return g.relabeled({i: i + start for i in range(n)}), [0] * n


def star(start, nb_branches, role_start=0, rng=None) -> Shape:
    """Hub (role_start) and ``nb_branches`` leaves (role_start+1)
    (``tpugraph/data/shapes.py:75``)."""
    g = SimpleGraph()
    g.add_nodes_from(range(start, start + nb_branches + 1))
    for k in range(1, nb_branches + 1):
        g.add_edge(start, start + k)
    roles = [role_start + 1] * (nb_branches + 1)
    roles[0] = role_start
    return g, roles


def fan(start, nb_branches, role_start=0, rng=None) -> Shape:
    """A star plus edges between consecutive leaves
    (``tpugraph/data/shapes.py:87``)."""
    g, roles = star(start, nb_branches, role_start=role_start)
    for k in range(1, nb_branches - 1):
        roles[k] += 1
        roles[k + 1] += 1
        g.add_edge(start + k, start + k + 1)
    return g, roles


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


def _path_graph(n: int) -> SimpleGraph:
    g = SimpleGraph()
    g.add_nodes_from(range(n))
    g.add_edges_from((i, i + 1) for i in range(n - 1))
    return g


def _cartesian_product(g: SimpleGraph, h: SimpleGraph) -> SimpleGraph:
    """``nx.cartesian_product(g, h)`` on tuple labels: nodes in
    ``product(g, h)`` order, then g's edges across h's nodes, then h's
    edges across g's nodes."""
    gh = SimpleGraph()
    gh.add_nodes_from((u, v) for u in g.nodes() for v in h.nodes())
    gh.add_edges_from(((u, x), (v, x)) for u, v in g.edges()
                      for x in h.nodes())
    gh.add_edges_from(((x, u), (x, v)) for x in g.nodes()
                      for u, v in h.edges())
    return gh


def grid(start, dim=2, role_start=0, rng=None) -> Shape:
    """dim x dim grid (``tpugraph/data/shapes.py:122``): ``nx.grid_graph``
    takes the product of two paths and relabels it (a copy), then
    ``convert_node_labels_to_integers`` numbers its nodes in order from
    ``start`` (another copy)."""
    g = _cartesian_product(_path_graph(dim), _path_graph(dim))
    g = g.relabeled({})
    g = g.relabeled(dict(zip(g.nodes(), range(start, start + dim * dim))))
    return g, [role_start] * g.number_of_nodes()


def path(start, width, role_start=0, rng=None) -> Shape:
    """Path whose endpoints get role_start+1
    (``tpugraph/data/shapes.py:129``)."""
    g = SimpleGraph()
    g.add_nodes_from(range(start, start + width))
    for i in range(width - 1):
        g.add_edge(start + i, start + i + 1)
    roles = [role_start] * width
    roles[0] = roles[-1] = role_start + 1
    return g, roles


SHAPES = {
    "clique": clique,
    "cycle": cycle,
    "diamond": diamond,
    "tree": tree,
    "fan": fan,
    "ba": ba,
    "house": house,
    "grid": grid,
    "star": star,
    "path": path,
}


def build_graph(
    width_basis: int,
    basis_type: str,
    list_shapes: List[list],
    start: int = 0,
    rdm_basis_plugins: bool = False,
    add_random_edges: int = 0,
    m: int = 5,
    rng: Optional[np.random.Generator] = None,
):
    """Basis graph with shapes attached by one edge each at regularly
    spaced (or random) plugin nodes; a cycle gets a second anchor edge
    with probability 0.5, and ``add_random_edges`` random edges follow
    (``tpugraph/data/shapes.py:156``).  Role ids: basis 0; each shape type
    claims the next block of ids.  Returns ``(G, role_ids, plugins)``."""
    rng = rng or np.random.default_rng()
    if basis_type == "ba":
        basis, role_id = SHAPES[basis_type](start, width_basis, m=m, rng=rng)
    else:
        basis, role_id = SHAPES[basis_type](start, width_basis, rng=rng)

    n_basis, n_shapes = basis.number_of_nodes(), len(list_shapes)
    start += n_basis
    if rdm_basis_plugins:
        plugins = [int(p) for p in
                   rng.choice(n_basis, n_shapes, replace=False)]
    else:
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
        if shape_type == "cycle" and rng.random() > 0.5:
            a = int(rng.integers(1, 4))
            b = int(rng.integers(1, 4))
            basis.add_edge(a + start, b + plugins[shape_id])
        role_id += [r + col_start for r in roles_graph_s]
        start += n_s

    for _ in range(add_random_edges):
        src, dest = rng.choice(basis.number_of_nodes(), 2, replace=False)
        basis.add_edge(int(src), int(dest))
    return basis, role_id, plugins
