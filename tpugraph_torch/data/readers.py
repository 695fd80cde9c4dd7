"""Port of ``tpugraph/data/readers.py``: the TU graph-kernel format reader,
without networkx.

:class:`LabeledGraph` stands in for the ``nx.Graph`` ``read_graphfile``
returns: a :class:`~tpugraph_torch.data.shapes.SimpleGraph` with a
``graph`` dict (``label``, ``feat_dim``), one-hot node labels in
``node_label``, node attribute vectors in ``feat`` and, with
``edge_labels=True``, edge labels in ``edge_label``.  The reader keeps
networkx's behaviour exactly: nodes appear in the order they first occur
in ``_A.txt`` (a node with no edge is dropped, as by
``nx.Graph.add_edges_from``), ``u -> v`` and ``v -> u`` are one edge (the
later line's label wins), graphs over ``max_nodes`` are skipped, and ids
are relabelled 0.. in node order (``nx.relabel_nodes``, edges re-added in
``edges()`` order).  ``read_biosnap`` and ``load_enron_slices`` are not
ported yet (ROADMAP section 1 item 9).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpugraph_torch.data.shapes import SimpleGraph


class LabeledGraph(SimpleGraph):
    """A graph of a TU dataset: ``graph["label"]`` (and ``graph["feat_dim"]``
    with node attributes), ``node_label[u]`` (a one-hot list),
    ``feat[u]`` and ``edge_label[(u, v)]`` (both orientations)."""

    def __init__(self):
        super().__init__()
        self.graph: Dict[str, int] = {}
        self.node_label: Dict[int, list] = {}
        self.edge_label: Dict[Tuple[int, int], int] = {}


def _read_int_column(path: str) -> Optional[List[int]]:
    """One integer per non-blank line, or None if the file is absent
    (``tpugraph/data/readers.py:18``)."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return [int(line) for line in f if line.strip()]


def _dense_remap(values: List[int]) -> List[int]:
    """Arbitrary integer categories onto 0..C-1 in sorted order
    (``tpugraph/data/readers.py:26``)."""
    lut = {v: c for c, v in enumerate(sorted(set(values)))}
    return [lut[v] for v in values]


def read_graphfile(
    datadir: str,
    dataname: str,
    max_nodes: Optional[int] = None,
    edge_labels: bool = False,
) -> List[LabeledGraph]:
    """Parse ``<datadir>/<dataname>/<dataname>_*.txt``
    (``tpugraph/data/readers.py:32``): ``_graph_indicator`` maps 1-based
    node ids to 1-based graph ids, ``_A`` is the comma-separated edge list
    over global node ids, ``_graph_labels`` are remapped to 0..C-1 into
    ``graph["label"]``; optional ``_node_labels`` become one-hot
    ``node_label`` lists, ``_node_attributes`` float32 ``feat`` vectors
    (and ``graph["feat_dim"]``), and with ``edge_labels=True``
    ``_edge_labels`` (remapped to 0..C-1) ``edge_label``."""
    prefix = os.path.join(datadir, dataname, dataname)
    graph_of_node = np.asarray(
        _read_int_column(prefix + "_graph_indicator.txt"), dtype=np.int64) - 1
    num_graphs = int(graph_of_node.max()) + 1
    graph_labels = _dense_remap(_read_int_column(prefix + "_graph_labels.txt"))

    raw_node_labels = _read_int_column(prefix + "_node_labels.txt")
    node_onehots: Optional[np.ndarray] = None
    if raw_node_labels is not None:
        dense = _dense_remap(raw_node_labels)
        node_onehots = np.eye(max(dense) + 1, dtype=np.int64)[dense]

    node_feats: Optional[List[np.ndarray]] = None
    attr_path = prefix + "_node_attributes.txt"
    if os.path.exists(attr_path):
        node_feats = []
        with open(attr_path) as f:
            for line in f:
                vals = [float(tok) for tok in line.split(",") if tok.strip()]
                node_feats.append(np.asarray(vals, dtype=np.float32))

    with open(prefix + "_A.txt") as f:
        raw_edges = [tuple(int(tok) for tok in line.split(",")[:2])
                     for line in f if line.strip()]
    edge_label_col = (
        _dense_remap(_read_int_column(prefix + "_edge_labels.txt") or [0])
        if edge_labels and os.path.exists(prefix + "_edge_labels.txt")
        else None)
    per_graph: List[list] = [[] for _ in range(num_graphs)]
    for k, (u, v) in enumerate(raw_edges):
        per_graph[graph_of_node[u - 1]].append(
            (u, v, None if edge_label_col is None else edge_label_col[k]))

    graphs = []
    for gid in range(num_graphs):
        g = SimpleGraph()
        labels: Dict[frozenset, int] = {}
        for u, v, lab in per_graph[gid]:
            g.add_edge(u, v)
            if lab is not None:
                labels[frozenset((u, v))] = lab
        n = g.number_of_nodes()
        if max_nodes is not None and 0 < max_nodes < n:
            continue
        index = {u: i for i, u in enumerate(g.nodes())}
        out = LabeledGraph()
        out.add_nodes_from(range(n))
        for u, v in g.edges():
            out.add_edge(index[u], index[v])
            if labels:
                lab = labels[frozenset((u, v))]
                out.edge_label[(index[u], index[v])] = lab
                out.edge_label[(index[v], index[u])] = lab
        out.graph["label"] = graph_labels[gid]
        for u, i in index.items():
            if node_onehots is not None:
                out.node_label[i] = node_onehots[u - 1].tolist()
            if node_feats is not None:
                out.feat[i] = node_feats[u - 1]
        if node_feats is not None:
            out.graph["feat_dim"] = int(node_feats[0].shape[0])
        graphs.append(out)
    return graphs
