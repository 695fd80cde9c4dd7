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
``edges()`` order).

``read_biosnap`` keeps the largest component in networkx's own node
order: the component is the set ``nx.connected_components`` builds, and
``G.subgraph(c).copy()`` lists it in that set's order when it holds under
half of the graph's nodes, else in the graph's order (networkx's
``FilterAtlas``); Python builds the same sets in the same order, so the
port reproduces the order rather than sorting.  Pickles (``--pkl``, the
Enron slices) hold ``nx.Graph`` objects and the card has no networkx:
:func:`load_graph_pickle` reads them through an unpickler that maps
networkx's ``Graph`` onto :class:`LabeledGraph` (its node, adjacency and
attribute dicts taken as they are, so the order is networkx's) and its
view classes onto nothing, allows numpy's array and scalar
reconstructors, and refuses every other class outside the builtins.
"""

from __future__ import annotations

import csv
import io
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpugraph_torch.data.featgen import ConstFeatureGen
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


# ------------------------------------------------------------- pickles


class _NxGraphState:
    """What an ``nx.Graph`` unpickles into: its ``__dict__``."""

    def __setstate__(self, state):
        self.state = state


class _NxView:
    """A pickled networkx view (``G.nodes``, ``G.edges``, ...): dropped."""

    def __setstate__(self, state):
        pass


_NUMPY_ALLOWED = {
    ("numpy.core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
    ("numpy", "ndarray"), ("numpy", "dtype"),
}


class _GraphUnpickler(pickle.Unpickler):
    """Maps ``networkx.classes.graph.Graph`` onto :class:`_NxGraphState`
    and networkx's view classes onto :class:`_NxView`; allows numpy's
    array and scalar reconstructors; refuses any other class outside the
    builtins."""

    def find_class(self, module, name):
        if (module, name) == ("networkx.classes.graph", "Graph"):
            return _NxGraphState
        if module in ("networkx.classes.reportviews", "networkx.classes.coreviews"):
            return _NxView
        if (module, name) in _NUMPY_ALLOWED:
            return super().find_class(module, name)
        if module == "builtins" and name in ("set", "frozenset", "list", "dict",
                                             "tuple", "int", "float", "str",
                                             "bytes", "bool", "complex"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing to unpickle {module}.{name}")


def _to_graph(obj):
    """Unpickled networkx graphs, anywhere inside lists and tuples, as
    :class:`LabeledGraph`: nodes and neighbours in networkx's dict
    order, a node's ``feat`` attribute in ``feat``, its other attributes
    in ``attrs``, an edge's ``weight`` as its weight, ``G.graph`` as
    ``graph``."""
    if isinstance(obj, _NxGraphState):
        st = obj.state
        g = LabeledGraph()
        g.graph = dict(st.get("graph", {}))
        for u, data in st["_node"].items():
            g.add_node(u)
            data = dict(data)
            if "feat" in data:
                g.feat[u] = np.asarray(data.pop("feat"))
            g.attrs[u] = data
        for u, nbrs in st["_adj"].items():
            for v, d in nbrs.items():
                g._adj[u][v] = d.get("weight")
        return g
    if isinstance(obj, list):
        return [_to_graph(o) for o in obj]
    if isinstance(obj, tuple):
        return tuple(_to_graph(o) for o in obj)
    return obj


def load_graph_pickle(path: str):
    """``pickle.load`` of ``path`` without networkx: every ``nx.Graph`` in
    it comes back as a :class:`LabeledGraph` (``pickle.UnpicklingError``
    for a class the reader does not allow)."""
    with open(path, "rb") as f:
        return _to_graph(_GraphUnpickler(io.BytesIO(f.read())).load())


# --------------------------------------------------------- BioSnap PPI


def _largest_component_nx_order(G: SimpleGraph) -> List[int]:
    """The nodes of ``G.subgraph(max(nx.connected_components(G),
    key=len)).copy()`` in networkx's order: each component is the set its
    BFS builds (``_plain_bfs``), the first largest wins, the view copies
    it through ``set(nbunch_iter(c))`` and lists that set when it holds
    under half of ``G``'s nodes, else ``G``'s nodes that are in it."""
    seen: set = set()
    n = G.number_of_nodes()
    best = None
    for v in G.nodes():
        if v in seen:
            continue
        comp = {v}
        nextlevel = [v]
        while nextlevel:
            thislevel, nextlevel = nextlevel, []
            for u in thislevel:
                for w in G._adj[u]:
                    if w not in comp:
                        comp.add(w)
                        nextlevel.append(w)
                if len(comp) == n - len(seen):
                    break
            if len(comp) == n - len(seen):
                break
        seen.update(comp)
        if best is None or len(comp) > len(best):
            best = comp
    shown = set(u for u in best if u in G._adj)
    if 2 * len(shown) < n:
        return [u for u in shown if u in G._adj]
    return [u for u in G.nodes() if u in shown]


def _subgraph_copy(G: SimpleGraph, nodes: List[int]) -> SimpleGraph:
    """``G.subgraph(nodes).copy()`` with the node order given: nodes added
    in that order, then each node's kept neighbours in ``G``'s order."""
    keep = set(nodes)
    h = SimpleGraph()
    h.add_nodes_from(nodes)
    for u in nodes:
        for v in G._adj[u]:
            if v in keep:
                h.add_edge(u, v, G._adj[u][v])
    return h


def read_biosnap(datadir: str, edgelist_file: str, label_file: str,
                 feat_file: Optional[str] = None, concat: bool = True
                 ) -> SimpleGraph:
    """BioSnap PPI graph with gene-essentiality labels
    (``tpugraph/data/readers.py:111``): the edge list (TSV or CSV, ``#``
    lines and unparsable rows skipped), its largest component in
    networkx's order, ``attrs[u]["label"] = 1`` iff the label file's second
    column is ``Essential`` (unlabelled nodes dropped), then features:
    ``ones(10)``, or from the CSV ``[log(v + 0.1)..., 1.0,
    degree-onehot(10)]`` (``concat``) or the log-features alone, nodes
    without a row dropped; ids relabelled 0.. in node order."""
    G = SimpleGraph()
    delimiter = "\t" if "tsv" in edgelist_file else ","
    with open(os.path.join(datadir, edgelist_file)) as f:
        for row in csv.reader(f, delimiter=delimiter):
            if not row or row[0].lstrip().startswith("#"):
                continue
            try:
                G.add_edge(int(row[0]), int(row[1]))
            except ValueError:
                continue
    G = _subgraph_copy(G, _largest_component_nx_order(G))
    G.attrs = {u: {} for u in G.nodes()}
    with open(os.path.join(datadir, label_file)) as f:
        for row in csv.reader(f, delimiter="\t"):
            if len(row) < 2 or row[0].lstrip().startswith("#"):
                continue
            try:
                gene = int(row[0])
            except ValueError:
                continue
            if gene in G.attrs:
                G.attrs[gene]["label"] = int(row[1].strip() == "Essential")
    G.remove_nodes_from([u for u in G.nodes() if "label" not in G.attrs[u]])
    if feat_file is None:
        for u in G.nodes():
            G.feat[u] = np.ones(10, dtype=np.float32)
    else:
        degree = dict(G.degree())
        with open(os.path.join(datadir, feat_file)) as f:
            reader = csv.reader(f)
            next(reader)  # header row
            for row in reader:
                try:
                    gene = int(row[0])
                except ValueError:
                    continue
                if gene not in degree:
                    continue
                logfeat = np.log(np.array([float(x) if x else 0.0 for x in row[1:]],
                                          dtype=np.float32) + 0.1)
                if concat:
                    onehot = np.zeros(10, dtype=np.float32)
                    onehot[max(min(degree[gene], 10) - 1, 0)] = 1.0
                    G.feat[gene] = np.concatenate([logfeat, [1.0], onehot]
                                                  ).astype(np.float32)
                else:
                    G.feat[gene] = logfeat
        G.remove_nodes_from([u for u in G.nodes() if u not in G.feat])
    mapping = {u: i for i, u in enumerate(G.nodes())}
    out = G.relabeled(mapping)
    out.attrs = {mapping[u]: a for u, a in G.attrs.items()}
    return out


# --------------------------------------------------------------- Enron

ENRON_LABELS = {
    "None": 5,
    "Employee": 0,
    "Vice President": 1,
    "Manager": 2,
    "Trader": 3,
    "CEO+Managing Director+Director+President": 4,
}


def load_enron_slices(datadir: str, num_slices: int = 10,
                      input_dim: int = 10) -> List[LabeledGraph]:
    """The pickled Enron time slices
    ``<datadir>/gnn-explainer-enron/enron_slice_<i>.pkl``, each with
    constant ``ones(input_dim)`` features (``tpugraph/data/readers.py:201``);
    a node's ``role`` is in ``attrs``."""
    gen = ConstFeatureGen(np.ones(input_dim, dtype=np.float32))
    out = []
    for i in range(num_slices):
        net = load_graph_pickle(os.path.join(datadir, "gnn-explainer-enron",
                                             f"enron_slice_{i}.pkl"))
        gen.gen_node_features(net)
        out.append(net)
    return out


def disjoint_union_all(graphs: List[SimpleGraph]) -> SimpleGraph:
    """``nx.disjoint_union_all``: each graph relabelled to consecutive
    integers in node order (``convert_node_labels_to_integers``, edges in
    ``edges()`` order), then nodes and edges of each added in turn; node
    features and attributes carried."""
    out = SimpleGraph()
    first = 0
    for G in graphs:
        mapping = {u: first + i for i, u in enumerate(G.nodes())}
        h = G.relabeled(mapping)
        out.add_nodes_from(h.nodes())
        out.add_edges_from(h.edges())
        out.feat.update(h.feat)
        out.attrs.update({mapping[u]: dict(a) for u, a in G.attrs.items()})
        first += G.number_of_nodes()
    return out
