"""Port of ``tpugraph/viz/graphs.py`` without networkx, matplotlib or
sklearn, on :class:`tpugraph_torch.data.shapes.SimpleGraph`.

Every figure is first a *figure record*: a dict of what ``tpugraph``
draws, computed by this module — node positions (networkx's layouts,
:mod:`tpugraph_torch.viz.layout`), palette names and colour indices,
edge grey levels on the ``[lo - (hi - lo), hi]`` window, polylines,
markers, text strings, image matrices with their colormap and limits,
the precision-recall points and the average precision (as sklearn
computes them), and matplotlib's colormap tables (kept here as
constants).  :mod:`tpugraph_torch.viz.writers` then draws the record to
the file ``tpugraph`` writes: the same path, format, figure size and dpi.
The drawing is the port's own, so pixels and PDF bytes differ from
matplotlib's; the record is what the tests hold against ``tpugraph``'s
figures.

``denoise_graph`` keeps one divergence: the largest component's nodes
come out in ascending id order, where networkx 3.6.1's
``G.subgraph(c).copy()`` orders them by its set's internals (for {3, 9,
20, 30, 35} of a 40-node graph it lists ``[35, 3, 9, 20, 30]``).  The
alignment that reads the result is equivariant under a relabelling of
either graph, so its results match ``tpugraph``'s up to that
permutation; a render's layout starts from the node order, so it is
held against networkx's on the same graph in the same order.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from tpugraph_torch.data.shapes import SimpleGraph
from tpugraph_torch.viz.layout import kamada_kawai_layout, spring_layout

def _components(G: SimpleGraph) -> List[Set[int]]:
    """Connected components in the order their first node is visited."""
    seen: Set[int] = set()
    out = []
    for u in G.nodes():
        if u in seen:
            continue
        comp, frontier = {u}, [u]
        while frontier:
            v = frontier.pop()
            for w in G.neighbors(v):
                if w not in comp:
                    comp.add(w)
                    frontier.append(w)
        seen |= comp
        out.append(comp)
    return out


def _subgraph(G: SimpleGraph, keep) -> SimpleGraph:
    """The subgraph on ``keep``, nodes in ascending order, with the edge
    weights, features and attributes of its nodes."""
    keep = sorted(keep)
    kept = set(keep)
    h = SimpleGraph()
    h.add_nodes_from(keep)
    for u in keep:
        for v in G.neighbors(u):
            if v in kept:
                h.add_edge(u, v, G.weight(u, v))
    h.feat = {u: G.feat[u] for u in keep if u in G.feat}
    h.attrs = {u: G.attrs[u] for u in keep if u in G.attrs}
    return h


def denoise_graph(
    adj: np.ndarray,
    node_idx: int,
    feat: Optional[np.ndarray] = None,
    label: Optional[np.ndarray] = None,
    threshold: Optional[float] = None,
    threshold_num: Optional[int] = None,
    max_component: bool = True,
) -> SimpleGraph:
    """A weighted mask thresholded into an explanation subgraph
    (``tpugraph/viz/graphs.py:19``): entries ``>= threshold`` (``> 1e-6``
    without one), or with ``threshold_num`` the top-k undirected edges (the
    (2k)-th largest positive entry of the symmetric mask), become weighted
    edges, a pair's later entry in row-major order setting its weight; the
    query carries ``attrs[node_idx]["self"] = 1``, nodes carry ``feat``
    and ``attrs[u]["label"]`` when given.  Then the graph is restricted to
    its largest component (the first found, visiting nodes in ascending
    order) when it has edges, or with ``max_component=False`` loses its
    isolated nodes."""
    adj = np.asarray(adj)
    num_nodes = adj.shape[-1]
    if threshold_num is not None:
        positive = adj[adj > 0]
        keep = min(2 * threshold_num, positive.size)
        threshold = float(np.partition(positive, -keep)[-keep]) if keep else 1.0
    cutoff = 1e-6 if threshold is None else threshold
    rows, cols = np.nonzero(adj > cutoff if threshold is None else adj >= cutoff)

    G = SimpleGraph()
    G.add_nodes_from(range(num_nodes))
    G.attrs = {u: {} for u in range(num_nodes)}
    G.attrs[node_idx]["self"] = 1
    if feat is not None:
        G.feat = {u: feat[u] for u in range(num_nodes)}
    if label is not None:
        for u in range(num_nodes):
            G.attrs[u]["label"] = label[u]
    for u, v, w in zip(rows.tolist(), cols.tolist(), adj[rows, cols].tolist()):
        G.add_edge(u, v, w)

    if not max_component:
        return _subgraph(G, [u for u in G.nodes() if G.neighbors(u)])
    if G.number_of_edges() > 0:
        return _subgraph(G, max(_components(G), key=len))
    return G


# ------------------------------------------------------------ colormaps

_HEX = {
    "Greys": "ffffff f0f0f0 d9d9d9 bdbdbd 969696 737373 525252 252525 000000",
    "Set1": "e41a1c 377eb8 4daf4a 984ea3 ff7f00 ffff33 a65628 f781bf 999999",
    "tab10": "1f77b4 ff7f0e 2ca02c d62728 9467bd 8c564b e377c2 7f7f7f bcbd22 "
             "17becf",
    "tab20": "1f77b4 aec7e8 ff7f0e ffbb78 2ca02c 98df8a d62728 ff9896 9467bd "
             "c5b0d5 8c564b c49c94 e377c2 f7b6d2 7f7f7f c7c7c7 bcbd22 dbdb8d "
             "17becf 9edae5",
}
# matplotlib's BuPu anchors (ColorBrewer), as its _cm module states them
_BUPU = (
    (0.9686274509803922, 0.9882352941176471, 0.9921568627450981),
    (0.8784313725490196, 0.9254901960784314, 0.9568627450980393),
    (0.7490196078431373, 0.8274509803921568, 0.9019607843137255),
    (0.6196078431372549, 0.7372549019607844, 0.8549019607843137),
    (0.5490196078431373, 0.5882352941176471, 0.7764705882352941),
    (0.5490196078431373, 0.4196078431372549, 0.6941176470588235),
    (0.5333333333333333, 0.2549019607843137, 0.615686274509804),
    (0.5058823529411764, 0.05882352941176471, 0.48627450980392156),
    (0.30196078431372547, 0.0, 0.29411764705882354),
)
_LINEAR = ("BuPu", "Greys")  # interpolated over 256 entries; the rest listed
_LUTSIZE = 256
DEFAULT_LINE = (0.12156862745098039, 0.4666666666666667, 0.7058823529411765, 1.0)
BLACK = (0.0, 0.0, 0.0, 1.0)
BLUE = (0.0, 0.0, 1.0, 1.0)


def _anchors(name: str) -> np.ndarray:
    if name == "BuPu":
        return np.asarray(_BUPU)
    return np.asarray([[int(h[i:i + 2], 16) / 255 for i in (0, 2, 4)]
                       for h in _HEX[name].split()])


def colormap_table(name: str) -> np.ndarray:
    """The ``[N, 4]`` RGBA lookup table of matplotlib's colormap ``name``
    (BuPu, Greys, Set1, tab10, tab20): a listed map's colours, or a
    segmented map's 256 linear interpolations between its anchors."""
    if name not in _HEX and name != "BuPu":
        raise ValueError(f"colormap {name!r}: the port carries "
                         "BuPu, Greys, Set1, tab10 and tab20")
    rgb = _anchors(name)
    if name in _LINEAR:
        n = _LUTSIZE
        x = np.linspace(0, 1, len(rgb)) * (n - 1)
        xind = (n - 1) * np.linspace(0, 1, n) ** 1.0
        ind = np.searchsorted(x, xind)[1:-1]
        distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
        rgb = np.stack([np.clip(np.concatenate([
            [c[0]], distance * (c[ind] - c[ind - 1]) + c[ind - 1], [c[-1]]]),
            0.0, 1.0) for c in rgb.T], axis=1)
    return np.concatenate([rgb, np.ones((len(rgb), 1))], axis=1)


def apply_colormap(name: str, values, vmin: float, vmax: float,
                   alpha: Optional[float] = None) -> np.ndarray:
    """``cmap(Normalize(vmin, vmax)(values))`` as matplotlib computes it:
    ``(v - vmin) / (vmax - vmin)`` (0 when they are equal), scaled by the
    table size and floored, 1.0 onto the last entry, below 0 onto the
    first and above 1 onto the last; ``alpha`` replaces the alpha."""
    lut = colormap_table(name)
    v = np.asarray(values, dtype=np.float64)
    if vmin == vmax:
        t = np.zeros_like(v)
    else:
        t = (v - vmin) / (vmax - vmin)
    t = t * len(lut)
    t[t == len(lut)] = len(lut) - 1
    idx = np.clip(np.where(t < 0, 0, t), 0, len(lut) - 1).astype(int)
    rgba = lut[idx]
    if alpha is not None:
        rgba[..., 3] = alpha
    return rgba


# -------------------------------------------------------- PR curve, AP


def precision_recall_curve(real, pred) -> Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]:
    """``sklearn.metrics.precision_recall_curve(real, pred)`` for binary
    labels: a threshold at each distinct score, descending, the true and
    false positives at or above it, then precision and recall reversed
    with (precision 1, recall 0) appended.  Returns (precision, recall,
    thresholds)."""
    y = np.asarray(real).ravel() == 1
    s = np.asarray(pred, dtype=np.float64).ravel()
    order = np.argsort(-s, kind="stable")
    s, y = s[order], y[order]
    idx = np.concatenate([np.nonzero(np.diff(s))[0], [y.size - 1]])
    tps = np.cumsum(y, dtype=np.float64)[idx]
    fps = 1 + idx - tps
    ps = tps + fps
    precision = np.where(ps != 0, np.divide(tps, ps, where=ps != 0,
                                            out=np.zeros_like(tps)), 0.0)
    recall = (np.full(tps.shape, 1.0) if tps[-1] == 0 else tps / tps[-1])
    return (np.concatenate([precision[::-1], [1.0]]),
            np.concatenate([recall[::-1], [0.0]]), s[idx][::-1])


def average_precision(real, pred) -> float:
    """``sklearn.metrics.average_precision_score(real, pred)`` for binary
    labels: ``-sum(diff(recall) * precision[:-1])``, at least 0."""
    precision, recall, _ = precision_recall_curve(real, pred)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def exp_moving_avg(values, decay: float = 0.85) -> List[float]:
    """EMA smoothing of accuracy curves (``tpugraph/viz/graphs.py:174``)."""
    out, last = [], None
    for v in values:
        last = v if last is None else decay * last + (1 - decay) * v
        out.append(last)
    return out


# ------------------------------------------------------- figure records

SUBPLOT = (0.125, 0.11, 0.775, 0.77)  # matplotlib's default axes box


def _figure(figsize, dpi, fmt, axes) -> Dict:
    return {"figsize": tuple(float(f) for f in figsize), "dpi": int(dpi),
            "format": fmt, "axes": axes}


def _axes(rect=SUBPLOT, **kw) -> Dict:
    ax = {"rect": tuple(rect), "xlim": None, "ylim": None, "axis_off": False,
          "title": None, "xlabel": None, "ylabel": None, "images": [],
          "lines": [], "segments": None, "points": None, "texts": [],
          "legend": False, "colorbar": None}
    ax.update(kw)
    return ax


def _limits(values, margin: float = 0.05) -> Tuple[float, float]:
    lo, hi = float(np.min(values)), float(np.max(values))
    pad = (hi - lo) * margin if hi > lo else 0.5
    return lo - pad, hi + pad


def _image(data, cmap: str, vmin=None, vmax=None) -> Dict:
    data = np.asarray(data, dtype=np.float64)
    vmin = float(np.nanmin(data)) if vmin is None else vmin
    vmax = float(np.nanmax(data)) if vmax is None else vmax
    return {"data": data, "cmap": cmap, "vmin": vmin, "vmax": vmax,
            "rgba": apply_colormap(cmap, data, vmin, vmax)}


def _node_palette(Gc: SimpleGraph, nodecolor: str) -> Tuple[str, int]:
    """A categorical palette wide enough for the classes drawn
    (``tpugraph/viz/graphs.py:82``): in ``feat`` mode the first node with
    a feature decides, by the feature's width."""
    if nodecolor == "feat":
        for u in Gc.nodes():
            if u in Gc.feat:
                dim = int(np.asarray(Gc.feat[u]).size)
                if dim > 9:
                    return "tab20", 19
                if dim > 8:
                    return "tab10", 9
                break
    return "Set1", 8


def _node_data(Gc: SimpleGraph, u: int) -> Dict:
    """Node ``u``'s attributes as ``G.nodes[u]`` holds them in networkx."""
    data = dict(Gc.attrs.get(u, {}))
    if u in Gc.feat:
        data["feat"] = Gc.feat[u]
    return data


def _node_color_class(data: Dict, nodecolor: str, identify_self: bool):
    """(palette index, one-hot class or None) of one node
    (``tpugraph/viz/graphs.py:101``)."""
    if identify_self and "self" in data:
        return 0, None
    if nodecolor == "label" and "label" in data:
        return int(data["label"]) + 1, None
    if nodecolor == "feat" and "feat" in data:
        hot = np.flatnonzero(np.asarray(data["feat"]) == 1)
        cls = int(hot[0]) if hot.size else 0
        return cls, cls
    return 1, None


def _segments(G: SimpleGraph, pos) -> np.ndarray:
    return np.asarray([(pos[u], pos[v]) for u, v in G.edges()], dtype=np.float64)


def graph_record(Gc: SimpleGraph, identify_self: bool = True,
                 nodecolor: str = "label", fig_size=(4, 3), dpi: int = 300,
                 label_node_feat: bool = False,
                 edge_vmax: Optional[float] = None) -> Dict:
    """The figure ``log_graph`` draws (``tpugraph/viz/graphs.py:113``):
    Kamada-Kawai positions; nodes (size 50, alpha 0.8) coloured by
    palette index over [0, vmax], the query (``self``) at index 0; edges
    (width 1, alpha 0.8) in Greys over the window ``[lo - (hi - lo),
    hi]`` of their weights (``hi`` = ``edge_vmax`` when given); with
    ``label_node_feat`` the one-hot classes as text; no axis."""
    palette, vmax = _node_palette(Gc, nodecolor)
    idx, feat_labels = [], {}
    for u in Gc.nodes():
        i, cls = _node_color_class(_node_data(Gc, u), nodecolor, identify_self)
        idx.append(i)
        if cls is not None:
            feat_labels[u] = cls
    weights = np.asarray([Gc.weight(u, v) for u, v in Gc.edges()], dtype=float)
    hi = float(edge_vmax) if edge_vmax is not None else float(weights.max())
    lo = float(weights.min())
    gray_floor = lo - (hi - lo)
    pos = kamada_kawai_layout(Gc)
    xy = np.asarray([pos[u] for u in Gc.nodes()])
    segs = _segments(Gc, pos)
    texts = ([{"x": float(pos[u][0]), "y": float(pos[u][1]), "s": str(c),
               "size": 4} for u, c in feat_labels.items()]
             if label_node_feat else [])
    ax = _axes(
        axis_off=True, xlim=_limits(segs[:, :, 0], 0.1), ylim=_limits(segs[:, :, 1], 0.1),
        points={"xy": xy, "size": 50.0, "palette": palette, "index": idx,
                "vmin": 0.0, "vmax": float(vmax),
                "colors": apply_colormap(palette, idx, 0.0, vmax, alpha=0.8)},
        segments={"xy": segs, "width": 1.0, "weights": weights,
                  "vmin": gray_floor, "vmax": hi,
                  "colors": apply_colormap("Greys", weights, gray_floor, hi,
                                           alpha=0.8)},
        texts=texts)
    return _figure(fig_size, dpi, "pdf", [ax])


def pr_curve_record(real, pred, dpi: int = 200) -> Dict:
    """The figure ``plot_pr_curve`` draws (``tpugraph/viz/graphs.py:185``):
    recall against precision (width 1.5), titled with the AP to three
    places, both axes over [0, 1.02]."""
    precision, recall, _ = precision_recall_curve(real, pred)
    ap = average_precision(real, pred)
    ax = _axes(xlim=(0, 1.02), ylim=(0, 1.02), title=f"AP = {ap:.3f}",
               xlabel="recall", ylabel="precision",
               lines=[{"x": recall, "y": precision, "color": DEFAULT_LINE,
                       "width": 1.5, "style": "-", "marker": None,
                       "markersize": 0.0, "label": None}])
    rec = _figure((6.4, 4.8), dpi, "png", [ax])
    rec["ap"] = ap
    return rec


def accuracy_curve_record(train_accs, val_or_test_accs=None,
                          decay: float = 0.85, dpi: int = 300) -> Dict:
    """The figure ``plot_accuracy_curve`` draws
    (``tpugraph/viz/graphs.py:220``): the EMA of the training accuracy
    (width 1) and the evaluation accuracies as blue dots (size 3), spread
    evenly over the epochs, with a legend."""
    ema = exp_moving_avg(train_accs, decay)
    lines = [{"x": np.arange(len(train_accs), dtype=float), "y": np.asarray(ema),
              "color": DEFAULT_LINE, "width": 1.0, "style": "-", "marker": None,
              "markersize": 0.0, "label": "train"}]
    if val_or_test_accs is not None and len(val_or_test_accs) > 0:
        step = max(len(train_accs) // max(len(val_or_test_accs), 1), 1)
        lines.append({"x": np.asarray([i * step for i in range(len(val_or_test_accs))],
                                      dtype=float),
                      "y": np.asarray(val_or_test_accs, dtype=float),
                      "color": BLUE, "width": 0.0, "style": None, "marker": "o",
                      "markersize": 3.0, "label": "eval"})
    xs = np.concatenate([ln["x"] for ln in lines])
    ys = np.concatenate([ln["y"] for ln in lines])
    ax = _axes(xlim=_limits(xs), ylim=_limits(ys), xlabel="epoch",
               ylabel="accuracy", lines=lines, legend=True)
    return _figure((6.4, 4.8), dpi, "png", [ax])


def matrix_record(mat, fig_size=(8, 6), dpi: int = 200) -> Dict:
    """The figure ``save_matrix_image`` draws (``tpugraph/viz/graphs.py:
    335``): the matrix (a vector as a column) in BuPu over its own range,
    square cells, with a colour bar."""
    mat = np.asarray(mat)
    if mat.ndim == 1:
        mat = mat[:, np.newaxis]
    img = _image(mat, "BuPu")
    h, w = mat.shape
    ax = _axes(rect=(0.08, 0.08, 0.72, 0.84), xlim=(-0.5, w - 0.5),
               ylim=(h - 0.5, -0.5), images=[img], aspect="equal",
               colorbar={"cmap": "BuPu", "vmin": img["vmin"], "vmax": img["vmax"]})
    return _figure(fig_size, dpi, "png", [ax])


def cmap_record(cmap_name: str = "tab20", ncolor: int = 20) -> Dict:
    """The figure ``plot_cmap`` draws (``tpugraph/viz/graphs.py:315``):
    ``ncolor`` steps of [0, 1] in the colormap, no axis."""
    grad = np.linspace(0, 1, ncolor)[None, :]
    ax = _axes(axis_off=True, xlim=(-0.5, ncolor - 0.5), ylim=(0.5, -0.5),
               images=[_image(grad, cmap_name)], aspect="auto")
    return _figure((4, 1), 200, "png", [ax])


def assignment_record(assign_tensor, G: SimpleGraph, fig_size=(8, 4),
                      dpi: int = 300) -> Dict:
    """The figure ``log_assignment`` draws (``tpugraph/viz/graphs.py:
    259``): the soft assignment ``S`` in BuPu with a colour bar, beside the
    first ``S.shape[0]`` nodes of ``G`` in a spring layout (seed 0; size
    40, edges black at width 0.5), coloured in tab20 by their argmax
    cluster over the clusters' range."""
    assign = np.asarray(assign_tensor)
    if assign.ndim == 3:
        assign = assign[0]
    img = _image(assign, "BuPu")
    clusters = np.argmax(assign, axis=-1)
    nodes = G.nodes()[: assign.shape[0]]
    keep = set(nodes)
    sub = SimpleGraph()
    sub.add_nodes_from(nodes)
    for u in nodes:
        for v in G.neighbors(u):
            if v in keep:
                sub.add_edge(u, v)
    pos = spring_layout(sub, seed=0)
    cls = [int(clusters[i]) for i in range(len(nodes))]
    xy = np.asarray([pos[u] for u in nodes])
    segs = _segments(sub, pos)
    ncls = len(cls)
    left = _axes(rect=(0.125, 0.11, 0.30, 0.77), title="soft assignment S",
                 xlim=(-0.5, assign.shape[1] - 0.5),
                 ylim=(assign.shape[0] - 0.5, -0.5), images=[img], aspect="auto",
                 colorbar={"cmap": "BuPu", "vmin": img["vmin"], "vmax": img["vmax"]})
    right = _axes(
        rect=(0.55, 0.11, 0.35, 0.77), title="argmax cluster", axis_off=True,
        xlim=_limits(xy[:, 0], 0.1), ylim=_limits(xy[:, 1], 0.1),
        points={"xy": xy, "size": 40.0, "palette": "tab20", "index": cls,
                "vmin": float(min(cls)) if ncls else 0.0,
                "vmax": float(max(cls)) if ncls else 0.0,
                "colors": apply_colormap("tab20", cls, min(cls) if ncls else 0,
                                         max(cls) if ncls else 0)},
        segments={"xy": segs.reshape(-1, 2, 2), "width": 0.5,
                  "colors": np.tile(BLACK, (len(segs), 1))})
    return _figure(fig_size, dpi, "png", [left, right])


# -------------------------------------------------------------- writers


def _save(record: Dict, path: str) -> str:
    from tpugraph_torch.viz.writers import write_figure

    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_figure(record, path)
    return path


def log_graph(Gc: SimpleGraph, name: str, outdir: str = "log",
              identify_self: bool = True, nodecolor: str = "label",
              epoch: int = 0, fig_size=(4, 3), dpi: int = 300,
              label_node_feat: bool = False,
              edge_vmax: Optional[float] = None) -> str:
    """An explanation subgraph drawn to ``<outdir>/<name>_<epoch>.pdf``
    (``/`` in ``name`` becoming ``_``), :func:`graph_record`'s figure;
    ``""`` for a graph without nodes or edges
    (``tpugraph/viz/graphs.py:113``)."""
    if Gc.number_of_nodes() == 0 or Gc.number_of_edges() == 0:
        return ""
    rec = graph_record(Gc, identify_self, nodecolor, fig_size, dpi,
                       label_node_feat, edge_vmax)
    return _save(rec, os.path.join(outdir, f"{name.replace('/', '_')}_{epoch}.pdf"))


def plot_pr_curve(real, pred, name: str, outdir: str = "log",
                  dpi: int = 200) -> str:
    """The precision-recall curve of mask weights against motif labels, to
    ``<outdir>/<name>.png`` (``tpugraph/viz/graphs.py:185``)."""
    return _save(pr_curve_record(real, pred, dpi),
                 os.path.join(outdir, f"{name.replace('/', '_')}.png"))


def plot_accuracy_curve(train_accs, val_or_test_accs=None,
                        name: str = "train_curve", outdir: str = "results",
                        decay: float = 0.85, dpi: int = 300) -> str:
    """The training accuracy curve to ``<outdir>/<name>.png``
    (``tpugraph/viz/graphs.py:220``)."""
    return _save(accuracy_curve_record(train_accs, val_or_test_accs, decay, dpi),
                 os.path.join(outdir, f"{name}.png"))


def log_assignment(assign_tensor, G: SimpleGraph, name: str = "assignment",
                   outdir: str = "log", epoch: int = 0, fig_size=(8, 4),
                   dpi: int = 300) -> str:
    """DiffPool's soft assignment beside the clustered graph, to
    ``<outdir>/<name>_<epoch>.png`` (``tpugraph/viz/graphs.py:259``)."""
    return _save(assignment_record(assign_tensor, G, fig_size, dpi),
                 os.path.join(outdir, f"{name.replace('/', '_')}_{epoch}.png"))


def plot_cmap(cmap_name: str = "tab20", ncolor: int = 20, outdir: str = "log",
              name: str = "cmap") -> str:
    """A colormap strip to ``<outdir>/<name>.png``
    (``tpugraph/viz/graphs.py:315``)."""
    return _save(cmap_record(cmap_name, ncolor), os.path.join(outdir, f"{name}.png"))


def save_matrix_image(mat, name: str, outdir: str = "log", epoch: int = 0,
                      fig_size=(8, 6), dpi: int = 200) -> str:
    """A heatmap of ``mat`` to ``<outdir>/<name>_<epoch>.png``
    (``tpugraph/viz/graphs.py:335``)."""
    return _save(matrix_record(mat, fig_size, dpi),
                 os.path.join(outdir, f"{name.replace('/', '_')}_{epoch}.png"))
