"""Port of ``tpugraph/data/pipeline.py``: padded dense batches of labelled
graphs for graph classification, without networkx.

Every array is built as ``tpugraph`` builds it, so the two packages hand
their models byte-identical batches: the adjacency in node order
(``nx.to_numpy_array``: 1 for an edge, a self-loop once on the
diagonal), normalized in float64 and cast to float32; the feature modes
``default``/``id``/``deg-num``/``deg``/``struct`` (``deg`` takes its
degrees from the normalized adjacency when ``normalize`` is on, as
``tpugraph`` does; ``struct``'s clustering coefficient is
``nx.clustering``'s, computed from the triangle counts of the adjacency);
and the shuffle and split draws of the same ``np.random.Generator``.
The batches stay numpy; the training loop moves them to the device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np

from tpugraph_torch.data.shapes import SimpleGraph


@dataclasses.dataclass
class DenseGraphBatch:
    """Dense padded batch (``tpugraph/data/pipeline.py:22``)."""

    adj: np.ndarray           # [B, N, N] float32
    feats: np.ndarray         # [B, N, D] float32
    label: np.ndarray         # [B] int32
    num_nodes: np.ndarray     # [B] int32
    node_mask: np.ndarray     # [B, N] float32
    assign_feats: np.ndarray  # [B, N, Da] float32


def to_numpy_array(G: SimpleGraph) -> np.ndarray:
    """``nx.to_numpy_array(G)``: float64, entry (i, j) is the weight of the
    edge between the i-th and j-th nodes of ``G.nodes()`` (1 for an
    unweighted one), and a self-loop's weight is on the diagonal."""
    nodes = G.nodes()
    index = {u: i for i, u in enumerate(nodes)}
    adj = np.zeros((len(nodes), len(nodes)))
    for u, v in G.edges():
        adj[index[u], index[v]] = adj[index[v], index[u]] = G.weight(u, v)
    return adj


def clustering(G: SimpleGraph) -> np.ndarray:
    """``nx.clustering(G)`` of an unweighted graph in node order: twice a
    node's triangles over ``d (d - 1)``, with self-loops left out of both
    (0 where there is no triangle)."""
    a = (to_numpy_array(G) != 0).astype(np.int64)
    np.fill_diagonal(a, 0)
    t = np.einsum("ij,jk,ki->i", a, a, a)  # twice the triangles at each node
    d = a.sum(axis=1)
    out = np.zeros(len(d))
    nz = t > 0
    out[nz] = t[nz] / (d[nz] * (d[nz] - 1))
    return out


def _node_feats(G: SimpleGraph, max_num_nodes: int, feat_dim: int) -> np.ndarray:
    f = np.zeros((max_num_nodes, feat_dim), dtype=np.float32)
    for i, u in enumerate(G.nodes()):
        f[i, :] = G.feat[u]
    return f


def _degree_onehot(adj: np.ndarray, n: int, max_num_nodes: int) -> np.ndarray:
    max_deg = 10
    degs = np.minimum(np.sum(adj, 1).astype(int), max_deg)
    onehot = np.zeros((n, max_deg + 1), dtype=np.float32)
    onehot[np.arange(n), degs[:n]] = 1
    return np.pad(onehot, ((0, max_num_nodes - n), (0, 0)))


def _graph_feats(G: SimpleGraph, adj: np.ndarray, max_num_nodes: int,
                 feat_dim: int, features: str) -> np.ndarray:
    """A graph's feature matrix, zero-padded to ``max_num_nodes`` rows
    (``tpugraph/data/pipeline.py:37``)."""
    n = G.number_of_nodes()
    if features == "default":
        return _node_feats(G, max_num_nodes, feat_dim)
    if features == "id":
        return np.identity(max_num_nodes, dtype=np.float32)
    if features == "deg-num":
        out = np.zeros((max_num_nodes, 1), dtype=np.float32)
        out[:n, 0] = np.sum(adj, 1)[:n]
        return out
    if features == "deg":
        return np.concatenate([_degree_onehot(adj, n, max_num_nodes),
                               _node_feats(G, max_num_nodes, feat_dim)], axis=1)
    if features == "struct":
        onehot = _degree_onehot(adj, n, max_num_nodes)
        clust = np.pad(clustering(G).astype(np.float32),
                       (0, max_num_nodes - n))[:, None]
        g_feat = np.hstack([onehot, clust])
        if G.nodes()[0] in G.feat:
            node_feats = np.array([G.feat[u] for u in G.nodes()],
                                  dtype=np.float32)
            node_feats = np.pad(node_feats, ((0, max_num_nodes - n), (0, 0)))
            g_feat = np.hstack([g_feat, node_feats])
        return g_feat.astype(np.float32)
    raise ValueError(f"unknown feature mode {features!r}")


class GraphBatcher:
    """Padded dense tensors of a list of labelled graphs, and shuffled
    fixed-size minibatches of them (``tpugraph/data/pipeline.py:89``).
    ``normalize`` applies ``D^-1/2 A D^-1/2`` to each adjacency."""

    def __init__(self, G_list: Sequence[SimpleGraph], features: str = "default",
                 normalize: bool = True, assign_feat: str = "default",
                 max_num_nodes: int = 0):
        if max_num_nodes == 0:
            max_num_nodes = max(G.number_of_nodes() for G in G_list)
        self.max_num_nodes = max_num_nodes
        first = G_list[0]
        last = first.nodes()[-1]
        feat_dim = first.feat[last].shape[0] if last in first.feat else 0

        adjs, feats, labels, lens, assigns = [], [], [], [], []
        for G in G_list:
            adj = to_numpy_array(G)
            if normalize:
                deg = np.sum(adj, axis=0)
                inv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
                adj = np.diag(inv) @ adj @ np.diag(inv)
            n = G.number_of_nodes()
            padded = np.zeros((max_num_nodes, max_num_nodes), dtype=np.float32)
            padded[:n, :n] = adj
            adjs.append(padded)
            lens.append(n)
            labels.append(G.graph["label"])
            f = _graph_feats(G, adj, max_num_nodes, feat_dim, features)
            feats.append(f)
            if assign_feat == "id":
                assigns.append(np.hstack(
                    [np.identity(max_num_nodes, dtype=np.float32), f]))
            else:
                assigns.append(f)

        self.adj = np.stack(adjs)
        self.feats = np.stack(feats)
        self.labels = np.asarray(labels, dtype=np.int32)
        self.num_nodes = np.asarray(lens, dtype=np.int32)
        self.assign_feats = np.stack(assigns)
        self.feat_dim = self.feats.shape[-1]
        self.assign_feat_dim = self.assign_feats.shape[-1]

    def __len__(self) -> int:
        return self.adj.shape[0]

    def _mask(self, idx: np.ndarray) -> np.ndarray:
        mask = np.zeros((len(idx), self.max_num_nodes), dtype=np.float32)
        for row, i in enumerate(idx):
            mask[row, : self.num_nodes[i]] = 1.0
        return mask

    def batch(self, idx: np.ndarray) -> DenseGraphBatch:
        idx = np.asarray(idx)
        return DenseGraphBatch(
            adj=self.adj[idx], feats=self.feats[idx], label=self.labels[idx],
            num_nodes=self.num_nodes[idx], node_mask=self._mask(idx),
            assign_feats=self.assign_feats[idx])

    def batches(self, batch_size: int, shuffle: bool = True,
                rng: Optional[np.random.Generator] = None,
                drop_last: bool = False,
                pad_final: bool = True) -> Iterator[DenseGraphBatch]:
        """Fixed-size batches in ``rng``'s shuffled order; a short final
        batch is dropped or padded with the first graphs of the order
        (``tpugraph/data/pipeline.py:160``)."""
        n = len(self)
        order = np.arange(n)
        if shuffle:
            (rng or np.random.default_rng()).shuffle(order)
        for s in range(0, n, batch_size):
            idx = order[s: s + batch_size]
            if len(idx) < batch_size:
                if drop_last:
                    break
                if pad_final:
                    idx = np.concatenate([idx, order[: batch_size - len(idx)]])
            yield self.batch(idx)


def prepare_data(graphs: List[SimpleGraph], train_ratio: float = 0.8,
                 test_ratio: float = 0.1, features: str = "default",
                 max_nodes: int = 0, rng: Optional[np.random.Generator] = None):
    """Shuffle with ``rng`` and split into unnormalized train/val/test
    batchers (``tpugraph/data/pipeline.py:188``); an empty split is
    ``None``."""
    rng = rng or np.random.default_rng()
    graphs = list(graphs)
    rng.shuffle(graphs)
    train_idx = int(len(graphs) * train_ratio)
    test_idx = int(len(graphs) * (1 - test_ratio))
    if max_nodes == 0:
        max_nodes = max(G.number_of_nodes() for G in graphs)

    def mk(gs):
        return (GraphBatcher(gs, features=features, normalize=False,
                             max_num_nodes=max_nodes) if gs else None)

    return (mk(graphs[:train_idx]), mk(graphs[train_idx:test_idx]),
            mk(graphs[test_idx:]))
