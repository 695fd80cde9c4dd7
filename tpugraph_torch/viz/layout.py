"""Graph layouts of networkx 3.6.1, without networkx, on
:class:`~tpugraph_torch.data.shapes.SimpleGraph`.

``tpugraph`` lays out its renders with ``nx.kamada_kawai_layout(G,
weight=None)`` (``tpugraph/viz/graphs.py:149``) and ``nx.spring_layout(sub,
seed=0)`` (``:296``).  These are the same computations, operation for
operation: the same start (``circular_layout``; a ``RandomState(seed)``
draw), the same energy, gradient and optimizer, the same rescale, so the
positions agree with networkx's for the same graph in the same node
order.  scipy is imported inside :func:`kamada_kawai_layout` only.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from tpugraph_torch.data.pipeline import to_numpy_array
from tpugraph_torch.data.shapes import SimpleGraph


def rescale_layout(pos: np.ndarray, scale: float = 1) -> np.ndarray:
    """``nx.rescale_layout``: centre each axis, then scale so the largest
    magnitude is ``scale`` (in place; returned)."""
    pos -= pos.mean(axis=0)
    lim = np.abs(pos).max()
    if lim > 0:
        pos *= scale / lim
    return pos


def circular_layout(G: SimpleGraph) -> Dict[int, np.ndarray]:
    """``nx.circular_layout(G)`` in two dimensions: angles in float32, then
    rescaled."""
    nodes = G.nodes()
    if not nodes:
        return {}
    if len(nodes) == 1:
        return {nodes[0]: np.zeros(2)}
    theta = np.linspace(0, 1, len(nodes) + 1)[:-1] * 2 * np.pi
    theta = theta.astype(np.float32)
    pos = np.column_stack([np.cos(theta), np.sin(theta), np.zeros((len(nodes), 0))])
    pos = rescale_layout(pos) + np.zeros(2)
    return dict(zip(nodes, pos))


def hop_distances(G: SimpleGraph) -> np.ndarray:
    """All-pairs shortest-path hop counts in node order, 1e6 where no path
    exists (the matrix ``nx.kamada_kawai_layout`` builds with
    ``weight=None``)."""
    nodes = G.nodes()
    index = {u: i for i, u in enumerate(nodes)}
    dist = 1e6 * np.ones((len(nodes), len(nodes)))
    for src in nodes:
        row = dist[index[src]]
        row[index[src]] = 0
        level, seen, d = [src], {src}, 0
        while level:
            d += 1
            nxt = []
            for v in level:
                for w in G.neighbors(v):
                    if w not in seen:
                        seen.add(w)
                        row[index[w]] = d
                        nxt.append(w)
            level = nxt
    return dist


def _kamada_kawai_costfn(pos_vec, invdist, meanweight, dim):
    """networkx's ``_kamada_kawai_costfn``: the energy and its gradient."""
    n = invdist.shape[0]
    pos_arr = pos_vec.reshape((n, dim))
    delta = pos_arr[:, np.newaxis, :] - pos_arr[np.newaxis, :, :]
    nodesep = np.linalg.norm(delta, axis=-1)
    direction = np.einsum("ijk,ij->ijk", delta, 1 / (nodesep + np.eye(n) * 1e-3))
    offset = nodesep * invdist - 1.0
    offset[np.diag_indices(n)] = 0
    cost = 0.5 * np.sum(offset ** 2)
    grad = (np.einsum("ij,ij,ijk->ik", invdist, offset, direction)
            - np.einsum("ij,ij,ijk->jk", invdist, offset, direction))
    sumpos = np.sum(pos_arr, axis=0)
    cost += 0.5 * meanweight * np.sum(sumpos ** 2)
    grad += meanweight * sumpos
    return cost, grad.ravel()


def kamada_kawai_layout(G: SimpleGraph) -> Dict[int, np.ndarray]:
    """``nx.kamada_kawai_layout(G, weight=None)``: hop distances, a
    circular start, L-BFGS-B on networkx's energy, then rescaled to
    [-1, 1]."""
    import scipy.optimize

    nodes = G.nodes()
    if not nodes:
        return {}
    dist = hop_distances(G)
    start = circular_layout(G)
    pos_arr = np.array([start[u] for u in nodes])
    res = scipy.optimize.minimize(
        _kamada_kawai_costfn, pos_arr.ravel(), method="L-BFGS-B",
        args=(1 / (dist + np.eye(dist.shape[0]) * 1e-3), 1e-3, 2), jac=True)
    pos = rescale_layout(res.x.reshape((-1, 2))) + np.zeros(2)
    return dict(zip(nodes, pos))


SPRING_ITERATIONS, SPRING_THRESHOLD = 50, 1e-4  # nx.spring_layout's defaults


def spring_layout(G: SimpleGraph, seed: int = 0) -> Dict[int, np.ndarray]:
    """``nx.spring_layout(G, seed=seed)`` for fewer than 500 nodes (its
    dense Fruchterman-Reingold): a ``RandomState(seed)`` start in the unit
    square, SPRING_ITERATIONS steps of linear cooling, stopping early under
    SPRING_THRESHOLD, then rescaled to [-1, 1].  networkx switches to a
    sparse solver from 500 nodes, which this port does not carry: it
    raises ``ValueError`` there."""
    nodes = G.nodes()
    if len(nodes) >= 500:
        raise ValueError(f"spring_layout: {len(nodes)} nodes; the port lays "
                         "out fewer than 500 (networkx's dense method)")
    if not nodes:
        return {}
    if len(nodes) == 1:
        return {nodes[0]: np.zeros(2)}
    A = to_numpy_array(G)
    n = A.shape[0]
    pos = np.asarray(np.random.RandomState(seed).rand(n, 2), dtype=A.dtype)
    k = np.sqrt(1.0 / n)
    t = max(max(pos.T[0]) - min(pos.T[0]), max(pos.T[1]) - min(pos.T[1])) * 0.1
    dt = t / (SPRING_ITERATIONS + 1)
    for _ in range(SPRING_ITERATIONS):
        delta = pos[:, np.newaxis, :] - pos[np.newaxis, :, :]
        distance = np.linalg.norm(delta, axis=-1)
        np.clip(distance, 0.01, None, out=distance)
        displacement = np.einsum("ijk,ij->ik", delta,
                                 (k * k / distance ** 2 - A * distance / k))
        length = np.linalg.norm(displacement, axis=-1)
        length = np.clip(length, a_min=0.01, a_max=None)
        delta_pos = np.einsum("ij,i->ij", displacement, t / length)
        pos += delta_pos
        t -= dt
        if (np.linalg.norm(delta_pos) / n) < SPRING_THRESHOLD:
            break
    pos = rescale_layout(pos) + np.zeros(2)
    return dict(zip(nodes, pos))
