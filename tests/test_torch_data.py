"""Parity of the port's data generation and BCSR packing with tpugraph:
the same seed gives the same syn1 graph, and the same edges give
byte-identical BCSR arrays."""

import networkx as nx
import numpy as np
import pytest
import torch

from tpugraph.core.graph import graph_from_networkx as jax_graph_from_networkx
from tpugraph.data import gengraph as jax_gengraph
from tpugraph.data import shapes as jax_shapes
from tpugraph.ops import bcsr as jax_bcsr
from tpugraph_torch.core.graph import graph_from_edge_list
from tpugraph_torch.data import gengraph, shapes
from tpugraph_torch.ops import bcsr

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gen_syn1_matches_tpugraph(seed):
    G_j, labels_j, name_j = jax_gengraph.gen_syn1(seed=seed)
    G_t, labels_t, name_t = gengraph.gen_syn1(seed=seed)
    assert list(G_j.nodes()) == G_t.nodes()
    assert labels_j == labels_t and name_j == name_t
    assert ({frozenset(e) for e in G_j.edges()}
            == {frozenset(e) for e in G_t.edges()})
    # same edge order too, so the padded Graph arrays coincide
    g_j = jax_graph_from_networkx(G_j)
    g_t = graph_from_edge_list(G_t.number_of_nodes(), G_t.edges())
    for name in ("senders", "receivers", "edge_weight", "node_mask",
                 "edge_pair"):
        np.testing.assert_array_equal(np.asarray(getattr(g_j, name)),
                                      getattr(g_t, name).numpy())
    cg_j = jax_gengraph.preprocess_input_graph(G_j, labels_j)
    cg_t = gengraph.preprocess_input_graph(G_t, labels_t)
    for k in ("adj", "feat", "labels"):
        np.testing.assert_array_equal(cg_j[k], cg_t[k])


@pytest.mark.parametrize("seed,width,m", [(3, 50, 2), (4, 300, 5)])
def test_ba_matches_networkx(seed, width, m):
    """ba() draws its networkx seed from the numpy rng; the resulting
    graph equals nx.barabasi_albert_graph's, and build_graph matches."""
    g_j, roles_j = jax_shapes.ba(7, width, m=m, rng=np.random.default_rng(seed))
    g_t, roles_t = shapes.ba(7, width, m=m, rng=np.random.default_rng(seed))
    assert list(g_j.nodes()) == g_t.nodes() and roles_j == roles_t
    assert list(g_j.edges()) == list(g_t.edges())
    ref = nx.barabasi_albert_graph(width, m, seed=seed)
    ours = shapes._barabasi_albert(width, m, seed)
    assert list(ref.edges()) == list(ours.edges())


def _random_edges(rng, n_rows, n_cols, n_edges):
    s = rng.integers(0, n_cols, n_edges).astype(np.int32)
    r = rng.integers(0, n_rows, n_edges).astype(np.int32)
    w = rng.standard_normal(n_edges).astype(np.float32)
    w[rng.random(n_edges) < 0.1] = 0.0  # padding-style dead edges
    return s, r, w


def _assert_same_bcsr(a, b):
    for name in ("tiles", "col_blk", "row_ptr", "row_of"):
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name
    assert a.num_nodes == b.num_nodes and a.block == b.block


def test_bcsr_pack_matches_tpugraph_syn1():
    G, _, _ = gengraph.gen_syn1(seed=0)
    g = graph_from_edge_list(G.number_of_nodes(), G.edges())
    s, r, w = g.senders.numpy(), g.receivers.numpy(), g.edge_weight.numpy()
    n = g.num_nodes_padded
    m_j = jax_bcsr.bcsr_from_coo(s, r, w, n, block=128, device=False)
    m_t = bcsr.bcsr_from_coo(s, r, w, n, block=128)
    _assert_same_bcsr(m_j, m_t)
    _assert_same_bcsr(
        jax_bcsr.bcsr_transpose_host(s, r, w, n, block=128, device=False),
        bcsr.bcsr_transpose_host(s, r, w, n, block=128))
    tp_j, tp_t = jax_bcsr.bcsr_transpose_plan(m_j), bcsr.bcsr_transpose_plan(m_t)
    for name in ("col_blk", "row_ptr", "row_of", "perm", "keep"):
        x, y = np.asarray(getattr(tp_j, name)), getattr(tp_t, name)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
    assert (tp_j.num_nodes, tp_j.block) == (tp_t.num_nodes, tp_t.block)
    p_j, p_t = jax_bcsr.bcsr_sym_partner(m_j), bcsr.bcsr_sym_partner(m_t)
    assert p_j.dtype == p_t.dtype and p_j.tobytes() == p_t.tobytes()


@pytest.mark.parametrize("n_rows,n_cols", [(300, 300), (200, 450), (520, 130)])
def test_bcsr_pack_matches_tpugraph_random(n_rows, n_cols):
    """Square and rectangular matrices with duplicate edges, zero weights
    and empty row blocks (rows beyond the edges' reach get dead tiles)."""
    rng = np.random.default_rng(n_rows + n_cols)
    s, r, w = _random_edges(rng, min(n_rows, 260), n_cols, 900)
    kw = {} if n_rows == n_cols else {"num_col_nodes": n_cols}
    m_j = jax_bcsr.bcsr_from_coo(s, r, w, n_rows, block=64, device=False, **kw)
    m_t = bcsr.bcsr_from_coo(s, r, w, n_rows, block=64, **kw)
    _assert_same_bcsr(m_j, m_t)
    tp_j, tp_t = jax_bcsr.bcsr_transpose_plan(m_j), bcsr.bcsr_transpose_plan(m_t)
    for name in ("col_blk", "row_ptr", "row_of", "perm", "keep"):
        assert np.asarray(getattr(tp_j, name)).tobytes() == getattr(tp_t, name).tobytes()
    assert (np.asarray(jax_bcsr.bcsr_sym_partner(m_j)).tobytes()
            == bcsr.bcsr_sym_partner(m_t).tobytes())
