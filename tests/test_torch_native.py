"""The port's graph engine (``tpugraph_torch.native``, its own copy of
``graph_engine.cpp`` and ctypes binding) against ``tpugraph.native``: every
case of ``tests/test_native.py``, first with the C++ engine on both sides
and then with the numpy fallback on both sides (each side's ``_get_lib``
patched to ``None``).  Arrays are compared byte for byte (tolerance 0).
``label_prop_partition`` is held C++ to C++ and numpy to numpy only: the
two paths are different algorithms in both packages."""

import warnings

import numpy as np
import pytest
import torch

from tpugraph import native as jax_native
from tpugraph.core.graph import graph_from_dense as jax_graph_from_dense
from tpugraph.parallel import spmd as jax_spmd
from tpugraph_torch import native
from tpugraph_torch.core.graph import graph_from_dense
from tpugraph_torch.parallel import spmd

ENGINES = ["native", "numpy"]


@pytest.fixture(params=ENGINES)
def engine(request, monkeypatch):
    """Both packages on the C++ engine, or both on the numpy fallback."""
    if request.param == "numpy":
        monkeypatch.setattr(jax_native, "_get_lib", lambda: None)
        monkeypatch.setattr(native, "_get_lib", lambda: None)
    else:
        assert native.native_available() and jax_native.native_available()
    return request.param


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def coo(rng, n=200, p=0.03):
    a = (rng.random((n, n)) < p).astype(np.float32)
    a = np.triu(a, 1)
    a = a + a.T
    s, r = np.nonzero(a)
    w = rng.random(len(s)).astype(np.float32) + 0.1
    return s.astype(np.int32), r.astype(np.int32), w, n


def test_native_builds_and_falls_back_with_a_warning(tmp_path, monkeypatch):
    """The engine builds into the port's own build directory; a build that
    fails says so once (a RuntimeWarning) and leaves the numpy paths."""
    assert native.native_available()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_FLAGS", native._FLAGS + ["-no-such-flag"])
    with pytest.warns(RuntimeWarning, match="numpy fallback"):
        assert not native.native_available()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not native.native_available()  # tried once
    s, r, w, n = coo(np.random.default_rng(0), n=50)
    monkeypatch.setattr(jax_native, "_get_lib", lambda: None)
    for got, want in zip(native.coo_to_csr(r, s, n), jax_native.coo_to_csr(r, s, n)):
        same(got, want)


def test_coo_to_csr(rng, engine):
    s, r, w, n = coo(rng)
    for got, want in zip(native.coo_to_csr(r, s, n), jax_native.coo_to_csr(r, s, n)):
        same(got, want)
    indptr, indices, perm = native.coo_to_csr(r, s, n)
    assert indptr[-1] == len(s)
    np.testing.assert_array_equal(r[perm], np.repeat(np.arange(n), np.diff(indptr)))


@pytest.mark.parametrize("tile_dtype", [None, torch.bfloat16, torch.int8])
def test_bcsr_pack_matches(rng, engine, tile_dtype):
    """bcsr_pack (with and without dead tiles) and bcsr_pack_fused at every
    tile dtype give tpugraph's arrays; without the engine both raise and
    both return None, as tpugraph's."""
    import jax.numpy as jnp

    s, r, w, n = coo(rng, n=300)
    n_pad = 384
    jdt = {None: None, torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8}[tile_dtype]
    if engine == "numpy":
        for mod in (native, jax_native):
            with pytest.raises(RuntimeError, match="unavailable"):
                mod.bcsr_pack(r, s, w, n_pad, 128)
        assert native.bcsr_pack_fused(r, s, w, n_pad, 128, 2, tile_dtype) is None
        assert jax_native.bcsr_pack_fused(r, s, w, n_pad, 128, 2, jdt or np.float32) is None
        return
    for pad in (None, 40):
        for got, want in zip(native.bcsr_pack(r, s, w, n_pad, 128, pad),
                             jax_native.bcsr_pack(r, s, w, n_pad, 128, pad)):
            same(got, want)
    got = native.bcsr_pack_fused(r, s, w, n_pad, 128, 2, tile_dtype)
    want = jax_native.bcsr_pack_fused(r, s, w, n_pad, 128, 2, jdt or np.float32)
    tiles = got[0].view(torch.int16).numpy() if tile_dtype == torch.bfloat16 else got[0]
    want_tiles = np.asarray(want[0])
    if tile_dtype == torch.bfloat16:
        want_tiles = want_tiles.view(np.int16)
    same(tiles, want_tiles)
    for g, wv in zip(got[1:4], want[1:4]):
        same(g, wv)
    assert got[4] == want[4]


def test_khop_bfs_matches(rng, engine):
    s, r, w, n = coo(rng, n=120, p=0.02)
    indptr, indices, _ = native.coo_to_csr(r, s, n)
    for src in [0, 17, 119]:
        same(native.khop_bfs(indptr, indices, src, 3),
             jax_native.khop_bfs(indptr, indices, src, 3))


def test_khop_bfs_batch(rng, engine):
    s, r, w, n = coo(rng, n=100)
    indptr, indices, _ = native.coo_to_csr(r, s, n)
    srcs = np.array([3, 50, 99], np.int32)
    batch = native.khop_bfs_batch(indptr, indices, srcs, 2)
    same(batch, jax_native.khop_bfs_batch(indptr, indices, srcs, 2))
    for i, src in enumerate(srcs):
        same(batch[i], native.khop_bfs(indptr, indices, int(src), 2))


def test_sym_normalize_matches(rng, engine):
    s, r, w, n = coo(rng)
    same(native.sym_normalize(r, s, w, n), jax_native.sym_normalize(r, s, w, n))


def test_rcm_order_matches(rng, engine):
    n = 400
    src = np.arange(n, dtype=np.int64)
    dst = (src + rng.integers(1, 12, size=n)) % n
    shuf = rng.permutation(n).astype(np.int32)
    s = shuf[np.concatenate([src, dst])].astype(np.int32)
    r = shuf[np.concatenate([dst, src])].astype(np.int32)
    indptr, indices, _ = native.coo_to_csr(r, s, n)
    perm = native.rcm_order(indptr, indices)
    same(perm, jax_native.rcm_order(indptr, indices))
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    assert int(np.abs(inv[s] - inv[r]).max()) < int(np.abs(s.astype(np.int64) - r).max()) / 4


def test_rcm_order_engine_equals_fallback(rng, monkeypatch):
    """The port's C++ and numpy RCM give one order (tpugraph's test of its
    own fallback)."""
    s, r, w, n = coo(rng, n=120)
    indptr, indices, _ = native.coo_to_csr(r, s, n)
    got = native.rcm_order(indptr, indices)
    monkeypatch.setattr(native, "_get_lib", lambda: None)
    same(got, native.rcm_order(indptr, indices))


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_halo_plan_matches(rng, engine, n_dev):
    """build_halo_plan: every array and size equal tpugraph's on the same
    engine path; the raw native halo_plan too (None on numpy, as
    tpugraph's)."""
    a = (rng.random((96, 96)) < 0.08).astype(np.float32)
    a = np.triu(a, 1)
    a = a + a.T
    got = spmd.build_halo_plan(graph_from_dense(a), n_dev)
    want = jax_spmd.build_halo_plan(jax_graph_from_dense(a), n_dev)
    assert (got.shard_size, got.halo_size) == (want.shard_size, want.halo_size)
    for fld in ("send_idx", "sender_slot", "receivers_local", "weights"):
        same(getattr(got, fld), getattr(want, fld))
    s, r = np.nonzero(a)
    w = a[s, r]
    raw = native.halo_plan(s, r, w, 96 // n_dev, n_dev)
    raw_j = jax_native.halo_plan(s, r, w, 96 // n_dev, n_dev)
    if engine == "numpy":
        assert raw is None and raw_j is None
    else:
        for g_, w_ in zip(raw, raw_j):
            same(g_, w_)


def test_halo_plan_engine_equals_fallback(rng, monkeypatch):
    """The port's C++ and numpy halo plans are equal (tpugraph's
    ``test_halo_plan_native_matches_python``)."""
    a = (rng.random((96, 96)) < 0.08).astype(np.float32)
    a = np.triu(a, 1)
    g = graph_from_dense(a + a.T)
    p_native = spmd.build_halo_plan(g, 8)
    monkeypatch.setattr(native, "_get_lib", lambda: None)
    p_numpy = spmd.build_halo_plan(g, 8)
    assert p_native.halo_size == p_numpy.halo_size
    for fld in ("send_idx", "sender_slot", "receivers_local", "weights"):
        same(getattr(p_native, fld), getattr(p_numpy, fld))


def _two_community_graph(rng, n=400, intra=2400, inter=60):
    comm = np.zeros(n, np.int32)
    comm[n // 2:] = 1
    comm = comm[rng.permutation(n)]
    es, er = [], []
    for c in (0, 1):
        members = np.flatnonzero(comm == c)
        u = rng.choice(members, intra)
        v = rng.choice(members, intra)
        keep = u != v
        es.append(u[keep])
        er.append(v[keep])
    u = rng.choice(np.flatnonzero(comm == 0), inter)
    v = rng.choice(np.flatnonzero(comm == 1), inter)
    es.append(u)
    er.append(v)
    s = np.concatenate(es + er).astype(np.int32)
    r = np.concatenate(er + es).astype(np.int32)
    return s, r, np.ones(len(s), np.float32), comm


def test_label_prop_partition_matches(rng, engine):
    """The same engine path in both packages gives the same partition, the
    same moves and the same cut (C++ with C++, numpy with numpy), and the
    planted two communities come back."""
    n = 400
    s, r, w, comm = _two_community_graph(rng, n)
    _, inv = spmd.balance_partition(r, n, 2, weights=w)
    snake = (inv[:n] // (len(inv) // 2)).astype(np.int32)
    got = native.label_prop_partition(s, r, w, n, 2, snake, iters=30, slack=1.05)
    want = jax_native.label_prop_partition(s, r, w, n, 2, snake, iters=30, slack=1.05)
    same(got[0], want[0])
    assert got[1] == want[1] > 0
    cut, recv = native.partition_cut_stats(s, r, w, n, 2, got[0])
    cut_j, recv_j = jax_native.partition_cut_stats(s, r, w, n, 2, got[0])
    assert cut == cut_j
    same(recv, recv_j)
    assert cut < int((w != 0).sum()) * 0.2
    assert max((got[0] == comm).mean(), (got[0] != comm).mean()) > 0.9


def test_partition_cut_stats_engine_equals_fallback(rng, monkeypatch):
    n = 400
    s, r, w, _ = _two_community_graph(rng, n)
    assign = (rng.permutation(n) % 2).astype(np.int32)
    ref = native.partition_cut_stats(s, r, w, n, 2, assign)
    monkeypatch.setattr(native, "_get_lib", lambda: None)
    fb = native.partition_cut_stats(s, r, w, n, 2, assign)
    assert ref[0] == fb[0]
    same(ref[1], fb[1])


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_locality_partition_matches(rng, engine, n_dev):
    """locality_partition's perm and inv equal tpugraph's on the same engine
    path, and keep tpugraph's contract: inverse pairs, pad ids edge-free."""
    n = 400
    s, r, w, _ = _two_community_graph(rng, n)
    perm, inv = spmd.locality_partition(s, r, n, n_dev, weights=w)
    perm_j, inv_j = jax_spmd.locality_partition(s, r, n, n_dev, weights=w)
    same(perm, perm_j)
    same(inv, inv_j)
    assert len(perm) % n_dev == 0
    np.testing.assert_array_equal(perm[inv], np.arange(len(perm)))
    assert np.all(perm[np.unique(np.concatenate([inv[s], inv[r]]))] < n)
