"""The port's diffusion path against tpugraph's (Pallas in interpret mode on
the CPU, the set-up of tests/test_resident.py:189-314): ``sym_normalize``,
``pack_pair`` and ``DiffusionOperator.pair`` byte for byte, the plain
versions of B5 (spmm_pair_resident) and B6 (spmm_power_resident), and the
dense oracles of ``diffuse``.  The CUDA kernels are held against these
plain versions on a card in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpugraph.native as jax_native
from tpugraph.core.graph import graph_from_dense as jax_graph_from_dense
from tpugraph.ops import bcsr as jax_bcsr
from tpugraph.ops import diffusion as jax_diffusion
from tpugraph.ops import pallas_resident as jax_res
from tpugraph_torch.core import graph_from_dense
from tpugraph_torch.native import sym_normalize
from tpugraph_torch.ops import bcsr
from tpugraph_torch.ops import resident_kernels as rk
from tpugraph_torch.ops.diffusion import DiffusionOperator, diffuse

torch.set_num_threads(1)

N, B, D, KP = 64, 8, 128, 4
BF16_ULP = 2.0 ** -7   # one bf16 ulp, relative (8 significant bits)
JAX_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
          torch.int8: jnp.int8}


def _bytes(a):
    """Raw bytes and dtype name of a numpy / jax / torch array (bf16 too)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().tobytes(), \
            str(a.dtype).split(".")[1]
    a = np.asarray(a)
    return a.tobytes(), a.dtype.name


def _adjacency(seed, n=N, density=0.15):
    """A non-symmetric 0/1 adjacency and its (senders, receivers)."""
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < density).astype(np.float32)
    s, r = np.nonzero(a)
    return a, s.astype(np.int32), r.astype(np.int32)


def _pairs(s, r, w, tile_dtype, n_rows=N, n_cols=N):
    """The pair of A (n_cols -> n_rows) and A_t packed by both packages."""
    kw = {} if n_rows == n_cols else {"num_col_nodes": n_cols}
    kw_t = {} if n_rows == n_cols else {"num_col_nodes": n_rows}
    jdt = JAX_DT[tile_dtype]
    st_j = jax_res.stack_bcsr(jax_bcsr.bcsr_from_coo(
        s, r, w, n_rows, block=B, tile_dtype=jdt, device=False, **kw), 1, KP)
    stt_j = jax_res.stack_bcsr(jax_bcsr.bcsr_from_coo(
        r, s, w, n_cols, block=B, tile_dtype=jdt, device=False, **kw_t), 1, KP)
    st = rk.stack_bcsr(bcsr.bcsr_from_coo(s, r, w, n_rows, block=B,
                                          tile_dtype=tile_dtype, **kw), 1, KP)
    st_t = rk.stack_bcsr(bcsr.bcsr_from_coo(r, s, w, n_cols, block=B,
                                            tile_dtype=tile_dtype, **kw_t), 1, KP)
    return jax_res.pack_pair(st_j, stt_j), rk.pack_pair(st, st_t), (st, st_t)


def _assert_same_pair(p_j, p_t):
    for f in ("tiles", "col_blk", "rows"):
        assert _bytes(getattr(p_j, f)) == _bytes(getattr(p_t, f)), f
    assert tuple(np.asarray(p_j.tiles).shape) == tuple(p_t.tiles.shape)
    for f in ("t1", "num_nodes", "num_mid_nodes", "num_out_nodes", "block",
              "num_tiles"):
        assert getattr(p_j, f) == getattr(p_t, f), f


@pytest.mark.parametrize("engine", ["native", "numpy"])
def test_sym_normalize_byte_identical(engine, monkeypatch):
    """Duplicate edges, zero-weight padding edges and isolated nodes; both
    of tpugraph's implementations (the C++ engine where it loads, and its
    numpy fallback)."""
    if engine == "numpy":
        monkeypatch.setattr(jax_native, "_get_lib", lambda: None)
    rng = np.random.default_rng(3)
    n, e = 300, 4000
    r = rng.integers(0, 250, e).astype(np.int32)
    s = rng.integers(0, n, e).astype(np.int32)
    w = rng.random(e).astype(np.float32) * 3
    w[::7] = 0.0
    ref = jax_native.sym_normalize(r, s, w, n)
    got = sym_normalize(r, s, w, n)
    assert got.dtype == np.float32 and got.tobytes() == ref.tobytes()
    assert np.all(got[s >= 250] == 0)  # senders with no in-edges: deg 0


@pytest.mark.parametrize("tile_dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("rect", [False, True])
def test_pack_pair_byte_identical(tile_dtype, rect):
    """A non-symmetric pair, and a rectangular one (A maps 40 columns to
    64 rows, A_t back); the port's inverse indexes cover each half."""
    n_cols = 40 if rect else N
    rng = np.random.default_rng(5)
    _, s, r = _adjacency(7, density=0.15)
    keep = s < n_cols
    s, r = s[keep], r[keep]
    w = (rng.integers(1, 4, len(s)) if tile_dtype == torch.int8
         else rng.standard_normal(len(s))).astype(np.float32)
    p_j, p_t, (st, st_t) = _pairs(s, r, w, tile_dtype, N, n_cols)
    _assert_same_pair(p_j, p_t)
    assert torch.equal(p_t.row_ptr1, st.row_ptr)
    assert torch.equal(p_t.slots2, st_t.slots + p_t.t1)
    rows = torch.as_tensor(p_t.rows).long()
    for ptr, slots, lo in ((p_t.row_ptr1, p_t.slots1, 0),
                           (p_t.row_ptr2, p_t.slots2, p_t.t1)):
        assert int(ptr[-1]) == slots.numel()
        for rb in range(ptr.numel() - 1):
            seg = slots[ptr[rb]:ptr[rb + 1]].long()
            assert bool((seg >= lo).all()) and bool((rows[seg] == rb).all())


def test_pack_pair_rejects_bad_layouts():
    _, s, r = _adjacency(1)
    w = np.ones(len(s), np.float32)
    m = bcsr.bcsr_from_coo(s, r, w, N, block=B, tile_dtype=torch.int8)
    st1 = rk.stack_bcsr(m, 1, KP)
    with pytest.raises(ValueError, match="stack=1"):
        rk.pack_pair(rk.stack_bcsr(m, 2, KP), st1)
    with pytest.raises(ValueError, match="int4"):
        rk.pack_pair(rk.pack_stacked_int4(st1), st1)
    with pytest.raises(ValueError, match="blocks differ"):
        rk.pack_pair(st1, rk.stack_bcsr(bcsr.bcsr_from_coo(
            s, r, w, N, block=16, tile_dtype=torch.int8), 1, KP))
    rect = rk.stack_bcsr(bcsr.bcsr_from_coo(s, r, w, N, block=B,
                                            num_col_nodes=80), 1, KP)
    with pytest.raises(ValueError, match="A_t columns"):
        rk.pack_pair(st1, rect)


def _graphs(weights: str, seed=2, n=48):
    """A symmetric graph built by both packages: unit, small-integer or
    real weights."""
    rng = np.random.default_rng(seed)
    a = np.triu((rng.random((n, n)) < 0.2).astype(np.float32), 1)
    if weights == "int":
        a = a * rng.integers(1, 5, (n, n))
    elif weights == "real":
        a = a * rng.uniform(0.5, 2.0, (n, n))
    a = (a + a.T).astype(np.float32)
    return a, jax_graph_from_dense(a), graph_from_dense(a)


@pytest.mark.parametrize("normalize,weights,tile_dtype", [
    (True, "unit", torch.bfloat16),
    (False, "int", torch.int8),
    (False, "real", torch.bfloat16),
])
def test_diffusion_operator_layout_matches(normalize, weights, tile_dtype):
    """The operator's pair (sym_normalize, tile dtype choice, k_pack=128
    padding) and hop_scale are tpugraph's exactly."""
    _, g_j, g_t = _graphs(weights)
    op_j = jax_diffusion.DiffusionOperator(g_j, block=B, normalize=normalize)
    op = DiffusionOperator(g_t, block=B, normalize=normalize, device="cpu")
    assert op.pair.tiles.dtype == tile_dtype
    _assert_same_pair(op_j.pair, op.pair)
    assert op.hop_scale == op_j.hop_scale
    assert op.num_nodes == op_j.num_nodes and op.k_pack == op_j.k_pack


def _bf16_or_f32(x, dtype):
    xj = jnp.asarray(x)
    xt = torch.from_numpy(x)
    if dtype == torch.bfloat16:
        return xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    return xj, xt


def _check(got, ref, tile_dtype, n_roundings):
    """int8 tiles with x rounded to bf16 make every product and every f32
    sum here exact, so the plain version is bit for bit; bf16 tiles hold to
    one bf16 ulp of max|ref| per rounding point the values passed."""
    got = got.float().numpy()
    if tile_dtype == torch.int8:
        np.testing.assert_array_equal(got, ref)
    else:
        tol = n_roundings * BF16_ULP * np.abs(ref).max()
        assert np.abs(got - ref).max() <= tol


def _pair_case(tile_dtype, seed):
    rng = np.random.default_rng(seed)
    _, s, r = _adjacency(seed)
    w = (rng.integers(1, 4, len(s)) if tile_dtype == torch.int8
         else rng.standard_normal(len(s))).astype(np.float32)
    p_j, p_t, _ = _pairs(s, r, w, tile_dtype)
    x = rng.standard_normal((N, D)).astype(np.float32)
    return p_j, p_t.to("cpu"), x


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile_dtype", [torch.int8, torch.bfloat16])
def test_pair_plain_matches_pallas(tile_dtype, x_dtype, out_dtype):
    p_j, p_t, x = _pair_case(tile_dtype, seed=11)
    xj, xt = _bf16_or_f32(x, x_dtype)
    ref = np.asarray(jax_res.spmm_pair_resident(
        p_j, xj, k_pack=KP, interpret=True,
        out_dtype=JAX_DT[out_dtype]).astype(jnp.float32))
    got = rk.spmm_pair_resident(p_t, xt, k_pack=KP, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (N, D)
    # rounding points: x (f32 x only), y, the output (bf16 only)
    _check(got, ref, tile_dtype, 1 + (x_dtype == torch.float32)
           + (out_dtype == torch.bfloat16))


@pytest.mark.parametrize("hops,hop_scale", [(1, 1.0), (3, 0.125), (3, 1.0)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile_dtype", [torch.int8, torch.bfloat16])
def test_power_plain_matches_pallas(tile_dtype, x_dtype, out_dtype, hops,
                                    hop_scale):
    p_j, p_t, x = _pair_case(tile_dtype, seed=12)
    xj, xt = _bf16_or_f32(x, x_dtype)
    ref = np.asarray(jax_res.spmm_power_resident(
        p_j, xj, hops=hops, k_pack=KP, interpret=True,
        out_dtype=JAX_DT[out_dtype], hop_scale=hop_scale).astype(jnp.float32))
    got = rk.spmm_power_resident(p_t, xt, hops, k_pack=KP, out_dtype=out_dtype,
                                 hop_scale=hop_scale)
    assert got.dtype == out_dtype and got.shape == (N, D)
    # rounding points: x (f32 x only), y of every hop, every hop boundary,
    # the output (bf16 only)
    _check(got, ref, tile_dtype, (x_dtype == torch.float32) + hops
           + (hops - 1) + (out_dtype == torch.bfloat16))


def _int8_pair(seed):
    a, s, r = _adjacency(seed)
    w = np.ones(len(s), np.float32)
    st = rk.stack_bcsr(bcsr.bcsr_from_coo(s, r, w, N, block=B,
                                          tile_dtype=torch.int8), 1, KP)
    st_t = rk.stack_bcsr(bcsr.bcsr_transpose_host(s, r, w, N, block=B,
                                                  tile_dtype=torch.int8), 1, KP)
    return a, st.to("cpu"), st_t.to("cpu"), rk.pack_pair(st, st_t).to("cpu")


def test_pair_matches_two_call_and_dense():
    """tests/test_resident.py:189 on the port: the pair equals B4 twice
    (y rounded to bf16 between) and the dense a @ (a^T @ x)."""
    a, st, st_t, pr = _int8_pair(0)
    rng = np.random.default_rng(0)
    xb = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32)
                          ).to(torch.bfloat16)
    dx = rk.spmm_pair_resident(pr, xb, k_pack=KP).float()
    y = rk.spmm_stacked_resident_plain(st, xb, out_dtype=torch.bfloat16)
    dx_ref = rk.spmm_stacked_resident_plain(st_t, y)
    np.testing.assert_allclose(dx, dx_ref, rtol=2e-2, atol=0.3)
    dx32 = rk.spmm_pair_resident(pr, xb, k_pack=KP, out_dtype=torch.float32)
    np.testing.assert_array_equal(dx32, dx_ref)  # exact: int8 tiles, bf16 x
    dense = a @ (a.T @ xb.float().numpy())
    np.testing.assert_allclose(dx, dense, rtol=3e-2, atol=0.5)


def test_power_matches_repeated_pairs():
    """tests/test_resident.py:238 on the port: hops=3 in one call equals
    three pairs with the scaled bf16 rounding between them."""
    _, _, _, pr = _int8_pair(1)
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal((N, D)) * 0.1).astype(np.float32)
                         ).to(torch.bfloat16)
    y3 = rk.spmm_power_resident(pr, x, hops=3, k_pack=KP, hop_scale=0.125)
    ref = x
    for _ in range(3):
        ref = rk.spmm_pair_resident(pr, ref, k_pack=KP)
        ref = (ref.float() * 0.125).to(torch.bfloat16)
    np.testing.assert_allclose(y3.float(), ref.float(), rtol=3e-2, atol=1e-3)


def test_diffuse_matches_dense_propagation():
    """tests/test_resident.py:275 on the port: ``diffuse`` against the dense
    (S^T S)^H x with the sym-normalized matrix, and the unnormalized
    operator against (a^T a)^2 x times hop_scale^2."""
    rng = np.random.default_rng(4)
    n, d, hops = 48, 128, 3
    a = np.triu((rng.random((n, n)) < 0.2).astype(np.float32), 1)
    a = a + a.T
    g = graph_from_dense(a)
    x = (rng.standard_normal((n, d)) * 0.3).astype(np.float32)

    y = diffuse(g, torch.from_numpy(x), hops, block=B, device="cpu")
    assert y.shape == (n, d) and y.dtype == torch.bfloat16
    n_pad = g.num_nodes_padded
    a_pad = np.zeros((n_pad, n_pad), np.float32)
    a_pad[:n, :n] = a
    deg = a_pad.sum(1)
    inv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
    s_hat = a_pad * inv[:, None] * inv[None, :]
    x_pad = np.zeros((n_pad, d), np.float32)
    x_pad[:n] = x
    ref = x_pad
    for _ in range(hops):
        ref = s_hat.T @ (s_hat @ ref)
    np.testing.assert_allclose(y.float(), ref[:n], rtol=6e-2, atol=2e-2)

    op = DiffusionOperator(g, block=B, normalize=False, device="cpu")
    assert op.pair.tiles.dtype == torch.int8
    x_p = torch.zeros((op.num_nodes, d))
    x_p[:n] = torch.from_numpy(x)
    y2 = op(x_p, 2).float().numpy()
    ref2 = x_pad
    for _ in range(2):
        ref2 = (a_pad.T @ (a_pad @ ref2)) * op.hop_scale
    np.testing.assert_allclose(y2[:n], ref2[:n], rtol=6e-2, atol=2e-2)


def test_pair_wrappers_reject_bad_inputs():
    _, _, _, pr = _int8_pair(2)
    x = torch.ones((N, 8))
    with pytest.raises(ValueError, match="k_pack"):
        rk.spmm_pair_resident(pr, x, k_pack=3)
    with pytest.raises(ValueError):
        rk.spmm_pair_resident(pr, torch.ones((N - 8, 8)), k_pack=KP)
    with pytest.raises(ValueError):
        rk.spmm_pair_resident(pr, x.double(), k_pack=KP)
    with pytest.raises(ValueError, match="out_dtype"):
        rk.spmm_pair_resident(pr, x, k_pack=KP, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="hops"):
        rk.spmm_power_resident(pr, x, 0, k_pack=KP)
    _, s, r = _adjacency(3)
    w = np.ones(len(s), np.float32)
    a_t = bcsr.bcsr_from_coo(r[s < 40], s[s < 40], w[s < 40], 40,
                             block=B, num_col_nodes=N)  # 64 -> 40 rows
    rect = rk.pack_pair(rk.stack_bcsr(bcsr.bcsr_from_coo(s, r, w, N, block=B),
                                      1, KP), rk.stack_bcsr(a_t, 1, KP))
    with pytest.raises(ValueError, match="square"):
        rk.spmm_power_resident(rect.to("cpu"), x, 2, k_pack=KP)
    assert rk.spmm_pair_resident(rect.to("cpu"), x, k_pack=KP).shape == (40, 8)
    with pytest.raises(ValueError, match="no pair kernels"):
        rk.spmm_pair_resident(pr.to("meta"), x.to("meta"), k_pack=KP)


@pytest.mark.parametrize("normalize", [True, False])
def test_diffuse_block8_matches_tpugraph(normalize):
    """``diffuse`` (sym-normalized, bf16 tiles, 3 hops) and the unnormalized
    ``DiffusionOperator`` (int8 tiles, 2 hops) at block 8, as
    tests/test_resident.py:288 and :307 run tpugraph's, against tpugraph's
    on the same graph and x: int8 bit for bit, bf16 within one bf16 ulp of
    max|ref| per rounding point (2 a hop and the output)."""
    rng = np.random.default_rng(5)
    n, d = 48, 128
    a = np.triu((rng.random((n, n)) < 0.2).astype(np.float32), 1)
    a = a + a.T
    g_j, g_t = jax_graph_from_dense(a), graph_from_dense(a)
    x = (rng.standard_normal((n, d)) * 0.3).astype(np.float32)
    if normalize:
        hops, tile_dtype = 3, torch.bfloat16
        ref = jax_diffusion.diffuse(g_j, jnp.asarray(x), hops, block=8)
        got = diffuse(g_t, torch.from_numpy(x), hops, block=8, device="cpu")
    else:
        hops, tile_dtype = 2, torch.int8
        op_j = jax_diffusion.DiffusionOperator(g_j, block=8, normalize=False)
        op = DiffusionOperator(g_t, block=8, normalize=False, device="cpu")
        assert op.pair.tiles.dtype == tile_dtype and op.hop_scale == op_j.hop_scale
        x_p = np.zeros((op.num_nodes, d), np.float32)
        x_p[:n] = x
        ref = op_j(jnp.asarray(x_p), hops)
        got = op(torch.from_numpy(x_p), hops)
    ref = np.asarray(ref.astype(jnp.float32))
    assert tuple(got.shape) == ref.shape and got.dtype == torch.bfloat16
    _check(got, ref, tile_dtype, 2 * hops + 1)
