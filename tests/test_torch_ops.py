"""The port's BCSR packer, B1 (spmm_bcsr), B2 (sddmm_bcsr) and B3
(spmm_bcsr_packed) against tpugraph (packers byte for byte, Pallas kernels
in interpret mode on the CPU).  The CUDA kernels are held against these
plain versions on a card in tests/test_torch_cuda.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpugraph.ops import bcsr as jax_bcsr
from tpugraph.ops import pallas_spmm as jax_spmm
from tpugraph_torch.ops import bcsr, bcsr_kernels

torch.set_num_threads(1)

TOL = 1e-5  # float32 sums of <= 3 tiles x 128 products of O(1) values


def _case(n_rows, n_cols, d, seed):
    """Random block-sparse matrix (with duplicate edges and an empty row
    block) plus x / dy, packed by both packages."""
    rng = np.random.default_rng(seed)
    e = 2000
    s = rng.integers(0, n_cols, e).astype(np.int32)
    r = rng.integers(0, min(n_rows, 256), e).astype(np.int32)
    w = rng.standard_normal(e).astype(np.float32)
    kw = {} if n_rows == n_cols else {"num_col_nodes": n_cols}
    m_j = jax_bcsr.bcsr_from_coo(s, r, w, n_rows, block=128, **kw)
    m_t = bcsr.bcsr_from_coo(s, r, w, n_rows, block=128, **kw).to("cpu")
    x = rng.standard_normal((m_t.num_nodes, d)).astype(np.float32)
    dy = rng.standard_normal((m_t.num_row_nodes, d)).astype(np.float32)
    return m_j, m_t, x, dy


def _as_bytes(a):
    """(bytes, dtype name) of a numpy / jax / torch array, bf16 included."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy().tobytes(), str(a.dtype).split(".")[1]
    a = np.asarray(a)
    return a.tobytes(), a.dtype.name


@pytest.mark.parametrize("tile_dtype", [None, torch.int8, torch.bfloat16])
@pytest.mark.parametrize("pad_rows_to", [None, 2, 4])
def test_packer_tile_dtype_and_pad_rows_byte_identical(tile_dtype, pad_rows_to):
    """bcsr_from_coo / bcsr_transpose_host with tile_dtype and pad_rows_to
    give tpugraph's device=False arrays byte for byte: int8 is
    clip(rint(sum)) (weights here reach +-300 after duplicate sums) and
    bf16 rounds to nearest even."""
    rng = np.random.default_rng(7)
    n, e = 500, 3000
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, 300, e).astype(np.int32)  # empty row blocks 3..
    w = (rng.standard_normal(e) * 80).astype(np.float32)
    w[::11] = 0.0
    jdt = {None: None, torch.int8: jnp.int8, torch.bfloat16: jnp.bfloat16}
    for fn in ("bcsr_from_coo", "bcsr_transpose_host"):
        m_j = getattr(jax_bcsr, fn)(s, r, w, n, block=128,
                                    tile_dtype=jdt[tile_dtype],
                                    pad_rows_to=pad_rows_to, device=False)
        m_t = getattr(bcsr, fn)(s, r, w, n, block=128, tile_dtype=tile_dtype,
                                pad_rows_to=pad_rows_to)
        for f in ("tiles", "col_blk", "row_ptr", "row_of"):
            assert _as_bytes(getattr(m_j, f)) == _as_bytes(getattr(m_t, f)), f
        assert tuple(m_t.tiles.shape) == np.asarray(m_j.tiles).shape
        if pad_rows_to:
            assert np.all(np.diff(m_t.row_ptr) % pad_rows_to == 0)


def test_pad_rows_tile_counts_and_k_pack_choice():
    rng = np.random.default_rng(8)
    n, e = 640, 2500
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, 400, e).astype(np.int32)
    w = np.where(rng.random(e) < 0.1, 0.0, 1.0).astype(np.float32)
    m_j = jax_bcsr.bcsr_from_coo(s, r, w, n, block=128, device=False)
    m_t = bcsr.bcsr_from_coo(s, r, w, n, block=128)
    for k in (2, 3, 4):
        p_j = jax_bcsr.bcsr_pad_rows(m_j, k)
        for tiles in (m_t.tiles, torch.from_numpy(m_t.tiles)):
            p_t = bcsr.bcsr_pad_rows(bcsr.BCSR(tiles, m_t.col_blk, m_t.row_ptr,
                                               m_t.row_of, m_t.num_nodes, 128), k)
            for f in ("tiles", "col_blk", "row_ptr", "row_of"):
                a, b = np.asarray(getattr(p_j, f)), getattr(p_t, f)
                b = b.numpy() if isinstance(b, torch.Tensor) else b
                np.testing.assert_array_equal(a, b, err_msg=f)
        assert bcsr.choose_k_pack(m_t) == jax_bcsr.choose_k_pack(m_j)
    for weights in (None, w):
        np.testing.assert_array_equal(
            bcsr.coo_tile_counts(s, r, n, block=128, weights=weights),
            jax_bcsr.coo_tile_counts(s, r, n, block=128, weights=weights))
    for cnt in ([0, 0, 0], [1, 1, 2], [4, 4, 4, 0], [5, 6, 7, 9, 0, 30],
                [3, 3, 1, 1, 1], [20, 20, 20], [2, 9, 9, 9, 1]):
        for ovh in (1.2, 1.05):
            assert bcsr.choose_k_pack_counts(np.array(cnt), ovh) == \
                jax_bcsr.choose_k_pack_counts(np.array(cnt), ovh), (cnt, ovh)


@pytest.mark.parametrize("k_pack", [2, 4])
def test_spmm_packed_plain_matches_pallas(k_pack):
    """B3's plain version on the k_pack-padded layout against
    spmm_bcsr_packed in interpret mode; 1e-5 (f32, order only)."""
    rng = np.random.default_rng(k_pack)
    n, d = 512, 24
    s = rng.integers(0, n, 2500).astype(np.int32)
    r = rng.integers(0, 300, 2500).astype(np.int32)
    w = rng.standard_normal(2500).astype(np.float32)
    m_j = jax_bcsr.bcsr_from_coo(s, r, w, n, block=128, pad_rows_to=k_pack)
    m_t = bcsr.bcsr_from_coo(s, r, w, n, block=128, pad_rows_to=k_pack).to("cpu")
    x = rng.standard_normal((n, d)).astype(np.float32)
    ref = np.asarray(jax_spmm.spmm_bcsr_packed(
        m_j, jnp.asarray(_pad_lanes(x)), k_pack=k_pack, interpret=True))[:, :d]
    y = bcsr_kernels.spmm_bcsr_packed(m_t, torch.from_numpy(x), k_pack).numpy()
    np.testing.assert_allclose(y, ref, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(y[384:], 0.0)  # the empty row block
    with pytest.raises(ValueError, match="k_pack"):
        bcsr_kernels.spmm_bcsr_packed(m_t, torch.from_numpy(x), 3)


def test_bcsr_matvec_k_pack_grad_matches_jax():
    """bcsr_matvec(k_pack=4) runs forward and backward on the packed
    layout: the same value and x-gradient as jax.grad through
    tpugraph's custom VJP; 1e-5 (order only)."""
    import jax

    rng = np.random.default_rng(12)
    n, d = 384, 128
    s = rng.integers(0, n, 1500).astype(np.int32)
    r = rng.integers(0, n, 1500).astype(np.int32)
    w = rng.standard_normal(1500).astype(np.float32)
    args = (s, r, w, n)
    m_j = jax_bcsr.bcsr_from_coo(*args, block=128, pad_rows_to=4)
    mt_j = jax_bcsr.bcsr_transpose_host(*args, block=128, pad_rows_to=4)
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)

    def f(xx):
        return jnp.sum(jax_spmm.bcsr_matvec(m_j, mt_j, xx, interpret=True,
                                            k_pack=4) * c)

    ref_y = np.asarray(jax_spmm.bcsr_matvec(m_j, mt_j, jnp.asarray(x),
                                            interpret=True, k_pack=4))
    ref_dx = np.asarray(jax.grad(f)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bcsr_kernels.bcsr_matvec(
        bcsr.bcsr_from_coo(*args, block=128, pad_rows_to=4).to("cpu"),
        bcsr.bcsr_transpose_host(*args, block=128, pad_rows_to=4).to("cpu"),
        xt, k_pack=4)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(c))
    np.testing.assert_allclose(y.detach().numpy(), ref_y, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dx.numpy(), ref_dx, rtol=TOL, atol=TOL)


def test_make_bcsr_matvec_matches_jax():
    """make_bcsr_matvec's closure: tpugraph's in interpret mode, forward and
    the gradient of sum(y^2) (tests/test_pallas.py:81's case)."""
    import jax

    rng = np.random.default_rng(0)
    n = 120
    a = (rng.random((n, n)) < 0.02).astype(np.float32)
    a = np.triu(a, 1)
    a = a + a.T
    s, r = np.nonzero(a)
    w = rng.random(len(s)).astype(np.float32)
    dense = np.zeros((n, n), np.float32)
    dense[r, s] = w
    w = ((dense + dense.T) / 2)[r, s]
    args = (s.astype(np.int32), r.astype(np.int32), w, n)
    mv_j = jax_spmm.make_bcsr_matvec(jax_bcsr.bcsr_from_coo(*args),
                                     jax_bcsr.bcsr_transpose_host(*args),
                                     interpret=True)
    mv = bcsr_kernels.make_bcsr_matvec(bcsr.bcsr_from_coo(*args).to("cpu"),
                                       bcsr.bcsr_transpose_host(*args).to("cpu"))
    x = rng.standard_normal((128, 128)).astype(np.float32)
    ref_y = np.asarray(mv_j(jnp.asarray(x)))
    ref_dx = np.asarray(jax.grad(lambda xx: jnp.sum(mv_j(xx) ** 2))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = mv(xt)
    (dx,) = torch.autograd.grad(torch.sum(y ** 2), xt)
    np.testing.assert_allclose(y.detach().numpy(), ref_y, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dx.numpy(), ref_dx, rtol=TOL, atol=TOL)


def _pad_lanes(a):
    """tpugraph's kernels take D padded to a multiple of 128."""
    return np.pad(a, ((0, 0), (0, (-a.shape[1]) % 128)))


@pytest.mark.parametrize("n_rows,n_cols,d", [(384, 384, 20), (384, 256, 128)])
def test_spmm_sddmm_plain_match_pallas(n_rows, n_cols, d):
    m_j, m_t, x, dy = _case(n_rows, n_cols, d, seed=n_rows + n_cols + d)
    y_ref = np.asarray(jax_spmm.spmm_bcsr(m_j, jnp.asarray(_pad_lanes(x))))[:, :d]
    y = bcsr_kernels.spmm_bcsr(m_t, torch.from_numpy(x)).numpy()
    assert y.shape == (m_t.num_row_nodes, d)
    np.testing.assert_allclose(y, y_ref, rtol=TOL, atol=TOL)
    # the empty row block (rows >= 256) is written as zeros
    np.testing.assert_array_equal(y[256:], 0.0)

    g_ref = np.asarray(jax_spmm.sddmm_bcsr(
        m_j, jnp.asarray(_pad_lanes(dy)), jnp.asarray(_pad_lanes(x))))
    g = bcsr_kernels.sddmm_bcsr(m_t, torch.from_numpy(dy),
                                torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(g, g_ref, rtol=TOL, atol=TOL)
    assert np.all(g[m_t.tiles.numpy() == 0] == 0)
    assert set(bcsr_kernels.LAUNCHES.values()) == {0}  # CPU: plain versions


def test_autograd_wrappers_match_dense():
    """bcsr_matvec and bcsr_matvec_dw_pair give the dense gradients:
    dx = A^T g, and dA = g x^T on the tile support."""
    m_j, m_t, x, _ = _case(256, 256, 16, seed=3)
    dense = jax_bcsr.bcsr_to_dense(m_j)
    tp = bcsr.bcsr_transpose_plan(m_t).to("cpu")
    m_tr = bcsr.BCSR(bcsr.transpose_tiles(m_t.tiles, tp), tp.col_blk,
                     tp.row_ptr, tp.row_of, tp.num_nodes, tp.block)
    xt = torch.from_numpy(x).requires_grad_(True)
    g = torch.randn(256, 16, generator=torch.Generator().manual_seed(0))

    y = bcsr_kernels.bcsr_matvec(m_t, m_tr, xt)
    (dx,) = torch.autograd.grad(y, xt, g)
    np.testing.assert_allclose(y.detach(), dense @ x, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dx, dense.T @ g.numpy(), rtol=TOL, atol=TOL)

    tiles = m_t.tiles.clone().requires_grad_(True)
    y2 = bcsr_kernels.bcsr_matvec_dw_pair(
        dataclasses.replace(m_t, tiles=tiles), m_tr, xt)
    dtiles, dx2 = torch.autograd.grad(y2, (tiles, xt), g)
    np.testing.assert_allclose(dx2, dx, rtol=TOL, atol=TOL)
    ref = bcsr_kernels.sddmm_bcsr_plain(m_t, g, xt.detach())
    np.testing.assert_allclose(dtiles, ref, rtol=TOL, atol=TOL)


def test_wrappers_reject_bad_inputs():
    _, m_t, x, _ = _case(256, 256, 8, seed=4)
    with pytest.raises(ValueError):
        bcsr_kernels.spmm_bcsr(m_t, torch.from_numpy(x[:-1]))
    with pytest.raises(ValueError):
        bcsr_kernels.spmm_bcsr(m_t, torch.from_numpy(x).double())
    with pytest.raises(ValueError):
        bcsr_kernels.spmm_bcsr(m_t, torch.from_numpy(x).t().contiguous().t())
    meta = dataclasses.replace(
        m_t, tiles=m_t.tiles.to("meta"), col_blk=m_t.col_blk.to("meta"),
        row_ptr=m_t.row_ptr.to("meta"), row_of=m_t.row_of.to("meta"))
    with pytest.raises(ValueError, match="no spmm_bcsr kernel"):
        bcsr_kernels.spmm_bcsr(meta, torch.from_numpy(x).to("meta"))
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="CUDA device only"):
        bcsr_kernels._sddmm_bcsr_crossover(m_t, xt, xt, 64)


def _no_row_blocks(device):
    """A BCSR with zero row blocks and zero tiles over 128 columns."""
    i32 = dict(dtype=torch.int32, device=device)
    m = bcsr.BCSR(tiles=torch.zeros((0, 128, 128), device=device),
                  col_blk=torch.zeros((0,), **i32),
                  row_ptr=torch.zeros((1,), **i32),
                  row_of=torch.zeros((0,), **i32), num_nodes=128, block=128)
    x = torch.ones((128, 8), device=device)
    return m, x, torch.zeros((0, 8), device=device)


def test_plain_kernels_no_row_blocks():
    m, x, dy = _no_row_blocks("cpu")
    assert bcsr_kernels.spmm_bcsr(m, x).shape == (0, 8)
    assert bcsr_kernels.sddmm_bcsr(m, dy, x).shape == (0, 128, 128)
    assert bcsr_kernels.spmm_bcsr_packed(m, x, 4).shape == (0, 8)


JAX_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
          torch.int8: jnp.int8}
BF16_ULP = 2.0 ** -7  # one bf16 ulp, relative (8 significant bits)


def _typed_case(tile_dtype, pad_rows_to, seed):
    """384 nodes, block 128, rows < 256 (an empty row block), tiles at
    ``tile_dtype`` (int8: integer weights, some summed past one), D = 128."""
    rng = np.random.default_rng(seed)
    n, e = 384, 2000
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, 256, e).astype(np.int32)
    w = (rng.integers(-3, 4, e) if tile_dtype == torch.int8
         else rng.standard_normal(e)).astype(np.float32)
    kw = dict(block=128, pad_rows_to=pad_rows_to)
    m_j = jax_bcsr.bcsr_from_coo(s, r, w, n, tile_dtype=JAX_DT[tile_dtype],
                                 device=False, **kw)
    m_t = bcsr.bcsr_from_coo(s, r, w, n, tile_dtype=tile_dtype, **kw).to("cpu")
    x = rng.standard_normal((n, 128)).astype(np.float32)
    dy = rng.standard_normal((n, 128)).astype(np.float32)
    return m_j, m_t, x, dy


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile_dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("k_pack", [1, 4])
def test_spmm_dtype_options_match_pallas(k_pack, tile_dtype, x_dtype, out_dtype):
    """B1 (k_pack 1) and B3 (k_pack 4) for every tile x x x out dtype JAX
    takes, against spmm_bcsr / spmm_bcsr_packed in interpret mode (their
    cast variants for a bf16 output): 1e-5 * max|ref| * sqrt(K) for f32
    sums of K = 3 * 128 products in another order, plus one bf16 ulp of
    the value for a bf16 output."""
    m_j, m_t, x, _ = _typed_case(tile_dtype, k_pack if k_pack > 1 else None,
                                 seed=k_pack + 3 * len(str(tile_dtype)))
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if x_dtype == torch.bfloat16:
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    if k_pack > 1:
        ref = jax_spmm.spmm_bcsr_packed(m_j, xj, k_pack=k_pack, interpret=True,
                                        out_dtype=JAX_DT[out_dtype])
        y = bcsr_kernels.spmm_bcsr_packed(m_t, xt, k_pack, out_dtype=out_dtype)
    else:
        ref = jax_spmm.spmm_bcsr(m_j, xj, interpret=True,
                                 out_dtype=JAX_DT[out_dtype])
        y = bcsr_kernels.spmm_bcsr(m_t, xt, out_dtype=out_dtype)
    assert y.dtype == out_dtype and y.shape == (384, 128)
    ref = np.asarray(ref.astype(jnp.float32))
    tol = TOL * np.abs(ref).max() * np.sqrt(3 * 128)
    if out_dtype == torch.bfloat16:
        tol = tol + BF16_ULP * np.abs(ref)
    assert np.all(np.abs(y.float().numpy() - ref) <= tol)
    np.testing.assert_array_equal(y[256:].float(), 0.0)


def _support_case(tile_dtype, d, seed):
    """A rectangular matrix (384 row nodes, 256 column nodes, rows < 256)
    at ``tile_dtype`` with explicit zero entries inside live tiles (zero
    weights, and an edge pair at (7, 5) that cancels) and dead tiles
    (``pad_rows_to=2`` and the empty row block), plus x and dy."""
    rng = np.random.default_rng(seed)
    n_rows, n_cols, e = 384, 256, 1500
    s = rng.integers(0, n_cols, e)
    r = rng.integers(0, 256, e)
    keep = ~((r == 7) & (s == 5))
    w = (rng.integers(-3, 4, e) if tile_dtype == torch.int8
         else rng.standard_normal(e))
    w[::7] = 0.0
    s = np.append(s[keep], [5, 5]).astype(np.int32)
    r = np.append(r[keep], [7, 7]).astype(np.int32)
    w = np.append(w[keep], [2.0, -2.0]).astype(np.float32)
    kw = dict(block=128, pad_rows_to=2, num_col_nodes=n_cols)
    m_j = jax_bcsr.bcsr_from_coo(s, r, w, n_rows, tile_dtype=JAX_DT[tile_dtype],
                                 device=False, **kw)
    m_t = bcsr.bcsr_from_coo(s, r, w, n_rows, tile_dtype=tile_dtype, **kw).to("cpu")
    x = rng.standard_normal((n_cols, d)).astype(np.float32)
    dy = rng.standard_normal((n_rows, d)).astype(np.float32)
    return m_j, m_t, x, dy


@pytest.mark.parametrize("d", [10, 20, 128])
@pytest.mark.parametrize("tile_dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_sddmm_support_plain_matches_plain_and_pallas(tile_dtype, d):
    """The support-driven plain B2 (the kernel's sparse branch: one dot a
    nonzero, +0.0 elsewhere) equals the dense-masked plain version and
    JAX's kernel in interpret mode (D zero-padded to 128 lanes, which
    changes no dot): 1e-5 * max|ref| * sqrt(D), f32 sums in another
    order."""
    m_j, m_t, x, dy = _support_case(tile_dtype, d, seed=d)
    tiles = m_t.tiles
    dead = (tiles == 0).flatten(1).all(1)
    assert bool(dead.any()) and bool((~dead).any())
    assert tiles.shape[0] % 2 == 0 and m_t.num_nodes == 256
    t0 = int(m_t.row_ptr[0])  # tile (row block 0, column block 0)
    assert int(m_t.col_blk[t0]) == 0 and float(tiles[t0, 7, 5]) == 0.0
    dyt, xt = torch.from_numpy(dy), torch.from_numpy(x)
    g = bcsr_kernels.sddmm_bcsr_support_plain(m_t, dyt, xt)
    assert g.dtype == torch.float32 and g.shape == tiles.shape
    ref_plain = bcsr_kernels.sddmm_bcsr_plain(m_t, dyt, xt).numpy()
    ref_jax = np.asarray(jax_spmm.sddmm_bcsr(
        m_j, jnp.asarray(_pad_lanes(dy)), jnp.asarray(_pad_lanes(x)),
        interpret=True))
    for ref in (ref_plain, ref_jax):
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=TOL * np.abs(ref).max() * np.sqrt(d))
    off = (tiles == 0).numpy()
    assert np.all(g.numpy()[off] == 0) and not np.any(np.signbit(g.numpy()[off]))
    assert bool((g[~(tiles == 0)] != 0).all())  # random dots are not 0


@pytest.mark.parametrize("tile_dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_sddmm_support_dtypes_match_pallas(tile_dtype):
    """B2 reads only the support of bf16 / int8 tiles; dy, x and the
    output stay f32 (1e-5 * max|ref| * sqrt(128))."""
    m_j, m_t, x, dy = _typed_case(tile_dtype, None, seed=9)
    ref = np.asarray(jax_spmm.sddmm_bcsr(m_j, jnp.asarray(dy), jnp.asarray(x),
                                         interpret=True))
    g = bcsr_kernels.sddmm_bcsr(m_t, torch.from_numpy(dy), torch.from_numpy(x))
    assert g.dtype == torch.float32
    np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                               atol=TOL * np.abs(ref).max() * np.sqrt(128))
    assert np.all(g.numpy()[(m_t.tiles == 0).numpy()] == 0)
    with pytest.raises(ValueError):
        bcsr_kernels.sddmm_bcsr(m_t, torch.from_numpy(dy).bfloat16(),
                                torch.from_numpy(x))


def _support_spmm_case(tile_dtype, block, k_pack, seed):
    """Three row blocks at ``block`` whose last is empty (rows < 2 * block),
    tiles at ``tile_dtype`` (int8 weights in [-127, 127]), row blocks padded
    to ``k_pack`` with dead tiles; packed by both packages."""
    rng = np.random.default_rng(seed)
    n, e = 3 * block, 40 * block
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, 2 * block, e).astype(np.int32)
    w = (rng.integers(-127, 128, e) if tile_dtype == torch.int8
         else rng.standard_normal(e)).astype(np.float32)
    kw = dict(block=block, pad_rows_to=k_pack if k_pack > 1 else None)
    m_j = jax_bcsr.bcsr_from_coo(s, r, w, n, tile_dtype=JAX_DT[tile_dtype],
                                 device=False, **kw)
    m_t = bcsr.bcsr_from_coo(s, r, w, n, tile_dtype=tile_dtype, **kw).to("cpu")
    return m_j, m_t


@pytest.mark.parametrize("k_pack", [1, 4])
@pytest.mark.parametrize("block", [64, 128, 256])
@pytest.mark.parametrize("tile_dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_spmm_support_plain_matches_plain_and_pallas(tile_dtype, block, k_pack):
    """The kernel-order plain B1/B3 (nonzeros gathered in (row block, tile,
    row, k) order, one index_add_) against spmm_bcsr_plain /
    spmm_bcsr_packed_plain for every x and out dtype at D = 10, 20, 128
    and 130, and against JAX's kernel in interpret mode at D = 20 (padded
    to 128 lanes) for f32 and bf16 x: 1e-5 * max|ref| * sqrt(K) for f32
    sums of K products in another order, plus one bf16 ulp of the value
    for a bf16 output.  Dead tiles and the empty row block add nothing."""
    m_j, m_t = _support_spmm_case(tile_dtype, block, k_pack,
                                  seed=block + k_pack + len(str(tile_dtype)))
    if k_pack > 1:
        assert bool((m_t.tiles == 0).flatten(1).all(1).any())  # dead tiles
    k = int((m_t.row_ptr[1:] - m_t.row_ptr[:-1]).max()) * block
    rng = np.random.default_rng(block)
    for d in (10, 20, 128, 130):
        x = rng.standard_normal((m_t.num_nodes, d)).astype(np.float32)
        for x_dtype in (torch.float32, torch.bfloat16):
            xt = torch.from_numpy(x).to(x_dtype)
            for out_dtype in (torch.float32, torch.bfloat16):
                y = bcsr_kernels.spmm_bcsr_support_plain(m_t, xt, out_dtype)
                assert y.dtype == out_dtype and y.shape == (3 * block, d)
                refs = [bcsr_kernels.spmm_bcsr_plain(m_t, xt, out_dtype)]
                if k_pack > 1:
                    refs.append(bcsr_kernels.spmm_bcsr_packed_plain(
                        m_t, xt, k_pack, out_dtype))
                if d == 20 and out_dtype == torch.float32:
                    xj = jnp.asarray(_pad_lanes(x))
                    if x_dtype == torch.bfloat16:
                        xj = xj.astype(jnp.bfloat16)
                    ref_j = (jax_spmm.spmm_bcsr_packed(m_j, xj, k_pack=k_pack,
                                                       interpret=True)
                             if k_pack > 1 else
                             jax_spmm.spmm_bcsr(m_j, xj, interpret=True))
                    refs.append(torch.from_numpy(np.array(ref_j)[:, :d]))
                for ref in refs:
                    ref = ref.float()
                    tol = TOL * float(ref.abs().max()) * np.sqrt(k)
                    if out_dtype == torch.bfloat16:
                        tol = tol + BF16_ULP * ref.abs()
                    assert bool(((y.float() - ref).abs() <= tol).all()), (
                        d, x_dtype, out_dtype)
                np.testing.assert_array_equal(y[2 * block:].float(), 0.0)


@pytest.mark.parametrize("k_pack", [1, 4])
def test_spmm_block8_matches_pallas(k_pack):
    """The CPU wrappers take the block sizes JAX's interpret path takes:
    spmm_bcsr / spmm_bcsr_packed at block 8 against tpugraph's (1e-5 *
    max|ref| * sqrt(K), f32 sums in another order)."""
    rng = np.random.default_rng(80 + k_pack)
    n, d, e = 48, 20, 400
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, 40, e).astype(np.int32)
    w = rng.standard_normal(e).astype(np.float32)
    kw = dict(block=8, pad_rows_to=k_pack if k_pack > 1 else None)
    m_j = jax_bcsr.bcsr_from_coo(s, r, w, n, device=False, **kw)
    m_t = bcsr.bcsr_from_coo(s, r, w, n, **kw).to("cpu")
    x = rng.standard_normal((n, d)).astype(np.float32)
    xj = jnp.asarray(_pad_lanes(x))
    if k_pack > 1:
        ref = jax_spmm.spmm_bcsr_packed(m_j, xj, k_pack=k_pack, interpret=True)
        y = bcsr_kernels.spmm_bcsr_packed(m_t, torch.from_numpy(x), k_pack)
    else:
        ref = jax_spmm.spmm_bcsr(m_j, xj, interpret=True)
        y = bcsr_kernels.spmm_bcsr(m_t, torch.from_numpy(x))
    ref = np.asarray(ref)[:, :d]
    k = int((m_t.row_ptr[1:] - m_t.row_ptr[:-1]).max()) * 8
    assert y.shape == ref.shape
    np.testing.assert_allclose(y.numpy(), ref, rtol=0,
                               atol=TOL * np.abs(ref).max() * np.sqrt(k))
    np.testing.assert_array_equal(y[40:].numpy(), 0.0)  # the empty row block


def test_bcsr_from_coo_takes_keywords_after_block():
    """A sixth positional argument means pad_tiles_to in tpugraph and
    num_col_nodes / tile_dtype here, so the port takes none."""
    s = np.array([0, 1], np.int32)
    r = np.array([1, 0], np.int32)
    w = np.ones(2, np.float32)
    with pytest.raises(TypeError):
        bcsr.bcsr_from_coo(s, r, w, 8, 8, 16)
    with pytest.raises(TypeError):
        bcsr.bcsr_transpose_host(s, r, w, 8, 8, torch.int8)
    m = bcsr.bcsr_from_coo(s, r, w, 8, 8, num_col_nodes=16)
    assert m.num_nodes == 16


def test_strip_counts_and_crossover():
    """strip_nnz counts each 8-row x strip_k strip's nonzeros (their sum is
    the tiles' nonzeros); branch_shares splits the strips into empty,
    sparse and dense (each forced branch takes all nonempty strips); the
    crossover falls as D widens and is capped at 128 columns."""
    _, m_t = _support_spmm_case(torch.int8, 256, 4, seed=3)
    assert bcsr_kernels.strip_k(torch.float32, 256) == 64
    assert bcsr_kernels.strip_k(torch.bfloat16, 256) == 128
    assert bcsr_kernels.strip_k(torch.int8, 256) == 256
    assert bcsr_kernels.strip_k(torch.int8, 64) == 64
    c = bcsr_kernels.strip_nnz(m_t)
    assert tuple(c.shape) == (m_t.num_tiles, 32, 1)
    assert int(c.sum()) == int((m_t.tiles != 0).sum())
    sh = bcsr_kernels.branch_shares(m_t, 128)
    assert abs(sum(sh.values()) - 1.0) < 1e-9 and sh["empty"] > 0
    assert bcsr_kernels.branch_shares(m_t, 128, -1)["sparse"] == 0.0
    assert bcsr_kernels.branch_shares(m_t, 128, 1 << 20)["dense"] == 0.0
    x = [bcsr_kernels.spmm_crossover(d) for d in (10, 20, 64, 128, 512)]
    assert x == sorted(x, reverse=True) and x[-1] == x[-2]


@pytest.mark.parametrize("block", [64, 128, 192, 256, 320, 384, 512])
@pytest.mark.parametrize("tile_dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_strip_k_whole_strips_any_card_block(tile_dtype, block):
    """Every card block (B % 64 == 0) splits a tile row into whole B1/B3
    strips of 256, 128 or 64 bytes, the widest that divides it, and
    strip_nnz covers every entry once."""
    isz = torch.empty((), dtype=tile_dtype).element_size()
    k = bcsr_kernels.strip_k(tile_dtype, block)
    assert block % k == 0 and k * isz in (64, 128, 256)
    assert all(block * isz % wider for wider in (256, 128) if wider > k * isz)
    tiles = torch.zeros((2, block, block), dtype=tile_dtype)
    tiles[0, 3, block - 1] = 1
    tiles[1, block - 1, 5] = 2
    m = bcsr.BCSR(tiles, torch.tensor([0, 1], dtype=torch.int32),
                  torch.tensor([0, 2], dtype=torch.int32),
                  torch.zeros(2, dtype=torch.int32), num_nodes=2 * block, block=block)
    c = bcsr_kernels.strip_nnz(m)
    assert tuple(c.shape) == (2, block // 8, block // k) and int(c.sum()) == 2
    assert int(c[0, 0, -1]) == 1 and int(c[1, -1, 0]) == 1


def test_packers_carry_longest_list():
    """The packers count the longest row-block list on the host (the B1/B3
    kernels' cluster choice reads it instead of the card), and it survives
    ``.to`` and ``dataclasses.replace``."""
    rng = np.random.default_rng(7)
    s = rng.integers(0, 1024, 3000).astype(np.int32)
    r = np.concatenate([rng.integers(0, 128, 2000),  # a hub row block
                        rng.integers(0, 1024, 1000)]).astype(np.int32)
    w = rng.standard_normal(3000).astype(np.float32)
    m = bcsr.bcsr_from_coo(s, r, w, 1024, block=128)
    lists = np.diff(np.asarray(m.row_ptr))
    assert m.longest_list == int(lists.max())
    p = bcsr.bcsr_pad_rows(m, 4)
    assert p.longest_list == int(np.diff(np.asarray(p.row_ptr)).max())
    assert p.longest_list % 4 == 0 and p.longest_list >= m.longest_list
    tp = bcsr.bcsr_transpose_plan(m)
    assert tp.longest_list == int(np.diff(np.asarray(tp.row_ptr)).max())
    assert m.to("cpu").longest_list == m.longest_list
    assert dataclasses.replace(m, tiles=m.tiles).longest_list == m.longest_list


def test_cluster_size_rule():
    """B1/B3 share a slab among 8 CTAs for a hub (a list over twice the
    mean) or a grid under two slabs an SM, else give each CTA its own."""
    assert bcsr_kernels.cluster_size(311, 82.0, 1024, 132) == 8   # power-law hub
    assert bcsr_kernels.cluster_size(4, 3.0, 1024, 132) == 1      # banded
    assert bcsr_kernels.cluster_size(20, 17.0, 1024, 132) == 1    # scaled
    assert bcsr_kernels.cluster_size(6, 4.0, 12, 132) == 8        # syn1: few slabs


JDT = {None: None, torch.int8: jnp.int8, torch.bfloat16: jnp.bfloat16}


def _rect_edges(seed, n_rows, n_cols, e=1500):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n_cols, e).astype(np.int32)
    r = rng.integers(0, n_rows // 2, e).astype(np.int32)  # empty row blocks
    w = (rng.standard_normal(e) * 40).astype(np.float32)
    w[::9] = 0.0
    return s, r, w


@pytest.mark.parametrize("tile_dtype", [None, torch.int8, torch.bfloat16])
@pytest.mark.parametrize("n_cols", [384, 900], ids=["square", "rect"])
def test_pad_tiles_and_to_dense_byte_identical(tile_dtype, n_cols):
    """bcsr_from_coo(pad_tiles_to=), bcsr_pad_tiles on a packed BCSR and
    bcsr_to_dense give tpugraph's arrays byte for byte (tolerance 0), on a
    square and a rectangular matrix with empty row blocks, for f32, int8
    and bf16 tiles; dead tiles sit in the last row block at column 0."""
    n = 384
    s, r, w = _rect_edges(3, n, n_cols)
    kw = {} if n_cols == n else {"num_col_nodes": n_cols}
    m_t = bcsr.bcsr_from_coo(s, r, w, n, block=64, tile_dtype=tile_dtype, **kw)
    t = m_t.num_tiles
    for pad in (t, t + 5):
        m_j = jax_bcsr.bcsr_from_coo(s, r, w, n, 64, pad, tile_dtype=JDT[tile_dtype],
                                     device=False, **kw)
        got = bcsr.bcsr_from_coo(s, r, w, n, block=64, tile_dtype=tile_dtype,
                                 pad_tiles_to=pad, **kw)
        padded_j = jax_bcsr.bcsr_pad_tiles(
            jax_bcsr.bcsr_from_coo(s, r, w, n, 64, tile_dtype=JDT[tile_dtype],
                                   device=False, **kw), pad + 3)
        padded = bcsr.bcsr_pad_tiles(m_t, pad + 3)
        for f in ("tiles", "col_blk", "row_ptr", "row_of"):
            assert _as_bytes(getattr(m_j, f)) == _as_bytes(getattr(got, f)), f
            assert _as_bytes(getattr(padded_j, f)) == _as_bytes(getattr(padded, f)), f
        assert padded.longest_list == int(np.diff(padded.row_ptr).max())
        np.testing.assert_array_equal(bcsr.bcsr_to_dense(padded),
                                      jax_bcsr.bcsr_to_dense(padded_j))
    assert bcsr.bcsr_pad_tiles(m_t, t) is m_t
    with pytest.raises(ValueError, match="tile budget too small"):
        bcsr.bcsr_pad_tiles(m_t, t - 1)
    with pytest.raises(ValueError, match="tile budget too small"):
        bcsr.bcsr_from_coo(s, r, w, n, block=64, pad_tiles_to=1, **kw)


@pytest.mark.parametrize("engine", ["native", "numpy"])
def test_rcm_reorder_matches(engine, monkeypatch):
    """rcm_reorder's (perm, inv) equal tpugraph's on a shuffled banded
    graph, with both packages on the C++ engine and both on numpy."""
    from tpugraph import native as jax_native
    from tpugraph_torch import native

    if engine == "numpy":
        monkeypatch.setattr(jax_native, "_get_lib", lambda: None)
        monkeypatch.setattr(native, "_get_lib", lambda: None)
    rng = np.random.default_rng(5)
    n = 300
    src = np.arange(n)
    dst = (src + rng.integers(1, 9, n)) % n
    shuf = rng.permutation(n).astype(np.int32)
    s = shuf[np.concatenate([src, dst])]
    r = shuf[np.concatenate([dst, src])]
    for got, want in zip(bcsr.rcm_reorder(s, r, n), jax_bcsr.rcm_reorder(s, r, n)):
        assert _as_bytes(got) == _as_bytes(want)


def test_transposed_bcsr_groups_uncovered_row_blocks():
    """A rectangular matrix whose middle column blocks hold no tile gets a
    transpose plan (tpugraph's arrays) whose injected entries follow the
    real ones; transposed_bcsr lays them out by row block, so the B1
    plain version of A^T equals the dense transpose (the port's kernels
    read each row block's list from row_ptr)."""
    rng = np.random.default_rng(2)
    s = np.concatenate([rng.integers(0, 16, 40), rng.integers(48, 64, 40)])
    r = rng.integers(0, 16, 80)
    w = rng.standard_normal(80).astype(np.float32)
    m = bcsr.bcsr_from_coo(s, r, w, 16, block=8, num_col_nodes=64)
    tp = bcsr.bcsr_transpose_plan(m)
    tp_j = jax_bcsr.bcsr_transpose_plan(jax_bcsr.bcsr_from_coo(
        s, r, w, 16, 8, num_col_nodes=64))
    for f in ("col_blk", "row_ptr", "row_of", "perm", "keep"):
        assert _as_bytes(getattr(tp, f)) == _as_bytes(getattr(tp_j, f)), f
    assert tp.order is not None
    mt = bcsr.transposed_bcsr(torch.from_numpy(m.tiles), tp.to("cpu"))
    g = torch.from_numpy(rng.standard_normal((16, 3)).astype(np.float32))
    dense = torch.from_numpy(bcsr.bcsr_to_dense(m))
    torch.testing.assert_close(bcsr_kernels.spmm_bcsr(mt, g), dense.T @ g,
                               rtol=0, atol=TOL)
