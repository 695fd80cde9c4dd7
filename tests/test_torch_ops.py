"""The port's B1 (spmm_bcsr) and B2 (sddmm_bcsr) against the Pallas
kernels of tpugraph (interpret mode on the CPU), and, on a card, the CUDA
kernels against their plain versions."""

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
    assert bcsr_kernels.LAUNCHES == {"spmm_bcsr": 0, "sddmm_bcsr": 0}


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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,n_cols,d", [(768, 768, 10), (384, 256, 128)])
def test_cuda_kernels_match_plain(cuda_device, n_rows, n_cols, d):
    _, m_t, x, dy = _case(n_rows, n_cols, d, seed=5)
    m = m_t.to(cuda_device)
    xd = torch.from_numpy(x).to(cuda_device)
    dyd = torch.from_numpy(dy).to(cuda_device)
    before = dict(bcsr_kernels.LAUNCHES)
    y = bcsr_kernels.spmm_bcsr(m, xd)
    g = bcsr_kernels.sddmm_bcsr(m, dyd, xd)
    torch.cuda.synchronize()
    assert bcsr_kernels.LAUNCHES["spmm_bcsr"] == before["spmm_bcsr"] + 1
    assert bcsr_kernels.LAUNCHES["sddmm_bcsr"] == before["sddmm_bcsr"] + 1
    np.testing.assert_allclose(y.cpu(), bcsr_kernels.spmm_bcsr_plain(m_t, torch.from_numpy(x)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        g.cpu(), bcsr_kernels.sddmm_bcsr_plain(m_t, torch.from_numpy(dy), torch.from_numpy(x)),
        rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_cuda_kernels_no_row_blocks(cuda_device):
    """An empty matrix launches nothing and gives the plain version's
    empty shapes."""
    m, x, dy = _no_row_blocks(cuda_device)
    before = dict(bcsr_kernels.LAUNCHES)
    assert bcsr_kernels.spmm_bcsr(m, x).shape == (0, 8)
    assert bcsr_kernels.sddmm_bcsr(m, dy, x).shape == (0, 128, 128)
    assert bcsr_kernels.LAUNCHES == before
