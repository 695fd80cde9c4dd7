"""The hand-written CUDA kernels B1 (spmm_bcsr), B2 (sddmm_bcsr), B3
(spmm_bcsr_packed), B4 (spmm_stacked_resident) and B7 (spmm_packets)
against their plain PyTorch versions on the card.  This file imports no
JAX (nor does it need ``tests/conftest.py``, which does), so it runs on a
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Every test needs a CUDA card and nvcc and skips without them."""

import math

import numpy as np
import pytest
import torch

from tpugraph_torch.ops import bcsr, bcsr_kernels, packets, packets_kernels
from tpugraph_torch.ops import resident_kernels as rk

BF16_REL = 2.0 ** -8  # one bf16 rounding of a value (8 significant bits)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _coo(n, e, seed, integer=False):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    w = (rng.integers(1, 4, e) if integer else rng.standard_normal(e))
    return s, r, w.astype(np.float32)


def _x(rows, d, seed, device):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((rows, d), generator=g).to(device)


def _f32_tol(ref, k):
    """f32 sums of k products in another order: 1e-5 * max|ref| * sqrt(k)."""
    return 1e-5 * float(ref.abs().max()) * math.sqrt(k) + 1e-6


def _case(n_rows, n_cols, d, seed):
    """Random block-sparse matrix (with duplicate edges and an empty row
    block, rows >= 256) plus x and dy on the CPU."""
    rng = np.random.default_rng(seed)
    e = 2000
    s = rng.integers(0, n_cols, e).astype(np.int32)
    r = rng.integers(0, min(n_rows, 256), e).astype(np.int32)
    w = rng.standard_normal(e).astype(np.float32)
    kw = {} if n_rows == n_cols else {"num_col_nodes": n_cols}
    m = bcsr.bcsr_from_coo(s, r, w, n_rows, block=128, **kw).to("cpu")
    x = rng.standard_normal((m.num_nodes, d)).astype(np.float32)
    dy = rng.standard_normal((m.num_row_nodes, d)).astype(np.float32)
    return m, x, dy


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,n_cols,d", [(768, 768, 10), (384, 256, 128)])
def test_cuda_kernels_match_plain(cuda_device, n_rows, n_cols, d):
    m_t, x, dy = _case(n_rows, n_cols, d, seed=5)
    m = m_t.to(cuda_device)
    xd = torch.from_numpy(x).to(cuda_device)
    dyd = torch.from_numpy(dy).to(cuda_device)
    before = dict(bcsr_kernels.LAUNCHES)
    y = bcsr_kernels.spmm_bcsr(m, xd)
    g = bcsr_kernels.sddmm_bcsr(m, dyd, xd)
    torch.cuda.synchronize()
    assert bcsr_kernels.LAUNCHES["spmm_bcsr"] == before["spmm_bcsr"] + 1
    assert bcsr_kernels.LAUNCHES["sddmm_bcsr"] == before["sddmm_bcsr"] + 1
    np.testing.assert_allclose(
        y.cpu(), bcsr_kernels.spmm_bcsr_plain(m_t, torch.from_numpy(x)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        g.cpu(), bcsr_kernels.sddmm_bcsr_plain(m_t, torch.from_numpy(dy),
                                               torch.from_numpy(x)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_kernels_no_row_blocks(cuda_device):
    """An empty matrix launches nothing and gives the plain version's
    empty shapes."""
    i32 = dict(dtype=torch.int32, device=cuda_device)
    m = bcsr.BCSR(tiles=torch.zeros((0, 128, 128), device=cuda_device),
                  col_blk=torch.zeros((0,), **i32),
                  row_ptr=torch.zeros((1,), **i32),
                  row_of=torch.zeros((0,), **i32), num_nodes=128, block=128)
    x = torch.ones((128, 8), device=cuda_device)
    dy = torch.zeros((0, 8), device=cuda_device)
    before = dict(bcsr_kernels.LAUNCHES)
    assert bcsr_kernels.spmm_bcsr(m, x).shape == (0, 8)
    assert bcsr_kernels.sddmm_bcsr(m, dy, x).shape == (0, 128, 128)
    assert bcsr_kernels.spmm_bcsr_packed(m, x, 4).shape == (0, 8)
    assert bcsr_kernels.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("k_pack,d", [(2, 10), (4, 128)])
def test_spmm_bcsr_packed_matches_plain(cuda_device, k_pack, d):
    s, r, w = _coo(640, 6000, seed=k_pack + d)
    m = bcsr.bcsr_from_coo(s, r, w, 640, block=128,
                           pad_rows_to=k_pack).to(cuda_device)
    x = _x(m.num_nodes, d, 0, cuda_device)
    before = bcsr_kernels.LAUNCHES["spmm_bcsr_packed"]
    y = bcsr_kernels.spmm_bcsr_packed(m, x, k_pack)
    torch.cuda.synchronize()
    assert bcsr_kernels.LAUNCHES["spmm_bcsr_packed"] == before + 1
    ref = bcsr_kernels.spmm_bcsr_packed_plain(m, x, k_pack)
    assert float((y - ref).abs().max()) <= _f32_tol(ref, 6 * 128)
    # the same product as the unpadded B1
    m1 = bcsr.bcsr_from_coo(s, r, w, 640, block=128).to(cuda_device)
    y1 = bcsr_kernels.spmm_bcsr(m1, x)
    assert float((y - y1).abs().max()) <= _f32_tol(ref, 6 * 128)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("stack", [1, 2])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_spmm_stacked_resident_matches_plain(cuda_device, tile_dtype, stack,
                                             out_dtype):
    s, r, w = _coo(512, 3000, seed=stack, integer=tile_dtype == torch.int8)
    m = bcsr.bcsr_from_coo(s, r, w, 512, block=128, tile_dtype=tile_dtype)
    st = rk.stack_bcsr(m, stack=stack, k_pack=4).to(cuda_device)
    for d in (128, 20):
        x = _x(st.num_nodes, d, d, cuda_device)
        before = rk.LAUNCHES["spmm_stacked_resident"]
        y = rk.spmm_stacked_resident(st, x, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert rk.LAUNCHES["spmm_stacked_resident"] == before + 1
        assert y.dtype == out_dtype and y.shape == (st.num_row_nodes, d)
        ref = rk.spmm_stacked_resident_plain(st, x)
        err = (y.float() - ref).abs()
        tol = _f32_tol(ref, 4 * 128)
        if out_dtype == torch.bfloat16:  # one rounding at the write
            tol = tol + BF16_REL * ref.abs()
        assert bool((err <= tol).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_spmm_stacked_resident_int4_matches_plain(cuda_device, out_dtype):
    s, r, w = _coo(512, 3000, seed=7, integer=True)
    m = bcsr.bcsr_from_coo(s, r, w, 512, block=128, tile_dtype=torch.int8)
    st = rk.pack_stacked_int4(rk.stack_bcsr(m, stack=2, k_pack=4))
    st = st.to(cuda_device)
    x = _x(st.num_nodes, 128, 1, cuda_device)
    y = rk.spmm_stacked_resident(st, x, out_dtype=out_dtype)
    ref = rk.spmm_stacked_resident_plain(st, x)
    tol = _f32_tol(ref, 4 * 128)
    if out_dtype == torch.bfloat16:
        tol = tol + BF16_REL * ref.abs()
    assert bool(((y.float() - ref).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [(32, 32, 8), (512, 256, 128)])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_spmm_packets_matches_plain(cuda_device, geom, compute_dtype,
                                    out_dtype):
    br, bc, k = geom
    s, r, w = _coo(1000, 20000, seed=br)
    p = packets.pack_edges(s, r, w, 1000, block_r=br, block_c=bc,
                           k=k).to(cuda_device)
    for d in (128, 20):
        x = _x(p.num_nodes, d, d, cuda_device)
        before = packets_kernels.LAUNCHES["spmm_packets"]
        y = packets_kernels.spmm_packets(p, x, out_dtype=out_dtype,
                                         compute_dtype=compute_dtype)
        torch.cuda.synchronize()
        assert packets_kernels.LAUNCHES["spmm_packets"] == before + 1
        ref = packets_kernels.spmm_packets_plain(p, x, None, compute_dtype)
        err = (y.float() - ref).abs()
        tol = _f32_tol(ref, 64)  # ~20 edges a row, summed by atomics
        if out_dtype == torch.bfloat16:
            tol = tol + BF16_REL * ref.abs()
        assert bool((err <= tol).all()), float(err.max())


@pytest.mark.cuda
def test_autograd_wrappers_on_card_match_cpu(cuda_device):
    """BCSRMatvec (k_pack), StackedMatvec and PacketsMatvec give the
    forward and the x-gradient of their CPU plain versions."""
    s, r, w = _coo(384, 3000, seed=11, integer=True)
    g = torch.Generator().manual_seed(3)
    cases = {
        "packed": lambda dev: (bcsr_kernels.bcsr_matvec, (
            bcsr.bcsr_from_coo(s, r, w, 384, pad_rows_to=4).to(dev),
            bcsr.bcsr_transpose_host(s, r, w, 384, pad_rows_to=4).to(dev)),
            {"k_pack": 4}),
        "stacked": lambda dev: (rk.stacked_matvec, (
            rk.stack_bcsr(bcsr.bcsr_from_coo(s, r, w, 384, tile_dtype=torch.int8),
                          stack=1, k_pack=64).to(dev),
            rk.stack_bcsr(bcsr.bcsr_transpose_host(s, r, w, 384,
                                                   tile_dtype=torch.int8),
                          stack=1, k_pack=64).to(dev)), {}),
        "packets": lambda dev: (packets_kernels.packets_matvec, (
            packets.pack_edges(s, r, w, 384, 128, 128, 32).to(dev),
            packets.pack_edges_transpose(s, r, w, 384, 128, 128, 32).to(dev)),
            {"compute_dtype": torch.bfloat16}),
    }
    x = torch.randn((384, 24), generator=g)
    gy = torch.randn((384, 24), generator=g)
    for name, make in cases.items():
        outs = []
        for dev in ("cpu", cuda_device):
            fn, (a, a_t), kw = make(dev)
            xd = x.to(dev).requires_grad_(True)
            y = fn(a, a_t, xd, **kw)
            (dx,) = torch.autograd.grad(y, xd, gy.to(dev))
            outs.append((y.detach().cpu(), dx.cpu()))
        for got, ref in zip(outs[1], outs[0]):  # same inputs: order only
            assert float((got - ref).abs().max()) <= _f32_tol(ref, 3 * 128), name
