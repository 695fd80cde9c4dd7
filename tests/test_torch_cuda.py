"""The hand-written CUDA kernels B1 (spmm_bcsr), B2 (sddmm_bcsr), B3
(spmm_bcsr_packed), B4 (spmm_stacked_resident), B5 (spmm_pair_resident),
B6 (spmm_power_resident) and B7 (spmm_packets) against their plain
PyTorch versions on the card, with every tile / x / output dtype they
take.  This file imports no
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
BF16_ULP = 2.0 ** -7  # one bf16 ulp, relative
FLOATS = [torch.float32, torch.bfloat16]
TILES = [torch.float32, torch.bfloat16, torch.int8]


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
    for d in (128, 20, 10):
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


def _hub_packets(device):
    """A hub-heavy graph at the training geometry (512, 256, 128): receiver
    block 0 holds over half the 60,000 edges, in more packets than one
    chunk of the work list, so B7 splits it; returns the packets and the
    largest in-degree."""
    rng = np.random.default_rng(9)
    n, e = 4096, 60000
    s = rng.integers(0, n, e).astype(np.int32)
    r = np.where(rng.random(e) < 0.6, rng.integers(0, 512, e),
                 rng.integers(0, n, e)).astype(np.int32)
    w = rng.standard_normal(e).astype(np.float32)
    p = packets.pack_edges(s, r, w, n, block_r=512, block_c=256, k=128)
    return p.to(device), int(np.bincount(r, minlength=n).max())


def _row_tol(ref, k, out_dtype):
    """Per output row: f32 sums of k terms in another order (1e-5 * sqrt(k)
    of the row's largest |value|), plus one bf16 ulp of the value for a
    bf16 output (its own rounding may flip)."""
    tol = 1e-5 * math.sqrt(k) * ref.abs().amax(1, keepdim=True) + 1e-6
    return tol + BF16_ULP * ref.abs() if out_dtype == torch.bfloat16 else tol


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", FLOATS)
@pytest.mark.parametrize("out_dtype", FLOATS)
def test_spmm_packets_hub_split_matches_plain(cuda_device, compute_dtype,
                                              out_dtype):
    """B7 on a hub graph whose receiver block 0 is split over several CTAs:
    the main pass and the reduce pass each launch once, and the result
    equals the plain version and the schedule-walking plain version."""
    p, k_row = _hub_packets(cuda_device)
    wl = packets_kernels.work_list(p)
    assert wl.splits.shape[0] >= 1 and int(wl.splits[:, 2].max()) >= 2
    for d in (128, 20, 10):
        x = _x(p.num_nodes, d, d, cuda_device)
        before = dict(packets_kernels.LAUNCHES)
        y = packets_kernels.spmm_packets(p, x, out_dtype, compute_dtype)
        torch.cuda.synchronize()
        assert packets_kernels.LAUNCHES == {
            k: v + 1 for k, v in before.items()}
        assert y.dtype == out_dtype and y.shape == (p.num_nodes, d)
        for ref in (packets_kernels.spmm_packets_plain(p, x, None, compute_dtype),
                    packets_kernels.spmm_packets_schedule_plain(
                        p, x, None, compute_dtype)):
            err = (y.float() - ref).abs()
            assert bool((err <= _row_tol(ref, k_row, out_dtype)).all()), (
                d, float(err.max()))


@pytest.mark.cuda
def test_spmm_packets_ablations_run(cuda_device):
    """Every diagnostic mode of B7 runs and keeps the output's shape; the
    ``full`` mode is B7 itself; none counts a launch."""
    p, k_row = _hub_packets(cuda_device)
    x = _x(p.num_nodes, 128, 3, cuda_device)
    before = dict(packets_kernels.LAUNCHES)
    outs = {m: packets_kernels._spmm_packets_ablation(p, x, m)
            for m in packets_kernels.ABLATIONS}
    torch.cuda.synchronize()
    assert packets_kernels.LAUNCHES == before
    for m, y in outs.items():
        assert y.shape == (p.num_nodes, 128) and y.dtype == torch.float32, m
        assert bool(torch.isfinite(y).all()), m
    ref = packets_kernels.spmm_packets_plain(p, x, None, torch.bfloat16)
    err = (outs["full"] - ref).abs()
    assert bool((err <= _row_tol(ref, k_row, torch.float32)).all())
    with pytest.raises(ValueError, match="ablations"):
        packets_kernels._spmm_packets_ablation(p, x[:, :10].contiguous(), "full")


def _b2_mixed(tile_dtype, device):
    """Six 128^2 tiles over three row blocks (384 nodes) whose 64^2
    sub-tiles span the support densities B2 branches on: 90% (tile 0),
    0.5%, all zero (a dead tile), 30%, 2% and 10%."""
    rng = np.random.default_rng(4)
    dens = [0.9, 0.005, 0.0, 0.3, 0.02, 0.1]
    vals = rng.standard_normal((6, 128, 128))
    if tile_dtype == torch.int8:
        vals = rng.integers(-3, 4, (6, 128, 128))
    keep = rng.random((6, 128, 128)) < np.array(dens)[:, None, None]
    tiles = torch.from_numpy((vals * keep).astype(np.float32)).to(tile_dtype)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)
    return bcsr.BCSR(tiles=tiles, col_blk=i32([0, 2, 1, 2, 0, 1]),
                     row_ptr=i32([0, 2, 4, 6]), row_of=i32([0, 0, 1, 1, 2, 2]),
                     num_nodes=384, block=128).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_dtype", TILES)
def test_sddmm_bcsr_branches_match_plain(cuda_device, tile_dtype):
    """B2's sparse and dense branches, each forced and by the default
    crossover, on sub-tiles from empty to 90% full: the plain version's
    values on the support within f32 reordering (1e-5 * sqrt(D) of
    max|ref|), and +0.0 off it."""
    m = _b2_mixed(tile_dtype, cuda_device)
    off = m.tiles == 0
    for d in (128, 20, 10):
        x = _x(384, d, d, cuda_device)
        dy = _x(384, d, d + 1, cuda_device)
        ref = bcsr_kernels.sddmm_bcsr_plain(m, dy, x)
        before = bcsr_kernels.LAUNCHES["sddmm_bcsr"]
        outs = [bcsr_kernels.sddmm_bcsr(m, dy, x)]
        outs += [bcsr_kernels._sddmm_bcsr_crossover(m, dy, x, c) for c in (-1, 4096)]
        torch.cuda.synchronize()
        assert bcsr_kernels.LAUNCHES["sddmm_bcsr"] == before + 1
        for g in outs:
            assert g.dtype == torch.float32 and g.shape == m.tiles.shape
            assert float((g - ref).abs().max()) <= _f32_tol(ref, d), d
            assert bool((g[off] == 0).all()) and not bool(torch.signbit(g[off]).any())


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


@pytest.mark.cuda
@pytest.mark.parametrize("k_pack", [1, 4])
@pytest.mark.parametrize("tile_dtype", TILES)
def test_spmm_bcsr_dtypes_match_plain(cuda_device, k_pack, tile_dtype):
    """B1 (k_pack 1) and B3 (k_pack 4) with every x and output dtype, at
    D = 128 and a ragged D = 20."""
    s, r, w = _coo(640, 6000, seed=k_pack, integer=tile_dtype == torch.int8)
    m = bcsr.bcsr_from_coo(s, r, w, 640, block=128, tile_dtype=tile_dtype,
                           pad_rows_to=k_pack if k_pack > 1 else None
                           ).to(cuda_device)
    name = "spmm_bcsr_packed" if k_pack > 1 else "spmm_bcsr"
    for d in (128, 20):
        for x_dtype in FLOATS:
            x = _x(m.num_nodes, d, d, cuda_device).to(x_dtype)
            for out_dtype in FLOATS:
                before = bcsr_kernels.LAUNCHES[name]
                if k_pack > 1:
                    y = bcsr_kernels.spmm_bcsr_packed(m, x, k_pack, out_dtype)
                    ref = bcsr_kernels.spmm_bcsr_packed_plain(m, x, k_pack)
                else:
                    y = bcsr_kernels.spmm_bcsr(m, x, out_dtype)
                    ref = bcsr_kernels.spmm_bcsr_plain(m, x)
                torch.cuda.synchronize()
                assert bcsr_kernels.LAUNCHES[name] == before + 1
                assert y.dtype == out_dtype and y.shape == (640, d)
                tol = _f32_tol(ref, 8 * 128)
                if out_dtype == torch.bfloat16:
                    tol = tol + BF16_ULP * ref.abs()
                err = (y.float() - ref).abs()
                assert bool((err <= tol).all()), (x_dtype, out_dtype, d)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_dtype", TILES)
def test_sddmm_bcsr_support_dtypes_match_plain(cuda_device, tile_dtype):
    m, x, dy = _case(384, 384, 24, seed=6)
    m = bcsr.BCSR(m.tiles.to(tile_dtype), m.col_blk, m.row_ptr, m.row_of,
                  m.num_nodes, m.block).to(cuda_device)
    xd, dyd = torch.from_numpy(x).to(cuda_device), torch.from_numpy(dy).to(cuda_device)
    g = bcsr_kernels.sddmm_bcsr(m, dyd, xd)
    ref = bcsr_kernels.sddmm_bcsr_plain(m, dyd, xd)
    assert g.dtype == torch.float32
    assert float((g - ref).abs().max()) <= _f32_tol(ref, 24)
    assert bool((g[m.tiles == 0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("tile_dtype", TILES)
def test_spmm_stacked_resident_bf16_x_matches_plain(cuda_device, tile_dtype):
    s, r, w = _coo(512, 3000, seed=3, integer=tile_dtype == torch.int8)
    m = bcsr.bcsr_from_coo(s, r, w, 512, block=128, tile_dtype=tile_dtype)
    st = rk.stack_bcsr(m, stack=2, k_pack=4).to(cuda_device)
    x = _x(st.num_nodes, 128, 2, cuda_device).to(torch.bfloat16)
    y = rk.spmm_stacked_resident(st, x)
    ref = rk.spmm_stacked_resident_plain(st, x)
    assert float((y - ref).abs().max()) <= _f32_tol(ref, 4 * 128)


def _pair(tile_dtype, n_rows, n_cols, seed):
    """The pair of A (n_cols -> n_rows) and A^T at block 128."""
    rng = np.random.default_rng(seed)
    e = 4000
    s = rng.integers(0, n_cols, e).astype(np.int32)
    r = rng.integers(0, n_rows, e).astype(np.int32)
    w = (rng.integers(1, 4, e) if tile_dtype == torch.int8
         else rng.standard_normal(e)).astype(np.float32)
    kw = {} if n_rows == n_cols else {"num_col_nodes": n_cols}
    kw_t = {} if n_rows == n_cols else {"num_col_nodes": n_rows}
    st = rk.stack_bcsr(bcsr.bcsr_from_coo(s, r, w, n_rows, block=128,
                                          tile_dtype=tile_dtype, **kw), 1, 4)
    st_t = rk.stack_bcsr(bcsr.bcsr_from_coo(r, s, w, n_cols, block=128,
                                            tile_dtype=tile_dtype, **kw_t), 1, 4)
    return rk.pack_pair(st, st_t)


def _pair_tol(ref, n_roundings):
    """Per output row: f32 sums in another order (as ``_f32_tol``), and one
    bf16 ulp of the row's largest |value| for every bf16 rounding the values
    passed (a sum near a tie may round the other way)."""
    row = ref.abs().amax(1, keepdim=True)
    return (1e-5 * math.sqrt(16 * 128) + n_roundings * BF16_ULP) * row + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("rect", [False, True])
@pytest.mark.parametrize("tile_dtype", TILES)
def test_spmm_pair_resident_matches_plain(cuda_device, tile_dtype, rect):
    pair = _pair(tile_dtype, 640, 384 if rect else 640, seed=1).to(cuda_device)
    for d in (128, 20):
        for x_dtype in FLOATS:
            x = _x(pair.num_nodes, d, d, cuda_device).to(x_dtype)
            for out_dtype in FLOATS:
                before = rk.LAUNCHES["spmm_pair_resident"]
                y = rk.spmm_pair_resident(pair, x, k_pack=4, out_dtype=out_dtype)
                torch.cuda.synchronize()
                assert rk.LAUNCHES["spmm_pair_resident"] == before + 2
                assert y.dtype == out_dtype and y.shape == (pair.num_out_nodes, d)
                ref = rk.spmm_pair_resident_plain(pair, x, out_dtype).float()
                err = (y.float() - ref).abs()
                assert bool((err <= _pair_tol(ref, 2)).all()), (
                    x_dtype, out_dtype, d, float(err.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("hops,hop_scale", [(1, 1.0), (3, 0.0625)])
@pytest.mark.parametrize("tile_dtype", TILES)
def test_spmm_power_resident_matches_plain(cuda_device, tile_dtype, hops,
                                           hop_scale):
    pair = _pair(tile_dtype, 640, 640, seed=2).to(cuda_device)
    for x_dtype in FLOATS:
        x = _x(pair.num_nodes, 128, 5, cuda_device).to(x_dtype)
        for out_dtype in FLOATS:
            before = rk.LAUNCHES["spmm_power_resident"]
            y = rk.spmm_power_resident(pair, x, hops, k_pack=4,
                                       out_dtype=out_dtype, hop_scale=hop_scale)
            torch.cuda.synchronize()
            assert rk.LAUNCHES["spmm_power_resident"] == before + 2 * hops
            ref = rk.spmm_power_resident_plain(pair, x, hops, out_dtype,
                                               hop_scale).float()
            err = (y.float() - ref).abs()
            assert bool((err <= _pair_tol(ref, 2 * hops + 1)).all()), (
                x_dtype, out_dtype, float(err.max()))


@pytest.mark.cuda
def test_diffusion_operator_on_card_matches_cpu(cuda_device):
    """DiffusionOperator (normalized bf16 tiles, and int8 tiles with
    hop_scale) on the card against the same operator on the CPU."""
    from tpugraph_torch.core.graph import graph_from_edges
    from tpugraph_torch.ops.diffusion import DiffusionOperator, diffuse

    s, r, _ = _coo(700, 5000, seed=4)
    g = graph_from_edges(np.concatenate([s, r]), np.concatenate([r, s]), 700)
    x = _x(700, 64, 6, "cpu")
    for normalize in (True, False):
        outs = []
        for dev in ("cpu", cuda_device):
            op = DiffusionOperator(g, block=128, normalize=normalize, device=dev)
            x_p = torch.zeros((op.num_nodes, 64))
            x_p[:700] = x
            outs.append(op(x_p.to(dev), 3).float().cpu())
        assert bool(((outs[1] - outs[0]).abs() <= _pair_tol(outs[0], 7)).all())
    y = diffuse(g, x, 2, block=128)
    assert y.device.type == "cuda" and y.shape == (700, 64)
