"""The hand-written CUDA kernels B1 (spmm_bcsr), B2 (sddmm_bcsr), B3
(spmm_bcsr_packed), B4 (spmm_stacked_resident), B5 (spmm_pair_resident),
B6 (spmm_power_resident) and B7 (spmm_packets) against their plain
PyTorch versions on the card, with every tile / x / output dtype they
take; and the COO path (ops, training, the batched explainer) on the
card against the CPU.  This file imports no
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


def _coo(n, e, seed, integer=False, signed=False):
    """Random edges; ``integer`` weights in [1, 4), or with ``signed`` the
    whole int8 range [-127, 127] (the packer clips duplicate sums to it)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    if signed:
        w = rng.integers(-127, 128, e)
    else:
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


def _pair(tile_dtype, n_rows, n_cols, seed, signed=False):
    """The pair of A (n_cols -> n_rows) and A^T at block 128; int8 weights
    in [1, 4), or in [-127, 127] with ``signed``."""
    rng = np.random.default_rng(seed)
    e = 4000
    s = rng.integers(0, n_cols, e).astype(np.int32)
    r = rng.integers(0, n_rows, e).astype(np.int32)
    if signed:
        w = rng.integers(-127, 128, e).astype(np.float32)
    else:
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


def _hub_stacked(kind, stack, device):
    """A stacked layout over 4,096 nodes at block 128 whose row block 0 reads
    every column block (32 slices, against about 10 for the others),
    with an empty row block 5; ``kind`` is int8, bf16 or int4 (packed4)."""
    rng = np.random.default_rng(11)
    n = 4096
    hub_s = rng.integers(0, n, 3000)
    hub_r = rng.integers(0, 128, 3000)
    s = rng.integers(0, n, 300)
    r = rng.integers(0, n, 300)
    keep = r // 128 != 5
    s = np.concatenate([hub_s, s[keep]]).astype(np.int32)
    r = np.concatenate([hub_r, r[keep]]).astype(np.int32)
    w = rng.integers(1, 4, s.size).astype(np.float32)
    tile_dtype = torch.bfloat16 if kind == "bf16" else torch.int8
    if kind == "bf16":
        w = rng.standard_normal(s.size).astype(np.float32)
    m = bcsr.bcsr_from_coo(s, r, w, n, block=128, tile_dtype=tile_dtype)
    st = rk.stack_bcsr(m, stack=stack, k_pack=4)
    if kind == "int4":
        st = rk.pack_stacked_int4(st)
    return st.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "bf16", "int4"])
@pytest.mark.parametrize("stack", [1, 2])
def test_spmm_stacked_resident_tensor_cores_match_plain(cuda_device, kind, stack):
    """The tensor-core phase against its plain version: every tile kind it
    takes, f32 and bf16 x and output, ragged D (10, 20, 130), an empty row block
    and a hub row block whose list is ~3x the mean (split over a cluster)."""
    st = _hub_stacked(kind, stack, cuda_device)
    lists = (st.row_ptr[1:] - st.row_ptr[:-1]).cpu()
    assert int(lists[5]) == 0 and int(lists.max()) > 2.5 * float(lists.float().mean())
    k_max = int(lists.max()) * 128
    for d in (128, 10, 20, 130):
        for x_dtype in FLOATS:
            x = _x(st.num_nodes, d, d, cuda_device).to(x_dtype)
            ref = rk.spmm_stacked_resident_plain(st, x)
            for out_dtype in FLOATS:
                y = rk.spmm_stacked_resident(st, x, out_dtype=out_dtype)
                torch.cuda.synchronize()
                err = (y.float() - ref).abs()
                tol = (1e-5 * math.sqrt(k_max) * ref.abs().amax(1, keepdim=True)
                       + 1e-6)
                if out_dtype == torch.bfloat16:
                    tol = tol + BF16_REL * ref.abs()
                assert bool((err <= tol).all()), (d, x_dtype, out_dtype,
                                                  float(err.max()))
                assert bool((y[640:768] == 0).all())  # the empty row block


@pytest.mark.cuda
def test_resident_ablations_and_probes_run(cuda_device):
    """Every B4 diagnostic mode (D1), B4 with a bf16 output and at a smaller
    n (D4), and both launch probes (D3) run and give finite values; the
    ``full`` mode is B4 itself; the ablations count no launch."""
    from tpugraph_torch.ops import probe_kernels as pk

    st = _hub_stacked("int8", 1, cuda_device)
    x = _x(st.num_nodes, 128, 1, cuda_device)
    before = dict(rk.LAUNCHES)
    outs = {m: rk._spmm_stacked_ablation(st, x, m) for m in rk.ABLATIONS}
    torch.cuda.synchronize()
    assert rk.LAUNCHES == before
    for m, y in outs.items():
        assert y.shape == (st.num_row_nodes, 128) and bool(torch.isfinite(y).all()), m
    assert torch.equal(outs["full"], rk.spmm_stacked_resident(st, x))
    with pytest.raises(ValueError, match="mode"):
        rk._spmm_stacked_ablation(st, x, "storeonly")
    for n_keep in (4096, 1024):  # D4: smaller n, bf16 output
        sub = rk.stack_bcsr(bcsr.bcsr_from_coo(*_coo(n_keep, 8 * n_keep, 2, True),
                                               n_keep, block=128,
                                               tile_dtype=torch.int8), 1, 4)
        sub = sub.to(cuda_device)
        y = rk.spmm_stacked_resident(sub, _x(n_keep, 128, 2, cuda_device),
                                     out_dtype=torch.bfloat16)
        assert bool(torch.isfinite(y.float()).all())
    x8 = _x(8, pk.D, 3, cuda_device)
    for grid in pk.GRIDS:
        assert torch.equal(pk.probe_tiny(x8, grid), pk.probe_tiny_plain(x8))
    xb = _x(4096, pk.D, 4, cuda_device).to(torch.bfloat16)
    out = pk.probe_resident(x8, xb)
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, pk.probe_resident_plain(x8, xb))


# ------------------------------------------------ B1 / B3: the support-driven kernel

MIXED_DENSITY = [0.9, 0.002, 0.0, 0.3, 0.02, 0.1, 0.6, 0.01, 0.45, 0.05, 0.2, 0.75]


def _mixed_bcsr(tile_dtype, block, k_pack, device, seed=4):
    """Four row blocks over 8 column blocks holding 7, 0, 2 and 3 tiles
    whose densities run from 0 (a dead tile) to 90% (``MIXED_DENSITY``),
    so that the kernel's strips fall on both sides of its crossover; each
    row block padded to ``k_pack`` tiles with dead ones (the empty row
    block gets ``k_pack`` of them).  N(0, 1) values, integers in
    [-127, 127] for int8."""
    rng = np.random.default_rng(seed)
    tiles, col, row, ptr = [], [], [], [0]
    j = 0
    for rb, count in enumerate((7, 0, 2, 3)):
        cbs = np.sort(rng.choice(8, count, replace=False))
        for q in range(max(k_pack, -(-count // k_pack) * k_pack)):
            t = np.zeros((block, block), np.float32)
            if q < count:
                keep = rng.random((block, block)) < MIXED_DENSITY[j % 12]
                j += 1
                vals = (rng.integers(-127, 128, (block, block))
                        if tile_dtype == torch.int8
                        else rng.standard_normal((block, block)))
                t = (vals * keep).astype(np.float32)
            tiles.append(t)
            col.append(cbs[q] if q < count else 0)
            row.append(rb)
        ptr.append(len(tiles))
    i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32)
    return bcsr.BCSR(tiles=torch.from_numpy(np.stack(tiles)).to(tile_dtype),
                     col_blk=i32(col), row_ptr=i32(ptr), row_of=i32(row),
                     num_nodes=8 * block, block=block).to(device)


def _spmm(m, x, k_pack, out_dtype=None):
    if k_pack > 1:
        return bcsr_kernels.spmm_bcsr_packed(m, x, k_pack, out_dtype)
    return bcsr_kernels.spmm_bcsr(m, x, out_dtype)


def _spmm_row_tol(m, ref, out_dtype):
    """f32 sums of a row's terms in another order (1e-5 * sqrt(K) of the
    row's largest |value|, K the longest row block's tiles x B), plus one
    bf16 ulp of the value for a bf16 output."""
    k = int((m.row_ptr[1:] - m.row_ptr[:-1]).max()) * m.block
    return _row_tol(ref, k, out_dtype)


# every tile dtype at B = 64, 192 and 256, and int8 at 320: 192 and 320 are
# the blocks whose tile rows are not whole 256-byte strips for some dtypes
ODD_BLOCKS = [(t, b) for t in TILES for b in (64, 192, 256)] + [(torch.int8, 320)]


@pytest.mark.cuda
@pytest.mark.parametrize("k_pack", [1, 4])
@pytest.mark.parametrize("tile_dtype,block", ODD_BLOCKS)
def test_spmm_bcsr_branches_match_plain(cuda_device, tile_dtype, k_pack, block):
    """B1 (k_pack 1) and B3 (k_pack 4) on strips from empty to 90% full,
    every tile dtype (int8 weights in [-127, 127]) at B = 64, 192 and 256
    (int8 also 320), f32 and bf16 x and
    output, D = 10, 20, 128 and 130: the default crossover and each forced
    branch, at every cluster size (1, 2, 4 and 8 CTAs a slab), against both
    plain versions; the two forced branches give the same bits (both add
    in ascending k; zero products change no finite sum); only the default
    launch is counted."""
    m = _mixed_bcsr(tile_dtype, block, k_pack, cuda_device)
    key = "spmm_bcsr_packed" if k_pack > 1 else "spmm_bcsr"
    for d in (10, 20, 128, 130):
        for x_dtype in FLOATS:
            x = _x(m.num_nodes, d, d, cuda_device).to(x_dtype)
            ref = bcsr_kernels.spmm_bcsr_plain(m, x)
            support = bcsr_kernels.spmm_bcsr_support_plain(m, x)
            for out_dtype in FLOATS:
                before = dict(bcsr_kernels.LAUNCHES)
                y = _spmm(m, x, k_pack, out_dtype)
                dense = bcsr_kernels._spmm_bcsr_crossover(m, x, -1, k_pack)
                sparse = bcsr_kernels._spmm_bcsr_crossover(m, x, 1 << 20, k_pack)
                torch.cuda.synchronize()
                assert bcsr_kernels.LAUNCHES == {
                    k: v + (k == key) for k, v in before.items()}
                assert y.dtype == out_dtype and y.shape == (m.num_row_nodes, d)
                assert torch.equal(dense, sparse), (d, x_dtype)
                tol = _spmm_row_tol(m, ref, out_dtype)
                # every cluster size: a CTA alone, or 2 / 4 / 8 sharing a slab
                alone = [bcsr_kernels._spmm_bcsr_crossover(m, x, c, k_pack, cl)
                         for cl in (1, 2, 4, 8) for c in (-1, 1 << 20)]
                torch.cuda.synchronize()
                for a, b in zip(alone[::2], alone[1::2]):
                    assert torch.equal(a, b), (d, x_dtype)
                for got in (y, dense, sparse, *alone):
                    for r in (ref, support):
                        err = (got.float() - r).abs()
                        assert bool((err <= tol).all()), (d, x_dtype, out_dtype,
                                                          float(err.max()))
                assert bool((y[block:2 * block] == 0).all())  # the empty row block
    shares = bcsr_kernels.branch_shares(m, 128)
    assert shares["sparse"] > 0 and shares["dense"] > 0 and shares["empty"] > 0


def _hub_bcsr(tile_dtype, k_pack, device, block=128):
    """32 column blocks of ``block`` nodes (4,096 nodes at block 128): row
    block 0 reads every column block (32 tiles, against about 9 for the
    others, so each rank of the cluster of 8 takes 4), row block 5 is
    empty; int8 weights in [-127, 127]."""
    rng = np.random.default_rng(12)
    n = 32 * block
    s = np.concatenate([rng.integers(0, n, 3000), rng.integers(0, n, 300)])
    r = np.concatenate([rng.integers(0, block, 3000), rng.integers(0, n, 300)])
    keep = r // block != 5
    s, r = s[keep].astype(np.int32), r[keep].astype(np.int32)
    w = (rng.integers(-127, 128, s.size) if tile_dtype == torch.int8
         else rng.standard_normal(s.size)).astype(np.float32)
    return bcsr.bcsr_from_coo(s, r, w, n, block=block, tile_dtype=tile_dtype,
                              pad_rows_to=k_pack if k_pack > 1 else None).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("k_pack", [1, 4])
@pytest.mark.parametrize("tile_dtype,block",
                         [(t, b) for t in TILES for b in (128, 192)] + [(torch.int8, 320)])
def test_spmm_bcsr_hub_split_matches_plain(cuda_device, tile_dtype, k_pack, block):
    """B1/B3 where row block 0's list is over 3x the mean and split over the
    cluster's 8 CTAs, with an empty row block, at D = 10, 20, 128 and 130,
    B = 128 and 192 (int8 also 320); a second launch gives the same bytes."""
    m = _hub_bcsr(tile_dtype, k_pack, cuda_device, block)
    lists = (m.row_ptr[1:] - m.row_ptr[:-1]).cpu()
    assert int(lists[0]) >= 32 and int(lists[0]) > 3 * float(lists.float().mean())
    assert m.longest_list == int(lists.max())  # counted by the packer on the host
    for d in (10, 20, 128, 130):
        for x_dtype in FLOATS:
            x = _x(m.num_nodes, d, d, cuda_device).to(x_dtype)
            ref = bcsr_kernels.spmm_bcsr_plain(m, x)
            y = _spmm(m, x, k_pack)
            again = _spmm(m, x, k_pack)
            torch.cuda.synchronize()
            assert torch.equal(y, again), (d, x_dtype)
            err = (y - ref).abs()
            assert bool((err <= _spmm_row_tol(m, ref, torch.float32)).all()), (
                d, x_dtype, float(err.max()))
            assert bool((y[5 * block:6 * block] == 0).all())  # the empty row block


@pytest.mark.cuda
@pytest.mark.parametrize("stack", [1, 2])
def test_spmm_stacked_resident_negative_int8_matches_plain(cuda_device, stack):
    """B4's tensor-core phase on int8 weights across [-127, 127] (the sign
    branch of its exact widening), stack 1 and 2, f32 and bf16 output."""
    s, r, w = _coo(512, 3000, seed=20 + stack, signed=True)
    assert (w < 0).any() and w.min() <= -100
    m = bcsr.bcsr_from_coo(s, r, w, 512, block=128, tile_dtype=torch.int8)
    assert int(m.tiles.min()) <= -100
    st = rk.stack_bcsr(m, stack=stack, k_pack=4).to(cuda_device)
    for d in (128, 20):
        x = _x(st.num_nodes, d, d, cuda_device)
        ref = rk.spmm_stacked_resident_plain(st, x)
        for out_dtype in FLOATS:
            y = rk.spmm_stacked_resident(st, x, out_dtype=out_dtype)
            torch.cuda.synchronize()
            err = (y.float() - ref).abs()
            tol = _f32_tol(ref, 4 * 128)
            if out_dtype == torch.bfloat16:
                tol = tol + BF16_REL * ref.abs()
            assert bool((err <= tol).all()), (d, out_dtype, float(err.max()))


@pytest.mark.cuda
def test_spmm_pair_and_power_negative_int8_match_plain(cuda_device):
    """B5 and B6 on int8 pairs whose weights span [-127, 127]."""
    pair = _pair(torch.int8, 640, 640, seed=3, signed=True).to(cuda_device)
    assert int(pair.tiles.min()) <= -100
    for x_dtype in FLOATS:
        x = _x(pair.num_nodes, 128, 7, cuda_device).to(x_dtype)
        for out_dtype in FLOATS:
            y = rk.spmm_pair_resident(pair, x, k_pack=4, out_dtype=out_dtype)
            ref = rk.spmm_pair_resident_plain(pair, x, out_dtype).float()
            err = (y.float() - ref).abs()
            assert bool((err <= _pair_tol(ref, 2)).all()), (
                x_dtype, out_dtype, float(err.max()))
            y = rk.spmm_power_resident(pair, x, 2, k_pack=4, out_dtype=out_dtype,
                                       hop_scale=1e-5)
            ref = rk.spmm_power_resident_plain(pair, x, 2, out_dtype, 1e-5).float()
            err = (y.float() - ref).abs()
            assert bool((err <= _pair_tol(ref, 5)).all()), (
                x_dtype, out_dtype, float(err.max()))


# ---- the COO path (plain torch ops: gather, index_add_, scatter_reduce)


@pytest.mark.cuda
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
def test_coo_ops_on_card_match_cpu(cuda_device, index_dtype):
    """COO spmm, sddmm and segment_softmax on the card against the CPU on
    the same inputs.  index_add_ sums with atomics on the card, in another
    order from run to run: each f32 sum of k terms may differ by
    1e-5 * max|ref| * sqrt(k); sddmm and the softmax reorder nothing
    across edges, so they hold to 1e-6 relative."""
    from tpugraph_torch.ops import message

    s, r, w = _coo(4096, 60000, seed=30)
    w[::11] = 0.0
    x = _x(4096, 64, 31, "cpu")
    y = _x(4096, 64, 32, "cpu")
    st, rt, wt = (torch.from_numpy(a) for a in (s, r, w))
    st, rt = st.to(index_dtype), rt.to(index_dtype)
    dev = lambda *ts: [t.to(cuda_device) for t in ts]
    k = int(np.bincount(r).max())
    ref = message.spmm(st, rt, wt, x)
    out = message.spmm(*dev(st, rt, wt, x)).cpu()
    assert float((out - ref).abs().max()) <= _f32_tol(ref, k)
    ref = message.sddmm(st, rt, x, y)
    out = message.sddmm(*dev(st, rt, x, y)).cpu()
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-5)
    logits = torch.from_numpy(np.random.default_rng(33).standard_normal(
        s.size).astype(np.float32) * 3)
    mask = (wt != 0).float()
    ref = message.segment_softmax(logits, rt, 4100, mask)
    out = message.segment_softmax(*dev(logits, rt), 4100,
                                  mask.to(cuda_device)).cpu()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-7)


def _syn1():
    from tpugraph_torch.core import graph_from_edge_list
    from tpugraph_torch.data import gen_syn1

    G, labels, _ = gen_syn1(seed=0)
    g = graph_from_edge_list(G.number_of_nodes(), G.edges())
    feat = np.stack([G.feat[u] for u in G.nodes()])
    return G, g, feat, labels


@pytest.mark.cuda
def test_coo_training_on_card_matches_cpu(cuda_device):
    """20 COO epochs of syn1 on the card and on the CPU from one set of
    parameters: the loss trajectories agree within the smoke's rtol 2e-2
    / atol 2e-3 (atomic sums reorder every aggregation)."""
    from tpugraph_torch.nn import GcnEncoderNode, SparseAdj
    from tpugraph_torch.train import TrainConfig, train_node_classifier

    _, g, feat, labels = _syn1()
    dims = dict(input_dim=10, hidden_dim=20, embedding_dim=20, label_dim=4,
                num_layers=3)
    init = GcnEncoderNode(**dims, generator=torch.Generator().manual_seed(0),
                          device="cpu").state_dict()
    cfg = TrainConfig(num_epochs=20)
    cpu = train_node_classifier(GcnEncoderNode(**dims, device="cpu"), g, feat,
                                labels, cfg, init_params=init, device="cpu")
    gpu = train_node_classifier(GcnEncoderNode(**dims, device=cuda_device), g,
                                feat, labels, cfg, init_params=init,
                                device=cuda_device)
    assert isinstance(gpu["adj"], SparseAdj)
    assert gpu["adj"].weight.device.type == cuda_device.type
    np.testing.assert_allclose(gpu["history"]["loss"], cpu["history"]["loss"],
                               rtol=2e-2, atol=2e-3)
    assert gpu["history"]["loss"][-1] < gpu["history"]["loss"][0]


@pytest.mark.cuda
def test_coo_batched_explain_on_card_auc(cuda_device):
    """syn1 trained 1000 epochs on COO on the card, then the 60 stats
    nodes explained together on the card: motif AUC > 0.9."""
    from tpugraph_torch.data import preprocess_input_graph
    from tpugraph_torch.explain import Explainer
    from tpugraph_torch.nn import GcnEncoderNode
    from tpugraph_torch.train import TrainConfig, train_node_classifier

    G, g, feat, labels = _syn1()
    dims = dict(input_dim=10, hidden_dim=20, embedding_dim=20, label_dim=4,
                num_layers=3)
    model = GcnEncoderNode(**dims, generator=torch.Generator().manual_seed(0),
                           device=cuda_device)
    out = train_node_classifier(model, g, feat, labels,
                                TrainConfig(num_epochs=1000), device=cuda_device)
    assert out["result_test"]["acc"] >= 0.85
    data = preprocess_input_graph(G, labels)
    n = data["adj"].shape[1]
    ex = Explainer(GcnEncoderNode(**dims, device=cuda_device), out["params"],
                   data["adj"], data["feat"], data["labels"],
                   out["ypred"][:, :n], device=cuda_device)
    res = ex.explain_nodes_gnn_stats(list(range(400, 700, 5)))
    assert res["auc"] > 0.9, res["auc"]
    for r in res["results"]:
        ma = r["masked_adj"]
        assert ma.shape == (len(r["neighbors"]),) * 2
        assert bool(np.all(np.isfinite(ma)))
        np.testing.assert_allclose(ma, ma.T, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [64, 128])
def test_dw_autograd_on_card_matches_plain(cuda_device, block):
    """The GAT path's autograd functions: ``sddmm_dw`` (B2 forward; B1 on
    the score-gradient tiles and on their transpose) and
    ``bcsr_matvec_dw`` (B1 forward; B1 on the transposed tiles and B2
    backward) on the card against their CPU plain versions, on tiles
    rescaled as the GAT layer rescales them."""
    import dataclasses

    from tpugraph_torch.ops.bcsr_kernels import LAUNCHES

    s, r, w = _coo(384, 3000, seed=13)
    m_h = bcsr.bcsr_from_coo(s, r, w, 384, block=block)
    tp_h = bcsr.bcsr_transpose_plan(m_h)
    g = torch.Generator().manual_seed(4)
    a, b, x = (torch.randn((384, 20), generator=g) for _ in range(3))
    scale = torch.rand(m_h.tiles.shape, generator=g) + 0.5
    g_sc = torch.randn(m_h.tiles.shape, generator=g)
    g_y = torch.randn((384, 20), generator=g)
    outs = []
    for dev in ("cpu", cuda_device):
        m, tp = m_h.to(dev), tp_h.to(dev)
        a_d, b_d, x_d = (v.to(dev).requires_grad_() for v in (a, b, x))
        t_d = (m.tiles * scale.to(dev)).requires_grad_()
        before = dict(LAUNCHES)
        sc = bcsr_kernels.sddmm_dw(m, tp, a_d, b_d)
        da, db = torch.autograd.grad(sc, (a_d, b_d), g_sc.to(dev))
        y = bcsr_kernels.bcsr_matvec_dw(dataclasses.replace(m, tiles=t_d), tp, x_d)
        dt, dx = torch.autograd.grad(y, (t_d, x_d), g_y.to(dev))
        if dev != "cpu":
            assert LAUNCHES["sddmm_bcsr"] - before["sddmm_bcsr"] == 2
            assert LAUNCHES["spmm_bcsr"] - before["spmm_bcsr"] == 4
        outs.append([v.detach().cpu() for v in (sc, da, db, y, dt, dx)])
    for name, got, ref in zip(("scores", "da", "db", "y", "dtiles", "dx"),
                              outs[1], outs[0]):
        assert float((got - ref).abs().max()) <= _f32_tol(ref, 3 * block), name


@pytest.mark.cuda
def test_att_training_on_card_matches_cpu(cuda_device):
    """20 GAT epochs of syn1 on tiles (B2 scores, B1 over the scaled tiles)
    on the card and on the CPU from one set of parameters: the loss
    trajectories agree within 1e-4 (f32 sums in another order only)."""
    from tpugraph_torch.nn import GcnEncoderNode
    from tpugraph_torch.train import TrainConfig, train_node_classifier

    _, g, feat, labels = _syn1()
    dims = dict(input_dim=10, hidden_dim=20, embedding_dim=20, label_dim=4,
                num_layers=3, att=True)
    init = GcnEncoderNode(**dims, generator=torch.Generator().manual_seed(0),
                          device="cpu").state_dict()
    cfg = TrainConfig(num_epochs=20, use_bcsr=True)
    cpu = train_node_classifier(GcnEncoderNode(**dims, device="cpu"), g, feat,
                                labels, cfg, init_params=init, device="cpu")
    gpu = train_node_classifier(GcnEncoderNode(**dims, device=cuda_device), g,
                                feat, labels, cfg, init_params=init,
                                device=cuda_device)
    for out in (cpu, gpu):  # tiles with a transpose plan
        assert out["adj"].tp is not None and out["adj"].m_t is None
    np.testing.assert_allclose(gpu["history"]["loss"], cpu["history"]["loss"],
                               rtol=1e-4, atol=1e-4)
    assert gpu["history"]["loss"][-1] < gpu["history"]["loss"][0]


def _synbench(tmp_path, n_graphs, random_feats):
    """SYNBENCH's first ``n_graphs`` graphs (``chip_smoke.write_tu_synthetic``,
    seed 0) split as the CLI splits them, with node-label features or
    seeded N(0, 1) features of width 4 (one maximum a channel in the
    max-pool readout)."""
    import chip_smoke
    from tpugraph_torch.data import prepare_data, read_graphfile

    chip_smoke.write_tu_synthetic(str(tmp_path), "SYNB", n_graphs=n_graphs, seed=0)
    graphs = read_graphfile(str(tmp_path), "SYNB", max_nodes=100)
    rng = np.random.default_rng(1)
    for G in graphs:
        G.feat = {u: (rng.standard_normal(4).astype(np.float32) if random_feats
                      else np.asarray(lab, np.float32))
                  for u, lab in G.node_label.items()}
    return prepare_data(graphs, max_nodes=100, rng=np.random.default_rng(0))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["base", "soft-assign"])
def test_graph_training_on_card_matches_cpu(cuda_device, tmp_path, method):
    """5 epochs of graph classification (40 SYNBENCH graphs, batches of 8)
    on the card and on the CPU from one set of parameters: the loss
    trajectories agree within 1e-4 (f32 sums of the dense matmuls in
    another order; TF32 off)."""
    from tpugraph_torch.nn import GcnEncoderGraph, SoftPoolingGcnEncoder
    from tpugraph_torch.train import TrainConfig, train_graph_classifier

    tr, va, te = _synbench(tmp_path, 40, random_feats=True)
    if method == "base":
        make = lambda dev: GcnEncoderGraph(tr.feat_dim, 20, 20, 2, 3, device=dev)
    else:
        make = lambda dev: SoftPoolingGcnEncoder(
            tr.max_num_nodes, tr.feat_dim, 20, 20, 2, 3, 20, assign_ratio=0.1,
            assign_input_dim=tr.assign_feat_dim, device=dev)
    init = make("cpu").state_dict()
    cfg = TrainConfig(num_epochs=5, batch_size=8, eval_every=2)
    outs = [train_graph_classifier(make(dev), tr, cfg, val_batcher=va,
                                   test_batcher=te, linkpred=method != "base",
                                   init_params=init, device=dev)
            for dev in ("cpu", cuda_device)]
    np.testing.assert_allclose(outs[1]["history"]["loss"],
                               outs[0]["history"]["loss"], rtol=1e-4, atol=1e-4)
    assert np.all(np.isfinite(outs[1]["cg"]["pred"]))


@pytest.mark.cuda
def test_explain_graph_bcsr_on_card_matches_cpu(cuda_device, tmp_path):
    """The tile-space graph explainer at block 128 on the card (B1 forward
    and backward, B2 for the mask gradient) against the CPU's plain
    versions from the same init (a CPU generator), 20 mask epochs: every
    mask entry within 1e-4, and B1/B2 launched on the card."""
    from tpugraph_torch import ops
    from tpugraph_torch.explain import ExplainConfig, Explainer
    from tpugraph_torch.nn import GcnEncoderGraph

    tr, _, _ = _synbench(tmp_path, 20, random_feats=True)
    b = tr.batch(np.arange(len(tr)))
    init = GcnEncoderGraph(tr.feat_dim, 20, 20, 2, 3,
                           generator=torch.Generator().manual_seed(0),
                           device="cpu").state_dict()
    masks = []
    for dev in ("cpu", cuda_device):
        ex = Explainer(GcnEncoderGraph(tr.feat_dim, 20, 20, 2, 3, device=dev),
                       init, b.adj, b.feats, b.label, np.zeros((1, len(b.label), 2)),
                       graph_mode=True, cfg=ExplainConfig(num_epochs=20),
                       device=dev)
        ops.reset_launch_counts()
        masks.append([ex.explain_graph_bcsr(i)["masked_adj"] for i in (0, 1)])
        counts = ops.launch_counts()
    assert counts["spmm_bcsr"] > 0 and counts["sddmm_bcsr"] > 0
    for got, ref in zip(masks[1], masks[0]):
        assert got.shape == ref.shape == (100, 100)
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
        assert np.any(got != 0)


@pytest.mark.cuda
@pytest.mark.parametrize("opt,sched", [("adam", "cos"), ("sgd", "step"),
                                       ("rmsprop", "none"), ("adagrad", "step")])
def test_optimizer_steps_on_card_match_cpu(cuda_device, opt, sched):
    """100 updates of the optimizer chain (clip 2.0 acting on some, weight
    decay, a schedule past its first decay or restart) on one gradient
    stream, on the card and on the CPU: the parameters within 1e-6 of
    their scale, and the update count in the state."""
    from tpugraph_torch.train.optim import OptimizerConfig, build_optimizer

    rng = np.random.default_rng(0)
    shapes = [(10, 20), (20,), (20, 4)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(10.0 ** rng.uniform(-2, 0) * rng.standard_normal(s)).astype(np.float32)
              for s in shapes] for _ in range(100)]
    cfg = OptimizerConfig(opt=opt, lr=0.01, scheduler=sched, decay_step=40,
                          decay_rate=0.5, restart=60, weight_decay=0.005, clip=2.0)
    out = []
    for dev in ("cpu", cuda_device):
        ps = [torch.nn.Parameter(torch.from_numpy(a.copy()).to(dev)) for a in init]
        o = build_optimizer(ps, cfg)
        for gs in grads:
            for p, g in zip(ps, gs):
                p.grad = torch.from_numpy(g).to(dev)
            o.step()
        assert o.state_dict()["count"] == 100
        out.append([p.detach().cpu().numpy() for p in ps])
    for got, ref in zip(out[1], out[0]):
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [False, True])
def test_grad_baseline_batch_on_card_matches_cpu(cuda_device, bn):
    """The grad and att baselines of 20 syn1 queries in one mapped call on
    the card and on the CPU, from one set of parameters: every saliency
    within 1e-5."""
    from tpugraph_torch.core import extract_dense_subgraph
    from tpugraph_torch.data import gen_syn1, preprocess_input_graph
    from tpugraph_torch.explain import baselines
    from tpugraph_torch.nn import GcnEncoderNode

    G, labels, _ = gen_syn1(seed=0)
    cg = preprocess_input_graph(G, labels)
    n = cg["adj"].shape[1]
    feat = np.random.default_rng(1).standard_normal((n, 10)).astype(np.float32)
    qs = [extract_dense_subgraph(cg["adj"][0], feat, cg["labels"][0], q, 3)
          for q in range(400, 700, 15)]
    args = ([q[1] for q in qs], [q[2] for q in qs])
    init = GcnEncoderNode(10, 20, 20, 4, 3, bn=bn, att=True,
                          generator=torch.Generator().manual_seed(0),
                          device="cpu").state_dict()
    outs = []
    for dev in ("cpu", cuda_device):
        model = GcnEncoderNode(10, 20, 20, 4, 3, bn=bn, att=True, device=dev)
        model.load_state_dict(init)
        model.eval()
        model.requires_grad_(False)
        outs.append(baselines.grad_saliency_batch(
            model, *args, [q[0] for q in qs], [q[0] % 4 for q in qs])
            + baselines.attention_saliency_batch(model, *args))
    for got, ref in zip(outs[1], outs[0]):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_align_on_card_matches_cpu(cuda_device):
    """align_explanations on the card and on the CPU from the same inputs:
    P within 1e-5 after 300 steps at lr 1e-3 (the conditioned case) and
    after 10 at the default lr."""
    from tpugraph_torch.explain.align import align_explanations

    rng = np.random.default_rng(0)
    ins = []
    for n in (7, 9):
        up = np.triu(rng.uniform(0.1, 1.0, (n, n)) * (rng.random((n, n)) < 0.5), 1)
        ins += [rng.standard_normal((n, 4)).astype(np.float32),
                (up + up.T).astype(np.float32)]
    for steps, lr in ((300, 1e-3), (10, 0.01)):
        got, ref = (align_explanations(ins[0], ins[1], 2, ins[2], ins[3], 5,
                                       num_steps=steps, lr=lr, device=dev)[0]
                    for dev in (cuda_device, "cpu"))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)



@pytest.mark.cuda
def test_align_segments_on_card_match_cpu(cuda_device):
    """A 1000-step alignment at the default lr on the card, held a segment
    at a time: from its state at every 100th step the CPU takes 10 steps
    and lands within 1e-4 of the card's P; the segmented run is
    align_explanations' on the card."""
    from tpugraph_torch.explain.align import Alignment, align_explanations

    rng = np.random.default_rng(0)
    ins = []
    for n in (7, 9):
        up = np.triu(rng.uniform(0.1, 1.0, (n, n)) * (rng.random((n, n)) < 0.5), 1)
        ins += [rng.standard_normal((n, 4)).astype(np.float32),
                (up + up.T).astype(np.float32)]
    args = (ins[0], ins[1], 2, ins[2], ins[3], 5)
    card = Alignment(*args, device=cuda_device)
    for _ in range(10):
        state = card.state()
        card.step(10)
        cpu = Alignment(*args, device="cpu")
        cpu.load(state)
        cpu.step(10)
        np.testing.assert_allclose(card.result()[0], cpu.result()[0],
                                   rtol=0, atol=1e-4)
        card.step(90)
    np.testing.assert_array_equal(
        card.result()[0], align_explanations(*args, device=cuda_device)[0])

def _halo_shards(n_dev=4, block=64):
    """The 4-shard BCSR halo plan (with transpose plans) of a random
    graph: rectangular ``[local | halo]`` tiles padded with dead tiles to
    the largest shard's count."""
    from tpugraph_torch.core.graph import graph_from_edges
    from tpugraph_torch.parallel import spmd

    rng = np.random.default_rng(9)
    n = 1024
    s = rng.integers(0, n, 6000)
    r = (s + rng.integers(-200, 200, 6000)) % n
    g = graph_from_edges(np.concatenate([s, r]), np.concatenate([r, s]), n)
    plan = spmd.build_halo_plan(g, n_dev)
    return spmd.build_halo_bcsr(plan, n_dev, block=block, att=True)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [10, 20, 128])
def test_halo_shards_match_plain(cuda_device, d):
    """B1 on each shard's rectangular tiles and on its transpose, with the
    dead tiles that pad it, and B2 over its padded transpose plan (the
    transposed tiles in row-block order), each against its plain twin."""
    plan = _halo_shards()
    dead = [int((~m.tiles.reshape(m.num_tiles, -1).any(1)).sum()) for m in plan.m]
    assert max(dead) > 0
    for d_, (m_h, mt_h, tp_h) in enumerate(zip(plan.m, plan.m_t, plan.tp)):
        m, mt, tp = m_h.to(cuda_device), mt_h.to(cuda_device), tp_h.to(cuda_device)
        x = _x(m.num_nodes, d, d_, cuda_device)
        dy = _x(m.num_row_nodes, d, d_ + 10, cuda_device)
        for mat, inp in ((m, x), (mt, dy)):
            y = bcsr_kernels.spmm_bcsr(mat, inp)
            ref = bcsr_kernels.spmm_bcsr_plain(mat, inp)
            assert float((y - ref).abs().max()) <= _f32_tol(ref, 4 * mat.block)
        g = bcsr_kernels.sddmm_bcsr(m, dy, x)
        ref = bcsr_kernels.sddmm_bcsr_plain(m, dy, x)
        assert float((g - ref).abs().max()) <= _f32_tol(ref, d)
        m_T = bcsr.transposed_bcsr(g, tp)
        yt = bcsr_kernels.spmm_bcsr(m_T, dy)
        ref = bcsr_kernels.spmm_bcsr_plain(m_T, dy)
        assert float((yt - ref).abs().max()) <= _f32_tol(ref, 4 * m.block)


@pytest.mark.cuda
def test_halo_exchange_one_nccl_rank(cuda_device):
    """halo_exchange over a 1-rank NCCL group is the plain gather
    ``x[send_idx]``, forward and (the reverse exchange) backward, flat and
    issued asynchronously."""
    from tpugraph_torch.nn.layers import halo_exchange, start_halo_exchange
    from tpugraph_torch.parallel.launch import single_rank
    from tpugraph_torch.parallel.mesh import make_mesh

    x = _x(200, 20, 1, cuda_device).requires_grad_()
    send = torch.randint(0, 200, (1, 48), device=cuda_device)
    with single_rank("nccl"):
        mesh = make_mesh()
        got = halo_exchange(x, send, mesh)
        got_async = start_halo_exchange(x, send, mesh).wait()
        (got * got).sum().backward()
    ref = x.detach()[send]
    assert torch.equal(got.detach(), ref) and torch.equal(got_async.detach(), ref)
    want = torch.zeros_like(x).index_add_(0, send[0], 2 * ref[0])
    assert float((x.grad - want).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_sharded_bcsr_explain_one_nccl_rank(cuda_device):
    """explain_nodes_bcsr(mesh=) over a 1-rank NCCL group launches B1 and
    B2 and gives the sequential card run's masks (the same kernels on the
    same inputs) and the CPU's within 1e-4, 10 mask epochs on syn1."""
    from tpugraph_torch import ops
    from tpugraph_torch.data import preprocess_input_graph
    from tpugraph_torch.explain import ExplainConfig, Explainer
    from tpugraph_torch.nn import GcnEncoderNode
    from tpugraph_torch.parallel.launch import single_rank
    from tpugraph_torch.parallel.mesh import make_mesh

    G, _, feat, labels = _syn1()
    data = preprocess_input_graph(G, labels)
    n = data["adj"].shape[1]
    dims = dict(input_dim=10, hidden_dim=20, embedding_dim=20, label_dim=4,
                num_layers=3)
    init = GcnEncoderNode(**dims, generator=torch.Generator().manual_seed(0),
                          device="cpu").state_dict()
    pred = np.eye(4, dtype=np.float32)[np.asarray(labels)[:n]][None]
    nodes = [400, 460, 520]

    def explainer(dev):
        return Explainer(GcnEncoderNode(**dims, device=dev), init, data["adj"],
                         data["feat"], data["labels"], pred,
                         cfg=ExplainConfig(num_epochs=10), device=dev)

    ex = explainer(cuda_device)
    seq = ex.explain_nodes_bcsr(nodes)
    ops.reset_launch_counts()
    with single_rank("nccl"):
        sharded = ex.explain_nodes_bcsr(nodes, mesh=make_mesh())
    counts = ops.launch_counts()
    assert counts["spmm_bcsr"] > 0 and counts["sddmm_bcsr"] > 0
    cpu = explainer("cpu").explain_nodes_bcsr(nodes)
    for a, b, c in zip(sharded, seq, cpu):
        np.testing.assert_allclose(a["masked_adj"], b["masked_adj"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(a["masked_adj"], c["masked_adj"], atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_all_gather_cols_and_tp_step_one_nccl_rank(cuda_device):
    """all_gather_cols over a 1-rank NCCL group is a copy forward and
    backward, and 5 tensor-parallel Adam steps there give the losses of
    one device within 1e-5."""
    from tpugraph_torch.nn import GcnEncoderNode, SparseAdj
    from tpugraph_torch.nn.losses import node_cross_entropy
    from tpugraph_torch.parallel.collectives import all_gather_cols
    from tpugraph_torch.parallel.launch import single_rank
    from tpugraph_torch.parallel.tp import tp_fit
    from tpugraph_torch.train.optim import OptimizerConfig, build_optimizer

    x = _x(64, 24, 3, cuda_device).requires_grad_()
    _, g, feat, labels = _syn1()
    dims = dict(input_dim=10, hidden_dim=20, embedding_dim=20, label_dim=4,
                num_layers=3)
    model = GcnEncoderNode(**dims, generator=torch.Generator().manual_seed(0),
                           device=cuda_device)
    y = np.zeros(g.num_nodes_padded, np.int64)
    y[: len(labels)] = labels
    mask = g.node_mask.numpy()
    xf = np.zeros((g.num_nodes_padded, 10), np.float32)
    xf[: len(feat)] = feat
    cfg = OptimizerConfig(opt="adam", lr=1e-2)
    with single_rank("nccl"):
        got = all_gather_cols(x, None)
        (got * got).sum().backward()
        tp = tp_fit(None, model, g, xf, y, mask, 5, cfg)
    assert torch.equal(got.detach(), x.detach())
    assert float((x.grad - 2 * x.detach()).abs().max()) == 0.0
    opt = build_optimizer(model.parameters(), cfg)
    adj = SparseAdj(*(t.to(cuda_device) for t in (g.senders.long(), g.receivers.long(),
                                                  g.edge_weight)))
    xt, yt, mt = (torch.from_numpy(a).to(cuda_device) for a in (xf, y, mask))
    want = []
    for _ in range(5):
        opt.zero_grad()
        loss = node_cross_entropy(model(xt, adj)[0], yt, node_mask=mt)
        loss.backward()
        opt.step()
        want.append(float(loss.detach()))
    np.testing.assert_allclose(tp["losses"], want, rtol=1e-5, atol=1e-6)
