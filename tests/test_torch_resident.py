"""The port's column-stacked layout and B4 (spmm_stacked_resident) against
tpugraph's ``ops/pallas_resident.py`` (Pallas in interpret mode on the
CPU): byte-identical packers, the plain kernel version and the
x-gradient of the custom VJP."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpugraph.ops import bcsr as jax_bcsr
from tpugraph.ops import pallas_resident as jax_res
from tpugraph_torch.ops import bcsr
from tpugraph_torch.ops import resident_kernels as rk

torch.set_num_threads(1)

TOL = 1e-5              # float32 sums in another order
BF16_REL = 2.0 ** -8    # one bf16 rounding of the output (8 significant bits)
JAX_DT = {None: None, torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8}


def _coo(n, e, seed, integer=False, rows_below=None):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, rows_below or n, e).astype(np.int32)
    w = rng.integers(1, 4, e) if integer else rng.standard_normal(e)
    return s, r, w.astype(np.float32)


def _bytes(a):
    """Raw bytes of a numpy / jax / torch array (bfloat16 included)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().tobytes(), str(a.dtype)
    a = np.asarray(a)
    return a.tobytes(), {"bfloat16": "torch.bfloat16"}.get(a.dtype.name,
                                                            f"torch.{a.dtype.name}")


def _assert_same_layout(st_j, st_t):
    for f in ("tiles", "col_blk", "rows"):
        assert _bytes(getattr(st_j, f)) == _bytes(getattr(st_t, f)), f
    assert tuple(np.asarray(st_j.tiles).shape) == tuple(st_t.tiles.shape)
    for f in ("num_nodes", "num_row_nodes", "block", "stack", "packed4"):
        assert getattr(st_j, f) == getattr(st_t, f), f


def _both(s, r, w, n, block, tile_dtype=None, pad_rows_to=None):
    m_j = jax_bcsr.bcsr_from_coo(s, r, w, n, block=block,
                                 tile_dtype=JAX_DT[tile_dtype],
                                 pad_rows_to=pad_rows_to, device=False)
    m_t = bcsr.bcsr_from_coo(s, r, w, n, block=block, tile_dtype=tile_dtype,
                             pad_rows_to=pad_rows_to)
    return m_j, m_t


@pytest.mark.parametrize("case", [
    # stack=1 with the dead tiles of pad_rows_to and of an empty row block
    dict(stack=1, k_pack=4, pad_rows_to=4, rows_below=256),
    dict(stack=1, k_pack=64, pad_rows_to=None, rows_below=None),
    # stack=2: lexsort grouping, odd groups, dead tiles dropped
    dict(stack=2, k_pack=4, pad_rows_to=4, rows_below=256),
    dict(stack=2, k_pack=1, pad_rows_to=None, rows_below=None),
])
@pytest.mark.parametrize("tile_dtype", [None, torch.bfloat16, torch.int8])
def test_stack_bcsr_byte_identical(case, tile_dtype):
    s, r, w = _coo(512, 700, seed=case["k_pack"] + case["stack"],
                   rows_below=case["rows_below"])
    m_j, m_t = _both(s, r, w, 512, 128, tile_dtype, case["pad_rows_to"])
    st_j = jax_res.stack_bcsr(m_j, stack=case["stack"], k_pack=case["k_pack"])
    st_t = rk.stack_bcsr(m_t, stack=case["stack"], k_pack=case["k_pack"])
    _assert_same_layout(st_j, st_t)


def test_stack_bcsr_odd_groups_and_empty_graph():
    """Column groups of size 3 pad their last stack with an empty lane
    that repeats lane 0's row (tests/test_resident.py:92); a graph with
    no edges gives k_pack all-dead stacks."""
    rng = np.random.default_rng(2)
    block = 128
    rb, cb = np.meshgrid(np.arange(3), np.arange(3), indexing="ij")
    s = (cb.ravel() * block + rng.integers(0, block, 9)).astype(np.int32)
    r = (rb.ravel() * block + rng.integers(0, block, 9)).astype(np.int32)
    w = np.ones(9, np.float32)
    m_j, m_t = _both(s, r, w, 3 * block, block)
    for stack in (2, 4):
        _assert_same_layout(jax_res.stack_bcsr(m_j, stack=stack, k_pack=2),
                            rk.stack_bcsr(m_t, stack=stack, k_pack=2))
    e = np.zeros(0, np.int32)
    m_j, m_t = _both(e, e, np.zeros(0, np.float32), 512, block)
    for stack in (1, 2):
        st_t = rk.stack_bcsr(m_t, stack=stack, k_pack=4)
        _assert_same_layout(jax_res.stack_bcsr(m_j, stack=stack, k_pack=4), st_t)
        y = rk.spmm_stacked_resident(st_t.to("cpu"), torch.ones(512, 8))
        assert y.shape == (512, 8) and not bool(y.any())


def test_pack_stacked_int4_byte_identical_and_range():
    s, r, w = _coo(512, 900, seed=5, integer=True)
    m_j, m_t = _both(s, r, w, 512, 128, torch.int8)
    for stack in (1, 2):
        st_j = jax_res.pack_stacked_int4(jax_res.stack_bcsr(m_j, stack, 4))
        st_t = rk.pack_stacked_int4(rk.stack_bcsr(m_t, stack, 4))
        _assert_same_layout(st_j, st_t)
        assert st_t.packed4 and st_t.tiles.shape[2] == 64
        assert torch.equal(st_t.slots, rk.stack_bcsr(m_t, stack, 4).slots)
    _, m_neg = _both(s, r, -w, 512, 128, torch.int8)
    with pytest.raises(ValueError, match=r"\[0, 15\]"):
        rk.pack_stacked_int4(rk.stack_bcsr(m_neg, 1, 4))


@pytest.mark.parametrize("args", [(64, 1, 256, 1, False), (4, 2, 128, 2, False),
                                  (16, 2, 256, 1, True)])
def test_tile_window_bytes_for(args):
    assert rk.tile_window_bytes_for(*args) == jax_res.tile_window_bytes_for(*args)


def test_row_index_groups_entries_by_row_block():
    s, r, w = _coo(512, 700, seed=9)
    st = rk.stack_bcsr(bcsr.bcsr_from_coo(s, r, w, 512, block=128), 2, 4)
    rows = torch.as_tensor(st.rows).long()
    slots = st.slots.long()
    ptr = st.row_ptr.long()
    assert int(ptr[-1]) == rows.numel()
    for rb in range(st.num_row_blocks):
        seg = slots[ptr[rb]:ptr[rb + 1]]
        assert bool((rows[seg] == rb).all()) and bool((seg[1:] > seg[:-1]).all())


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stack", [1, 2])
@pytest.mark.parametrize("tile_dtype", [None, torch.bfloat16, torch.int8])
def test_plain_matches_pallas(tile_dtype, stack, out_dtype):
    """f32 tiles: f32 products; bf16/int8 tiles: x rounded to bf16 first
    (``pallas_resident.py:263-267``); f32 sums in another order, so
    1e-5, plus one bf16 rounding of the output for a bf16 out_dtype."""
    n, d = 512, 128
    s, r, w = _coo(n, 1500, seed=stack, integer=tile_dtype == torch.int8)
    m_j, m_t = _both(s, r, w, n, 128, tile_dtype)
    x = np.random.default_rng(1).standard_normal((n, d)).astype(np.float32)
    st_j = jax_res.stack_bcsr(m_j, stack=stack, k_pack=4)
    jdt = jnp.bfloat16 if out_dtype == torch.bfloat16 else None
    ref = np.asarray(jax_res.spmm_stacked_resident(
        st_j, jnp.asarray(x), k_pack=4, interpret=True,
        out_dtype=jdt).astype(jnp.float32))
    st_t = rk.stack_bcsr(m_t, stack=stack, k_pack=4).to("cpu")
    y = rk.spmm_stacked_resident(st_t, torch.from_numpy(x), out_dtype=out_dtype)
    assert y.dtype == out_dtype
    tol = TOL * np.abs(ref).max() + (BF16_REL * np.abs(ref)
                                     if out_dtype == torch.bfloat16 else 0)
    assert np.all(np.abs(y.float().numpy() - ref) <= tol)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_plain_int4_matches_pallas(out_dtype):
    n, d = 512, 128
    s, r, w = _coo(n, 1500, seed=4, integer=True)
    m_j, m_t = _both(s, r, w, n, 128, torch.int8)
    x = np.random.default_rng(2).standard_normal((n, d)).astype(np.float32)
    st_j = jax_res.pack_stacked_int4(jax_res.stack_bcsr(m_j, 2, 4))
    jdt = jnp.bfloat16 if out_dtype == torch.bfloat16 else None
    ref = np.asarray(jax_res.spmm_stacked_resident(
        st_j, jnp.asarray(x), k_pack=4, interpret=True,
        out_dtype=jdt).astype(jnp.float32))
    st_t = rk.pack_stacked_int4(rk.stack_bcsr(m_t, 2, 4)).to("cpu")
    y = rk.spmm_stacked_resident(st_t, torch.from_numpy(x), out_dtype=out_dtype)
    tol = TOL * np.abs(ref).max() + (BF16_REL * np.abs(ref)
                                     if out_dtype == torch.bfloat16 else 0)
    assert np.all(np.abs(y.float().numpy() - ref) <= tol)


@pytest.mark.parametrize("tile_dtype", [None, torch.int8])
def test_stacked_matvec_grad_matches_jax(tile_dtype):
    """StackedMatvec's x-gradient is B4 on the transposed stacks, as
    jax.grad through the custom VJP; 1e-5 relative (order only)."""
    n, d = 384, 128
    s, r, w = _coo(n, 1200, seed=6, integer=True)
    m_j, m_t = _both(s, r, w, n, 128, tile_dtype)
    mt_j = jax_bcsr.bcsr_transpose_host(s, r, w, n, block=128,
                                        tile_dtype=JAX_DT[tile_dtype],
                                        device=False)
    mt_t = bcsr.bcsr_transpose_host(s, r, w, n, block=128, tile_dtype=tile_dtype)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    st_j, stt_j = jax_res.stack_bcsr(m_j, 1, 4), jax_res.stack_bcsr(mt_j, 1, 4)

    def f(xx):
        return jnp.sum(jax_res.stacked_matvec(st_j, stt_j, xx, interpret=True,
                                              k_pack=4) * c)

    ref = np.asarray(jax.grad(f)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = rk.stacked_matvec(rk.stack_bcsr(m_t, 1, 4).to("cpu"),
                          rk.stack_bcsr(mt_t, 1, 4).to("cpu"), xt)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(c))
    assert dx.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy(), ref, rtol=0,
                               atol=TOL * np.abs(ref).max())


def test_wrapper_rejects_bad_inputs():
    s, r, w = _coo(256, 300, seed=8)
    st = rk.stack_bcsr(bcsr.bcsr_from_coo(s, r, w, 256), 1, 4).to("cpu")
    with pytest.raises(ValueError):
        rk.spmm_stacked_resident(st, torch.ones(255, 8))
    with pytest.raises(ValueError):
        rk.spmm_stacked_resident(st, torch.ones(256, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="out_dtype"):
        rk.spmm_stacked_resident(st, torch.ones(256, 8), out_dtype=torch.float16)
    meta = st.to("meta")
    with pytest.raises(ValueError, match="no spmm_stacked_resident kernel"):
        rk.spmm_stacked_resident(meta, torch.ones(256, 8, device="meta"))
