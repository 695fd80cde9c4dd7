"""The port's edge-packet layout and B7 (spmm_packets) against tpugraph's
``ops/packets.py`` and ``ops/pallas_packets.py`` (Pallas in interpret
mode on the CPU), and the port's ``resolve_bcsr_format`` against the
precedence cases of ``tests/test_packets.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpugraph.ops import packets as jax_packets
from tpugraph.ops import pallas_packets as jax_pk
from tpugraph.train import loop as jax_loop
from tpugraph_torch.ops import csr as row_csr
from tpugraph_torch.ops import packets, packets_kernels
from tpugraph_torch.ops.csr import spmm_csr_plain
from tpugraph_torch.train import TrainConfig, resolve_bcsr_format

torch.set_num_threads(1)

TOL = 1e-5  # float32 sums in another order, relative to max |y|
JAX_CD = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _coo(n, e, seed, hub=False):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n // 2, e).astype(np.int32)  # empty upper row blocks
    if hub:  # one sender block far over K edges: a tile split over packets
        s[: e // 3] = rng.integers(0, 8, e // 3)
    w = rng.standard_normal(e).astype(np.float32)
    w[::9] = 0.0  # padding-style zero weights are dropped
    return s, r, w


@pytest.mark.parametrize("geom", [(32, 32, 8, 8), (64, 32, 16, 8),
                                  (32, 64, 8, 1), (128, 128, 32, 4)])
@pytest.mark.parametrize("hub", [False, True])
def test_pack_edges_byte_identical(geom, hub):
    br, bc, k, pkm = geom
    s, r, w = _coo(300, 900, seed=br + k, hub=hub)
    for fn in ("pack_edges", "pack_edges_transpose"):
        p_j = getattr(jax_packets, fn)(s, r, w, 300, block_r=br, block_c=bc,
                                       k=k, pk_multiple=pkm)
        p_t = getattr(packets, fn)(s, r, w, 300, block_r=br, block_c=bc, k=k,
                                   pk_multiple=pkm)
        for f in ("rows", "cols", "w", "row_of", "col_blk"):
            a, b = np.asarray(getattr(p_j, f)), getattr(p_t, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert a.tobytes() == b.tobytes(), (fn, f)
        assert (p_j.num_nodes, p_j.block_r, p_j.block_c) == (
            p_t.num_nodes, p_t.block_r, p_t.block_c)
        # every row block holds a multiple of pk_multiple packets
        counts = np.diff(p_t.row_ptr)
        assert np.all(counts % pkm == 0) and np.all(counts > 0)
        np.testing.assert_array_equal(
            np.repeat(np.arange(p_t.num_row_blocks), counts), p_t.row_of)
        np.testing.assert_array_equal(packets.packets_to_dense(p_t),
                                      jax_packets.packets_to_dense(p_j))
        n_live = int((w != 0).sum())
        st_j = jax_packets.packet_stats(p_j, n_live)
        assert packets.packet_stats(p_t, n_live) == st_j


def test_pack_edges_empty_graph():
    e = np.zeros(0, np.int32)
    p = packets.pack_edges(e, e, np.zeros(0, np.float32), 64, 32, 32, 8)
    p_j = jax_packets.pack_edges(e, e, np.zeros(0, np.float32), 64, 32, 32, 8)
    assert p.num_packets == p_j.num_packets == 16
    y = packets_kernels.spmm_packets(p.to("cpu"), torch.ones(64, 4))
    assert y.shape == (64, 4) and not bool(y.any())


def _x(rows, d, seed):
    return np.random.default_rng(seed).standard_normal((rows, d)).astype(np.float32)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hub", [False, True])
def test_plain_matches_pallas(compute_dtype, hub):
    """f32: g = w x; bf16: w and x rounded, g rounded again
    (``pallas_packets.py:116-128``); both sum in f32, in another order."""
    n, d = 200, 128
    s, r, w = _coo(n, 700, seed=3, hub=hub)
    p_j = jax_packets.pack_edges(s, r, w, n, block_r=32, block_c=32, k=8)
    p_t = packets.pack_edges(s, r, w, n, block_r=32, block_c=32, k=8)
    x = _x(p_t.num_nodes, d, 1)
    ref = np.asarray(jax_pk.spmm_packets(
        p_j, jnp.asarray(x), interpret=True,
        compute_dtype=JAX_CD[compute_dtype]))
    y = packets_kernels.spmm_packets(p_t.to("cpu"), torch.from_numpy(x),
                                     compute_dtype=compute_dtype).numpy()
    np.testing.assert_allclose(y, ref, rtol=0, atol=TOL * np.abs(ref).max())
    if compute_dtype == torch.float32:  # the CPU default is f32, as in JAX
        y0 = packets_kernels.spmm_packets(p_t.to("cpu"), torch.from_numpy(x))
        np.testing.assert_array_equal(y0.numpy(), y)


def test_plain_bf16_out_matches_pallas():
    n, d = 200, 128
    s, r, w = _coo(n, 700, seed=4)
    p_j = jax_packets.pack_edges(s, r, w, n, block_r=32, block_c=32, k=8)
    p_t = packets.pack_edges(s, r, w, n, block_r=32, block_c=32, k=8)
    x = _x(p_t.num_nodes, d, 2)
    ref = np.asarray(jax_pk.spmm_packets(p_j, jnp.asarray(x), interpret=True,
                                         out_dtype=jnp.bfloat16
                                         ).astype(jnp.float32))
    y = packets_kernels.spmm_packets(p_t.to("cpu"), torch.from_numpy(x),
                                     out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16
    # one bf16 rounding of f32 sums that differ only in order
    tol = TOL * np.abs(ref).max() + 2.0 ** -8 * np.abs(ref)
    assert np.all(np.abs(y.float().numpy() - ref) <= tol)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_packets_matvec_grad_matches_jax(compute_dtype):
    """PacketsMatvec's x-gradient is B7 on the transposed packets, as
    jax.grad through the custom VJP; 1e-5 relative (order only)."""
    n, d = 160, 128
    s, r, w = _coo(n, 600, seed=5)
    geom = dict(block_r=32, block_c=32, k=8)
    p_j = jax_packets.pack_edges(s, r, w, n, **geom)
    pt_j = jax_packets.pack_edges_transpose(s, r, w, n, **geom)
    x = _x(p_j.num_nodes, d, 3)
    c = _x(p_j.num_nodes, d, 4)
    cd = JAX_CD[compute_dtype]

    def f(xx):
        return jnp.sum(jax_pk.packets_matvec(p_j, pt_j, xx, interpret=True,
                                             compute_dtype=cd) * c)

    ref = np.asarray(jax.grad(f)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = packets_kernels.packets_matvec(
        packets.pack_edges(s, r, w, n, **geom).to("cpu"),
        packets.pack_edges_transpose(s, r, w, n, **geom).to("cpu"), xt,
        compute_dtype=compute_dtype)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(c))
    np.testing.assert_allclose(dx.numpy(), ref, rtol=0,
                               atol=TOL * np.abs(ref).max())


def _hub_packets(seed, br=32, bc=32, k=8, n=256, e=3000):
    """A hub-heavy graph: over half its edges land in receiver block 0,
    spread over every sender block, and the receiver blocks of the upper
    half get no edge (one dead packet group each)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e).astype(np.int32)
    r = np.where(rng.random(e) < 0.6, rng.integers(0, br, e),
                 rng.integers(0, n // 2, e)).astype(np.int32)
    w = rng.standard_normal(e).astype(np.float32)
    p = packets.pack_edges(s, r, w, n, block_r=br, block_c=bc, k=k)
    p_j = jax_packets.pack_edges(s, r, w, n, block_r=br, block_c=bc, k=k)
    return p, p_j, s, r, w


def _live_slots(p):
    """(global receiver row, x row, flat slot) of every live slot of
    ``p``, in packet-and-slot order."""
    live = np.flatnonzero(p.w.reshape(-1) != 0)
    pk, k = live // p.k, live % p.k
    row = p.row_of[pk].astype(np.int64) * p.block_r + p.rows[pk, k]
    src = p.col_blk[pk].astype(np.int64) * p.block_c + p.cols[pk, k]
    return row, src, live


@pytest.mark.parametrize("chunk", [16, 100, 1 << 20])
def test_schedule_covers_every_live_slot_once(chunk, monkeypatch):
    """The row schedule lists every live slot exactly once and no dead
    one, rows in order and, within a row, packet and slot order kept;
    each edge's x row and the row offsets agree with the packets."""
    monkeypatch.setattr(row_csr, "CHUNK_EDGES", chunk)
    p, _, s, r, w = _hub_packets(seed=1)
    counts = np.diff(p.row_ptr)
    assert counts[0] > 0.5 * p.num_packets  # the hub block
    sc = packets_kernels.packet_schedule(p)
    slot, src = sc.eid.numpy().astype(np.int64), sc.col.numpy()
    rowptr = sc.rowptr.numpy().astype(np.int64)
    row, want_src, live = _live_slots(p)
    assert len(slot) == len(live) == int((w != 0).sum())
    np.testing.assert_array_equal(np.sort(slot), live)  # once each, none dead
    assert np.all(p.w.reshape(-1)[slot] != 0)
    order = np.lexsort((live, row))  # by row, then packet and slot
    np.testing.assert_array_equal(slot, live[order])
    np.testing.assert_array_equal(src, want_src[order])
    assert rowptr[0] == 0 and rowptr[-1] == len(slot) and len(rowptr) == p.num_nodes + 1
    np.testing.assert_array_equal(np.diff(rowptr),
                                  np.bincount(row, minlength=p.num_nodes))
    np.testing.assert_array_equal(np.repeat(np.arange(p.num_nodes), np.diff(rowptr)),
                                  row[order])


@pytest.mark.parametrize("chunk", [16, 100, 1 << 20])
def test_schedule_is_row_csrs_on_live_slots(chunk, monkeypatch):
    """B7's schedule is ``csr.row_csrs`` run on the live slots alone, each
    with its global receiver row and x row: every field equal, ``eid``
    mapped from the live slots' positions to their slots."""
    monkeypatch.setattr(row_csr, "CHUNK_EDGES", chunk)
    p, _, _, _, _ = _hub_packets(seed=1)
    row, src, live = (torch.from_numpy(v) for v in _live_slots(p))
    sc = packets_kernels.packet_schedule(p)
    (want,) = row_csr.row_csrs([(row, lambda i: src[i])], p.num_nodes)
    assert sc.num_parts == want.num_parts
    for name in ("rowptr", "col", "items", "splits"):
        assert torch.equal(getattr(sc, name), getattr(want, name)), name
    assert torch.equal(sc.eid.long(), live[want.eid.long()])


def test_schedule_empty_receiver_block(monkeypatch):
    """A receiver block of dead packets only, and one with no packets,
    gives one empty item a row, whose rows come out as zeros."""
    p, _, _, _, _ = _hub_packets(seed=2)
    dead = p.num_row_blocks - 1
    assert not np.any(p.w[p.row_ptr[dead]:p.row_ptr[dead + 1]])
    x = torch.from_numpy(_x(p.num_nodes, 16, 0))
    monkeypatch.setattr(row_csr, "CHUNK_EDGES", 16)
    pt = p.to("cpu")
    y = spmm_csr_plain(packets_kernels.packet_schedule(pt), pt.w, x)
    assert not bool(y[dead * p.block_r:].any())
    # drop the dead block's packets: a block of zero packets
    lo = int(p.row_ptr[dead])
    bare = packets.EdgePackets(
        rows=p.rows[:lo], cols=p.cols[:lo], w=p.w[:lo], row_of=p.row_of[:lo],
        col_blk=p.col_blk[:lo], row_ptr=np.minimum(p.row_ptr, lo),
        num_nodes=p.num_nodes, block_r=p.block_r, block_c=p.block_c)
    for q in (p, bare):
        sc = packets_kernels.packet_schedule(q)
        items = sc.items.numpy()
        mine = items[items[:, 0] >= dead * p.block_r]
        assert len(mine) == p.block_r and np.all(mine[:, 1] == mine[:, 2])
        assert np.all(mine[:, 1] == sc.eid.shape[0]) and np.all(mine[:, 3] == -1)
    bt = bare.to("cpu")
    y2 = spmm_csr_plain(packets_kernels.packet_schedule(bt), bt.w, x)
    np.testing.assert_array_equal(y2.numpy(), y.numpy())


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_schedule_plain_matches_plain_and_pallas(compute_dtype, out_dtype,
                                                 monkeypatch):
    """The plain version that walks B7's row schedule (f32 chunk partials
    summed in chunk order, one rounding at the end) equals the one-pass
    plain version and JAX's kernel in interpret mode on the hub graph:
    f32 sums in another order (1e-5 of each row's largest |value| times
    sqrt of the row's edge count), plus one bf16 ulp of the value for a
    bf16 output."""
    p, p_j, s, r, w = _hub_packets(seed=3)
    x = _x(p.num_nodes, 24, 5)
    pt, xt = p.to("cpu"), torch.from_numpy(x)
    monkeypatch.setattr(row_csr, "CHUNK_EDGES", 16)
    sc = packets_kernels.packet_schedule(pt)
    y = spmm_csr_plain(sc, pt.w, xt, compute_dtype, out_dtype)
    assert y.dtype == out_dtype and y.shape == (p.num_nodes, 24)
    assert len(sc.splits) > 1
    ref_plain = packets_kernels.spmm_packets_plain(pt, xt, None, compute_dtype)
    ref_jax = np.asarray(jax_pk.spmm_packets(
        p_j, jnp.asarray(np.pad(x, ((0, 0), (0, 104)))), interpret=True,
        compute_dtype=JAX_CD[compute_dtype]))[:, :24]
    k = np.bincount(r[w != 0], minlength=p.num_nodes).max()
    for ref in (ref_plain.numpy(), ref_jax):
        row = np.abs(ref).max(1, keepdims=True)
        tol = TOL * np.sqrt(k) * row + 1e-30
        if out_dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * np.abs(ref)
        assert np.all(np.abs(y.float().numpy() - ref) <= tol)


def test_wrapper_rejects_bad_inputs():
    s, r, w = _coo(64, 100, seed=6)
    p = packets.pack_edges(s, r, w, 64, 32, 32, 8).to("cpu")
    with pytest.raises(ValueError):
        packets_kernels.spmm_packets(p, torch.ones(63, 4))
    with pytest.raises(ValueError, match="compute_dtype"):
        packets_kernels.spmm_packets(p, torch.ones(64, 4),
                                     compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="no spmm_packets kernel"):
        packets_kernels.spmm_packets(p.to("meta"), torch.ones(64, 4, device="meta"))
    with pytest.raises(ValueError, match="CUDA device only"):
        packets_kernels._spmm_packets_ablation(p, torch.ones(64, 4), "full")
    with pytest.raises(ValueError, match="mode"):
        packets_kernels._spmm_packets_ablation(p, torch.ones(64, 4), "nodma")


ARGS = dict(n_live=2_100_000, t_probe=21_000, density=0.0015,
            low_locality=True, on_tpu=False)


def _port(args):
    """tpugraph's arguments of resolve_bcsr_format as the port names them
    (``on_card`` for ``on_tpu``)."""
    return {("on_card" if k == "on_tpu" else k): v for k, v in args.items()}


@pytest.mark.parametrize("fields,att", [
    (dict(), False),                                   # auto, not a TPU
    (dict(bcsr_format="packets"), False),              # explicit wins
    (dict(bcsr_format="tiles"), False),
    (dict(bcsr_format="packets"), True),               # att forces tiles
    (dict(bcsr_format="packets", bcsr_resident="on"), False),  # resident on
    (dict(bcsr_resident="on"), False),
    (dict(bcsr_resident="off", bcsr_format="packets"), False),
])
def test_resolve_bcsr_format_precedence(fields, att):
    kw = dict(num_epochs=100, use_bcsr=True, bcsr_block=256, **fields)
    want = jax_loop.resolve_bcsr_format(jax_loop.TrainConfig(**kw), **ARGS,
                                        att=att)
    assert resolve_bcsr_format(TrainConfig(**kw), **_port(ARGS), att=att) == want
    for dense in (dict(density=0.04), dict(low_locality=False)):
        args = dict(ARGS, **dense)
        assert resolve_bcsr_format(TrainConfig(**kw), **_port(args), att=att) == \
            jax_loop.resolve_bcsr_format(jax_loop.TrainConfig(**kw), **args,
                                         att=att)


def test_resolve_bcsr_format_auto_on_tpu_is_not_ported():
    """The TPU cost model's rates are not the card's: on the card the port
    weighs the formats at its own rates (where tpugraph and the port
    disagree, the port follows them), and a dense graph stays tiles."""
    from tpugraph_torch.train.loop import _RATE_DEFAULTS

    assert _RATE_DEFAULTS != jax_loop._RATE_DEFAULTS
    assert set(_RATE_DEFAULTS) == set(jax_loop._RATE_DEFAULTS)
    cfg = TrainConfig(num_epochs=100_000, bcsr_block=256)
    # 100,000 epochs: tpugraph's v5e rates pick tiles, the card's packets
    assert jax_loop.resolve_bcsr_format(
        jax_loop.TrainConfig(num_epochs=100_000, bcsr_block=256),
        **dict(ARGS, on_tpu=True)) == "tiles"
    assert resolve_bcsr_format(cfg, **_port(dict(ARGS, on_tpu=True))) == "packets"
    assert resolve_bcsr_format(cfg, **_port(dict(ARGS, on_tpu=True,
                                                 density=0.04))) == "tiles"
