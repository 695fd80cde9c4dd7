"""The COO product over the edge list's CSR (``ops/coo_kernels.py``) on the
CPU: the CSR walked by the kernel's plain twin (``ops/csr.py``) against
the gather and ``index_add_`` of ``ops/message.py``, the autograd
wrapper's gradients (around that twin in the kernel's place), the work
list the card's kernels walk (of the edge list's CSR and of B7's packet
schedule, which share it), and COO training with and without the CSR.
The kernels themselves run on the card only (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from tpugraph_torch.core.graph import graph_from_edges
from tpugraph_torch.nn import GcnEncoderNode, SparseAdj
from tpugraph_torch.ops import coo_kernels as ck
from tpugraph_torch.ops import csr as row_csr
from tpugraph_torch.ops import message, packets, packets_kernels
from tpugraph_torch.ops.csr import spmm_csr_plain
from tpugraph_torch.train import TrainConfig, train_node_classifier
from tpugraph_torch.train import loop


def _graph(case, seed=0):
    """(senders, receivers, weight, x, num_nodes) of one case: random edges
    over 300 nodes, D = 12, with the case's feature on top."""
    rng = np.random.default_rng(seed)
    n, e, d = 300, 4000, 12
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    w = rng.standard_normal(e).astype(np.float32)
    if case == "padding":      # weight-0 edges from node 0 to node 0, at the end
        s[-50:], r[-50:], w[-50:] = 0, 0, 0.0
    elif case == "empty_rows":  # the last 40 nodes receive and send nothing
        s, r = s % (n - 40), r % (n - 40)
    elif case == "repeats":     # each edge twice, the second copy elsewhere in the list
        s, r, w = np.concatenate([s, s[::-1]]), np.concatenate([r, r[::-1]]), \
            np.concatenate([w, w[::-1]])
    elif case == "hub":         # node 3 receives and sends 1,500 edges: split rows
        s[:1500], r[1500:3000] = 7, 3
        r[:1500] = 3
    elif case == "wide":        # num_nodes past the largest index
        s, r, n = s % 200, r % 200, n + 57
    x = rng.standard_normal((n, d)).astype(np.float32)
    return s, r, w, x, n


CASES = ["plain", "padding", "empty_rows", "repeats", "hub", "wide"]


@pytest.fixture
def plain_kernel(monkeypatch):
    """``spmm_csr_plain`` in the kernel's place, over CSRs whose rows are
    each one chunk, so it has ``message.spmm``'s bits; counts its calls."""
    calls = []

    def spmm_csr(c, weight, x):
        calls.append(c)
        return spmm_csr_plain(c, weight, x)

    monkeypatch.setattr(row_csr, "CHUNK_EDGES", 1 << 20)
    monkeypatch.setattr(ck, "spmm_csr", spmm_csr)
    return calls


def _tensors(case, dtype, seed=0):
    s, r, w, x, n = _graph(case, seed)
    return (torch.from_numpy(s).to(dtype), torch.from_numpy(r).to(dtype),
            torch.from_numpy(w), torch.from_numpy(x), n)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", CASES)
def test_spmm_csr_plain_is_message_spmm_bit_for_bit(case, dtype, monkeypatch):
    """A @ x and A^T @ x walked over the CSR equal the gather and
    index_add_ over the edge list exactly where a row is one chunk: each
    row keeps its edges in edge order, so an unsplit row's sum is the
    CPU's.  In chunks of 64 (the hub case splits rows) the unsplit rows
    keep those bits and a split row lies within f32 reordering."""
    s, r, w, x, n = _tensors(case, dtype)
    for chunk in (1 << 20, 64):
        monkeypatch.setattr(row_csr, "CHUNK_EDGES", chunk)
        csr = ck.edge_csr(s, r, n)
        for c, snd, rcv in ((csr.a, s, r), (csr.a_t, r, s)):
            y, ref = spmm_csr_plain(c, w, x), message.spmm(snd, rcv, w, x)
            split = torch.zeros(n, dtype=torch.bool)
            split[c.splits[:, 0].long()] = True
            assert chunk == 64 or not bool(split.any())
            assert torch.equal(y[~split], ref[~split])
            k = (c.rowptr[1:] - c.rowptr[:-1]).float()[:, None]
            tol = 1e-5 * k.sqrt() * message.spmm(snd, rcv, w.abs(), x.abs())
            assert bool(((y - ref).abs() <= tol)[split].all())


@pytest.mark.parametrize("weight_grad", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_csr_matvec_gradients_are_message_spmm_autograd(case, weight_grad,
                                                       plain_kernel):
    """y (the product on A), dx (on A^T) and, where the weights need one,
    dw (the gather path's sddmm) equal the autograd of message.spmm
    exactly."""
    s, r, w, x, n = _tensors(case, torch.int64)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (n, x.shape[1])).astype(np.float32))
    csr = ck.edge_csr(s, r, n)
    grads = []
    for fn in (lambda wa, xa: message.spmm(s, r, wa, xa),
               lambda wa, xa: ck.csr_matvec(csr, s, r, wa, xa)):
        xa = x.clone().requires_grad_()
        wa = w.clone().requires_grad_(weight_grad)
        y = fn(wa, xa)
        (y * g).sum().backward()
        grads.append((y.detach(), xa.grad, wa.grad))
    (y0, dx0, dw0), (y1, dx1, dw1) = grads
    assert plain_kernel == [csr.a, csr.a_t]
    assert torch.equal(y0, y1) and torch.equal(dx0, dx1)
    if weight_grad:
        assert torch.equal(dw0, dw1)
    else:
        assert dw0 is None and dw1 is None


def test_csr_matvec_without_x_gradient_skips_the_transpose(plain_kernel):
    """The first layer's x needs no gradient: no product on A^T, and the
    weights' gradient alone still equals message.spmm's."""
    s, r, w, x, n = _tensors("hub", torch.int64)
    csr = ck.edge_csr(s, r, n)
    wa, wb = w.clone().requires_grad_(), w.clone().requires_grad_()
    message.spmm(s, r, wa, x).square().sum().backward()
    ck.csr_matvec(csr, s, r, wb, x).square().sum().backward()
    assert plain_kernel == [csr.a]
    assert torch.equal(wa.grad, wb.grad)


def _hub_packets(seed=1, br=32, bc=32, k=8, n=256, e=3000):
    """B7's source: a hub-heavy graph packed into edge packets, over half
    its edges in receiver block 0 and the upper half's receiver blocks
    without an edge; returns the packets and, for each slot, its global
    receiver row and x row, and the live slots."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e).astype(np.int32)
    r = np.where(rng.random(e) < 0.6, rng.integers(0, br, e),
                 rng.integers(0, n // 2, e)).astype(np.int32)
    w = rng.standard_normal(e).astype(np.float32)
    p = packets.pack_edges(s, r, w, n, block_r=br, block_c=bc, k=k).to("cpu")
    rows = (p.row_of.long()[:, None] * br + p.rows.long()).reshape(-1)
    cols = (p.col_blk.long()[:, None] * bc + p.cols.long()).reshape(-1)
    return p, rows, cols, torch.nonzero(p.w.reshape(-1) != 0)[:, 0]


def _work_list_sources(case):
    """(CSR, row and column of every entry, the entries it must list, rows)
    of each CSR the case builds: A and A^T of an edge list, or B7's packet
    schedule (only the live slots)."""
    if case == "packets":
        p, rows, cols, live = _hub_packets()
        return [(packets_kernels.packet_schedule(p), rows, cols, live, p.num_nodes)]
    s, r, _, _, n = _tensors(case, torch.int64)
    csr = ck.edge_csr(s, r, n)
    every = torch.arange(len(s))
    return [(csr.a, r, s, every, n), (csr.a_t, s, r, every, n)]


@pytest.mark.parametrize("case,chunk", [(case, chunk) for case in CASES
                                        for chunk in (1, 5, 64, 256)]
                         + [("packets", chunk) for chunk in (16, 100, 1 << 20)],
                         ids=lambda v: str(v))
def test_work_list_covers_every_edge_once(case, chunk, monkeypatch):
    """Each row's chunks tile its CSR range in order, as few as ``chunk``
    edges each allows, longest first; an empty row is one empty chunk
    written directly; exactly the rows over ``chunk`` are split, and a
    split row's chunks own consecutive partial slots, which ``splits``
    lists in row order; the CSR lists each entry it must once, keeping
    each row's entries in their order (edge order, or B7's packet and slot
    order)."""
    monkeypatch.setattr(row_csr, "CHUNK_EDGES", chunk)
    for c, rows, cols, live, n in _work_list_sources(case):
        rowptr, items = c.rowptr.long(), c.items.long()
        assert rowptr[0] == 0 and rowptr[-1] == len(live) == c.col.shape[0]
        eid = c.eid.long()
        assert torch.equal(torch.sort(eid).values, live)
        assert torch.equal(c.col.long(), cols[eid])
        sorted_rows = rows[eid]
        assert torch.all(sorted_rows[1:] >= sorted_rows[:-1])
        same = sorted_rows[1:] == sorted_rows[:-1]
        assert torch.all(eid[1:][same] > eid[:-1][same])  # stable
        length = items[:, 2] - items[:, 1]
        assert torch.all(length <= chunk) and torch.all(length[1:] <= length[:-1])
        by_row = {}
        for row, lo, hi, part in items.tolist():
            by_row.setdefault(row, []).append((lo, hi, part))
        assert sorted(by_row) == list(range(n))
        splits = {row: (first, k) for row, first, k, _ in c.splits.tolist()}
        counts = (rowptr[1:] - rowptr[:-1]).tolist()
        assert list(splits) == [i for i in range(n) if counts[i] > chunk]
        for row, chunks in by_row.items():
            chunks.sort()
            lo, hi = int(rowptr[row]), int(rowptr[row + 1])
            assert chunks[0][0] == lo and chunks[-1][1] == hi
            assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
            assert len(chunks) == max(1, -(-counts[row] // chunk))
            if len(chunks) == 1:
                assert chunks[0][2] == -1 and row not in splits
            else:
                first, k = splits[row]
                assert k == len(chunks)
                assert [p for _, _, p in chunks] == list(range(first, first + k))
        assert c.num_parts == sum(k for _, k in splits.values()) \
            == int((items[:, 3] >= 0).sum())


def test_edge_csr_checks_its_edges():
    """Indices past either end of [0, num_nodes), in either direction,
    raise; the product runs on CUDA only; no edges, every row one empty
    chunk."""
    s = torch.tensor([0, 1, 2])
    for bad in ([0, 1, 3], [0, -1, 2]):
        for pair in ((s, torch.tensor(bad)), (torch.tensor(bad), s)):
            with pytest.raises(ValueError, match="must lie in"):
                ck.edge_csr(*pair, 3)
    with pytest.raises(ValueError, match="one length"):
        ck.edge_csr(s, torch.tensor([0, 1]), 3)
    csr = ck.edge_csr(s, s, 3)
    with pytest.raises(ValueError, match="x must be"):
        ck.spmm_csr(csr.a, torch.ones(3), torch.ones(4, 2))
    with pytest.raises(ValueError, match="runs on CUDA"):
        ck.spmm_csr(csr.a, torch.ones(3), torch.ones(3, 2))
    empty = ck.edge_csr(torch.zeros(0, dtype=torch.int64),
                        torch.zeros(0, dtype=torch.int64), 5)
    assert empty.a.items.tolist() == [[i, 0, 0, -1] for i in range(5)]
    assert empty.a.splits.shape == (0, 4) and empty.a.num_parts == 0
    assert torch.equal(spmm_csr_plain(empty.a, torch.ones(0), torch.ones(5, 2)),
                       torch.zeros(5, 2))


def _task(seed=0, n=120, e=900, d=6):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    g = graph_from_edges(s, r, n)
    feat = rng.standard_normal((g.num_nodes_padded, d)).astype(np.float32)
    labels = rng.integers(0, 3, n)
    return g, feat, labels


def test_build_adjacency_gives_coo_its_csr_on_the_card_only():
    """On the CPU the COO adjacency carries no CSR: the gather path runs
    there (the card's CSR: ``tests/test_torch_cuda.py``)."""
    g, _, _ = _task()
    adj, n = loop.build_adjacency(g, TrainConfig(), torch.device("cpu"))
    assert isinstance(adj, SparseAdj) and n == g.num_nodes_padded
    assert adj.csr is None


@pytest.mark.parametrize("att", [False, True])
def test_coo_training_is_the_same_with_and_without_csr(monkeypatch, plain_kernel,
                                                       att):
    """20 COO epochs from one init: through CsrMatvec (the plain walk of
    the CSR in the kernel's place) and through the gather path, the same
    losses, accuracies and predictions, bit for bit (with attention the
    weights carry a gradient through the CSR product)."""
    g, feat, labels = _task()
    dims = dict(input_dim=6, hidden_dim=8, embedding_dim=8, label_dim=3,
                num_layers=3, att=att)
    init = GcnEncoderNode(**dims, generator=torch.Generator().manual_seed(0),
                          device="cpu").state_dict()
    build = loop.build_adjacency

    def with_csr_built(g, cfg, device, *args, **kwargs):
        adj, n = build(g, cfg, device, *args, **kwargs)
        return adj._replace(csr=ck.edge_csr(adj.senders, adj.receivers, n)), n

    outs = []
    for with_csr in (True, False):
        monkeypatch.setattr(loop, "build_adjacency",
                            with_csr_built if with_csr else build)
        out = train_node_classifier(GcnEncoderNode(**dims, device="cpu"), g, feat,
                                    labels, TrainConfig(num_epochs=20),
                                    init_params=init, device="cpu")
        assert (out["adj"].csr is not None) == with_csr
        outs.append(out)
    a, b = outs
    assert len(plain_kernel) == 20 * 5 + 3  # 3 layers forward, 2 backward; eval
    assert a["history"] == b["history"]
    assert np.array_equal(a["ypred"], b["ypred"])
    assert a["history"]["loss"][-1] < a["history"]["loss"][0]
