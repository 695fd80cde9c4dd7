"""The COO adjacency product over a CSR of the edge list, and its autograd
wrapper: the training path's ``A @ x`` on a :class:`SparseAdj` that carries
an :class:`EdgeCSR`.

The JAX package computes this product with XLA's gather and
``segment_sum`` (``tpugraph/ops/message.py:22``), outside any Pallas
kernel, so this kernel replaces none: it replaces the port's plain
``index_select``, multiply and atomic ``index_add_``
(:func:`tpugraph_torch.ops.message.spmm`), which wrote an E x D message
tensor and summed it with atomics.

* :func:`edge_csr` — the CSR of A (edges stable-sorted by receiver) and of
  A^T (by sender) with each row's work list, built once with torch on the
  edges' own device (device sorts and scans on the card, one host sync
  for the work lists' sizes).
* :func:`spmm_csr` — ``y = A @ x`` on one direction: the kernel of
  ``tpugraph_torch/csrc/coo_kernels.cu`` on a CUDA tensor; it raises on
  any other, where :func:`message.spmm` is the product.
* :class:`CsrMatvec` — ``A @ x`` with ``dx = A^T g`` through the same
  kernel, and, where the weights need a gradient (attention on COO),
  ``dw_e = <g[r_e], x[s_e]>`` by :func:`message.sddmm`.

The kernel walks a work list: each row's edges cut into chunks of at most
``CHUNK_EDGES``, longest first.  A row that is one chunk is written
directly; the chunks of a split row write f32 partials, which a second
pass (``spmm_coo_csr_reduce``) adds in chunk order.  Within a chunk the
kernel multiplies and adds in CSR order with IEEE f32 rounding, so a row
that is one chunk has the bits of :func:`message.spmm` on the CPU (which
sums each row in edge order); a split row differs by the reassociation of
its chunk sums.  No atomics: every launch gives the same bits.

The kernel runs at about the speed of ``torch.sparse.mm`` on a CSR tensor
of the same edges; it is hand-written for what the library call does not
give: the same bits on every launch, the CPU's bits on unsplit rows, and a
product independent of the cuSPARSE one that the benchmark's reference
job computes.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict

import torch

from tpugraph_torch.ops._build import check_tensor, library, raise_on, stream
from tpugraph_torch.ops.message import sddmm

# Edges a chunk of the work list holds at most.  On the arxiv stand-in
# (169,343 nodes, 2.33M edges, Chung-Lu at gamma 2.5) node 0 has about
# 3,000 edges; chunks of 256 split a few hundred rows, whose f32 partials
# (a few MB at D = 256) are under 1% of the gather's E x D x 4 bytes.
CHUNK_EDGES = 256

LAUNCHES: Dict[str, int] = {"spmm_coo_csr": 0, "spmm_coo_csr_reduce": 0}
_bound = False


@dataclasses.dataclass
class CSR:
    """One direction of :class:`EdgeCSR`: the edges stable-sorted by row.

    rowptr int32[N + 1]   — row ``i``'s edges are ``rowptr[i]..rowptr[i+1]``
    col    int32[E]       — each sorted edge's column (x row it gathers)
    eid    int32[E]       — its index in the original edge list
    items  int32[n, 4]    — (row, first edge, end edge, partial slot or -1
                             for a row that is one chunk), longest first;
                             every row has at least one
    splits int32[s, 4]    — (row, first partial slot, chunks, 0) of each
                             split row
    """

    rowptr: torch.Tensor
    col: torch.Tensor
    eid: torch.Tensor
    items: torch.Tensor
    splits: torch.Tensor
    num_parts: int  # f32 partials a call writes (chunks of split rows)

    @property
    def num_nodes(self) -> int:
        return self.rowptr.shape[0] - 1

    def to(self, device) -> "CSR":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "num_parts"})


@dataclasses.dataclass
class EdgeCSR:
    """The CSR of ``A`` (rows are receivers, ``A[r, s] = w``) and of
    ``A^T`` (rows are senders) of one padded COO edge list."""

    a: CSR
    a_t: CSR

    def to(self, device) -> "EdgeCSR":
        return EdgeCSR(self.a.to(device), self.a_t.to(device))


def _chunk_counts(rowptr: torch.Tensor) -> torch.Tensor:
    """Chunks of at most ``CHUNK_EDGES`` edges of each row; an empty row
    is one empty chunk, so it is written as zeros."""
    counts = (rowptr[1:] - rowptr[:-1]).long()
    return torch.clamp((counts + CHUNK_EDGES - 1) // CHUNK_EDGES, min=1)


def _work_list(rowptr: torch.Tensor, n_chunks: torch.Tensor, total: int,
               num_split: int):
    """(items, splits) of :class:`CSR` on ``rowptr``'s device, from each
    row's chunk count and the two sizes it gives: every row's edges cut
    into chunks in order, the longest chunks first (a stable sort), and a
    split row's chunks given consecutive partial slots.  Scans, sorts and
    ``gather`` only, and no host sync."""
    dev = rowptr.device
    rowptr = rowptr.long()
    row = torch.repeat_interleave(n_chunks, output_size=total)
    first_chunk = torch.cumsum(n_chunks, 0) - n_chunks
    k = torch.arange(total, device=dev) - torch.gather(first_chunk, 0, row)
    lo = torch.gather(rowptr[:-1], 0, row) + k * CHUNK_EDGES
    hi = torch.minimum(lo + CHUNK_EDGES, torch.gather(rowptr[1:], 0, row))
    split = n_chunks > 1
    parts = torch.where(split, n_chunks, 0)
    first_part = torch.cumsum(parts, 0) - parts
    part = torch.where(torch.gather(split, 0, row),
                       torch.gather(first_part, 0, row) + k, -1)
    order = torch.sort(lo - hi, stable=True).indices
    # 1-D gathers, column by column: along an expanded index, gather runs
    # vectorized_gather_kernel, the replaced gather path's kernel, which
    # would blur a profile read by kernel name
    items = torch.stack([torch.gather(v, 0, order) for v in (row, lo, hi, part)], 1)
    # the split rows in order: the head of a stable sort that puts them
    # first (nonzero would wait for the device)
    sb = torch.sort((~split).to(torch.int32), stable=True).indices[:num_split]
    splits = torch.stack([sb, torch.gather(first_part, 0, sb),
                          torch.gather(n_chunks, 0, sb), torch.zeros_like(sb)], 1)
    return items.int(), splits.int()


def _sorted(rows: torch.Tensor, cols: torch.Tensor, num_nodes: int):
    """(rowptr, col, eid) of the edges stable-sorted by ``rows``."""
    sorted_rows, order = torch.sort(rows.long(), stable=True)
    rowptr = torch.searchsorted(
        sorted_rows, torch.arange(num_nodes + 1, device=rows.device)).int()
    return rowptr, torch.gather(cols.int(), 0, order), order.int()


def edge_csr(senders: torch.Tensor, receivers: torch.Tensor,
             num_nodes: int) -> EdgeCSR:
    """The :class:`EdgeCSR` of edges ``senders[e] -> receivers[e]`` over
    ``num_nodes`` nodes (int32 or int64 indices, padding edges included),
    with torch on the edges' device, in chunks of ``CHUNK_EDGES``.  Within
    a row the edges keep their order in the edge list.  One host sync
    fetches the work lists' sizes and, with them, the check that every
    index lies in ``[0, num_nodes)``: each direction's rows span all the
    edges."""
    if senders.shape != receivers.shape or senders.dim() != 1:
        raise ValueError("senders and receivers must be 1-D and of one length")
    e = senders.shape[0]
    if e >= 2 ** 31 or num_nodes >= 2 ** 31:
        raise ValueError("the CSR holds int32 indices")
    sides = [_sorted(receivers, senders, num_nodes),
             _sorted(senders, receivers, num_nodes)]
    chunks = [_chunk_counts(rowptr) for rowptr, _, _ in sides]
    sizes = torch.stack(
        [v for (rowptr, _, _), n in zip(sides, chunks)
         for v in (n.sum(), (n > 1).sum(), torch.where(n > 1, n, 0).sum(),
                   rowptr[0].long(), rowptr[-1].long())]).tolist()
    csrs = []
    for (rowptr, col, eid), n, (total, num_split, num_parts, lo, hi) in zip(
            sides, chunks, (sizes[:5], sizes[5:])):
        if lo != 0 or hi != e:
            raise ValueError(f"edge indices must lie in [0, {num_nodes})")
        items, splits = _work_list(rowptr, n, total, num_split)
        csrs.append(CSR(rowptr, col, eid, items, splits, num_parts))
    return EdgeCSR(*csrs)


def _lib():
    global _bound
    lib = library("coo_kernels")
    if not _bound:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.spmm_coo_csr.argtypes = [vp] * 4 + [ci] + [vp] * 3 + [ci, ci, vp]
        lib.spmm_coo_csr.restype = ci
        lib.spmm_coo_csr_reduce.argtypes = [vp, ci, vp, vp, ci, ci, vp]
        lib.spmm_coo_csr_reduce.restype = ci
        _bound = True
    return lib


def _launch(c: CSR, weight: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Run the main pass and, where rows are split, the reduce pass."""
    dev = x.device
    e = c.col.shape[0]
    check_tensor("col", c.col, torch.int32, 1, dev)
    check_tensor("eid", c.eid, torch.int32, 1, dev)
    check_tensor("items", c.items, torch.int32, 2, dev)
    check_tensor("splits", c.splits, torch.int32, 2, dev)
    check_tensor("weight", weight, torch.float32, 1, dev)
    check_tensor("x", x, torch.float32, 2, dev)
    if c.eid.shape[0] != e or weight.shape[0] != e:
        raise ValueError(f"col, eid and weight must hold the {e} edges")
    n, d = c.num_nodes, x.shape[1]
    y = torch.empty((n, d), dtype=torch.float32, device=dev)
    if n == 0 or d == 0:
        return y
    lib = _lib()
    vec = int(d % 4 == 0 and x.data_ptr() % 16 == 0)
    partial = torch.empty((c.num_parts, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.spmm_coo_csr(c.col.data_ptr(), c.eid.data_ptr(),
                               weight.data_ptr(), c.items.data_ptr(),
                               c.items.shape[0], x.data_ptr(), y.data_ptr(),
                               partial.data_ptr(), d, vec, stream(dev))
        raise_on(err, "spmm_coo_csr")
        LAUNCHES["spmm_coo_csr"] += 1
        if c.splits.shape[0]:
            err = lib.spmm_coo_csr_reduce(c.splits.data_ptr(), c.splits.shape[0],
                                          partial.data_ptr(), y.data_ptr(), d,
                                          vec, stream(dev))
            raise_on(err, "spmm_coo_csr_reduce")
            LAUNCHES["spmm_coo_csr_reduce"] += 1
    return y


def spmm_csr(c: CSR, weight: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y[N, D] = A @ x`` with ``A`` the CSR ``c`` scaled by the
    edge-order ``weight [E]`` and ``x [N, D]`` float32, by the kernel: CUDA
    tensors only (:func:`message.spmm` is the product elsewhere)."""
    if x.dim() != 2 or x.shape[0] != c.num_nodes:
        raise ValueError(f"x must be [{c.num_nodes}, D], got {tuple(x.shape)}")
    if c.col.device != x.device:
        raise ValueError(f"the CSR is on {c.col.device}, x on {x.device}")
    if x.device.type != "cuda":
        raise ValueError(f"the CSR kernel runs on CUDA, not {x.device}: "
                         "message.spmm is the product there")
    return _launch(c, weight, x)


class CsrMatvec(torch.autograd.Function):
    """``A @ x`` on a COO edge list through its :class:`EdgeCSR`: forward
    :func:`spmm_csr` on ``A``, ``dx`` by :func:`spmm_csr` on ``A^T``, and
    ``dw`` by :func:`message.sddmm` (the gather path) where ``weight``
    needs a gradient."""

    @staticmethod
    def forward(ctx, x, weight, csr, senders, receivers):
        ctx.csr = csr
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, weight,
                              senders, receivers)
        return spmm_csr(csr.a, weight.contiguous(), x.contiguous())

    @staticmethod
    def backward(ctx, g):
        x, weight, senders, receivers = ctx.saved_tensors
        g = g.contiguous()
        dx = (spmm_csr(ctx.csr.a_t, weight.contiguous(), g)
              if ctx.needs_input_grad[0] else None)
        dw = sddmm(senders, receivers, x, g) if ctx.needs_input_grad[1] else None
        return dx, dw, None, None, None


def csr_matvec(csr: EdgeCSR, senders: torch.Tensor, receivers: torch.Tensor,
               weight: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Differentiable ``A @ x`` (gradients to ``x`` and ``weight``) for the
    edge list whose :class:`EdgeCSR` is ``csr``."""
    return CsrMatvec.apply(x, weight, csr, senders, receivers)
