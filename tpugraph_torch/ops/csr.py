"""The row-sorted edge list that the port's row-walk SpMM walks, its work
list, the plain version that walks it as the kernel does, and the
launcher of the kernel's two passes.  The port owns this module: it has
no counterpart in ``tpugraph``, whose COO product is XLA's gather and
``segment_sum`` and whose B7 is a Pallas kernel over the packets.

Two products walk a :class:`CSR`, each through its own library's
wrappers over ``tpugraph_torch/csrc/row_spmm.cuh``:

* the COO product (``ops/coo_kernels.py``): the edge list sorted by
  receiver (``A``) and by sender (``A^T``), ``eid`` each edge's index in
  the list, and GAT's attention over the same work lists;
* B7 (``ops/packets_kernels.py``): the live slots of one
  :class:`EdgePackets` sorted by global receiver row, ``eid`` the slot.

The kernel walks a work list: each row's edges cut into chunks of at most
:data:`CHUNK_EDGES`, longest first.  A row that is one chunk is written
directly; the chunks of a split row write f32 partial rows, which a second
pass adds in chunk order and rounds once.  Within a chunk the kernel adds
in row order from +0.0, with IEEE f32 rounding, so a row that is one chunk
has the bits of the gather and ``index_add_`` on the CPU; a split row
differs by the reassociation of its chunk sums.  No atomics: every launch
gives the same bits.  :func:`spmm_csr_plain` repeats that walk in plain
PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from tpugraph_torch.ops._build import check_tensor, raise_on, stream

# Edges a chunk of the work list holds at most.  On the arxiv stand-in
# (169,343 nodes, 2.33M edges, Chung-Lu at gamma 2.5) node 0 has about
# 3,000 edges; chunks of 256 split a few hundred rows, whose f32 partials
# (a few MB at D = 256) are under 1% of the gather's E x D x 4 bytes.
CHUNK_EDGES = 256


@dataclasses.dataclass
class CSR:
    """Edges stable-sorted by row, with each row's work list.

    rowptr int32[N + 1]   — row ``i``'s edges are ``rowptr[i]..rowptr[i+1]``
    col    int32[E]       — each sorted edge's column (the x row it gathers)
    eid    int32[E]       — the entry whose weight ``weight[eid]`` it reads
                             (its index in the edge list, or B7's slot)
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
    num_parts: int  # f32 partial rows a call writes (chunks of split rows)

    @property
    def num_nodes(self) -> int:
        return self.rowptr.shape[0] - 1

    def to(self, device) -> "CSR":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "num_parts"})


def _chunk_counts(rowptr: torch.Tensor) -> torch.Tensor:
    """Chunks of at most ``CHUNK_EDGES`` edges of each row; an empty row
    is one empty chunk, so it is written as zeros."""
    counts = rowptr[1:] - rowptr[:-1]
    return torch.clamp((counts + CHUNK_EDGES - 1) // CHUNK_EDGES, min=1)


def _work_list(rowptr: torch.Tensor, n_chunks: torch.Tensor, total: int,
               num_split: int):
    """(items, splits) of :class:`CSR` on ``rowptr``'s device (int64), from
    each row's chunk count and the two sizes it gives: every row's edges
    cut into chunks in order, the longest chunks first (a stable sort), and
    a split row's chunks given consecutive partial slots.  Scans, sorts and
    ``gather`` only, and no host sync."""
    dev = rowptr.device
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


def row_csrs(sides: Sequence[Tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]],
             num_nodes: int) -> List[CSR]:
    """One :class:`CSR` for each ``(rows, col_of)`` of ``sides``: the
    entries ``i`` with ``rows[i]`` in ``[0, num_nodes)``, stable-sorted by
    row (``rows[i] == num_nodes`` leaves entry ``i`` out, sorted past the
    end), ``eid`` their indices and ``col = col_of(eid)`` (int64 indices
    in), with each row's work list in chunks of ``CHUNK_EDGES``.  Torch on
    the rows' device: sorts, scans and 1-D gathers, and one host sync for
    every side's sizes.  Raises on a row below 0."""
    if num_nodes >= 2 ** 31 or any(rows.shape[0] >= 2 ** 31 for rows, _ in sides):
        raise ValueError("the CSR holds int32 indices")
    sorted_sides = []
    for rows, _ in sides:
        key, order = torch.sort(rows.long(), stable=True)
        rowptr = torch.searchsorted(key, torch.arange(num_nodes + 1, device=rows.device))
        sorted_sides.append((rowptr, order, _chunk_counts(rowptr)))
    sizes = torch.stack(
        [v for rowptr, _, n in sorted_sides
         for v in (n.sum(), (n > 1).sum(), torch.where(n > 1, n, 0).sum(), rowptr[0],
                   rowptr[-1])]).tolist()
    csrs = []
    for i, ((rowptr, order, n), (_, col_of)) in enumerate(zip(sorted_sides, sides)):
        total, num_split, num_parts, lo, e = sizes[5 * i:5 * i + 5]
        if lo != 0:
            raise ValueError(f"row indices must lie in [0, {num_nodes}]")
        eid = order[:e]
        items, splits = _work_list(rowptr, n, total, num_split)
        csrs.append(CSR(rowptr.int(), col_of(eid).int(), eid.int(), items, splits,
                        num_parts))
    return csrs


def chunks(c: CSR) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the row of each chunk, the chunk of each sorted edge) (int64), the
    chunks numbered in edge order: they tile the sorted edges, and a split
    row's chunks come in the order its partials are added in."""
    items = c.items.long()
    items = items[torch.sort(items[:, 1], stable=True).indices]
    return items[:, 0], torch.repeat_interleave(
        torch.arange(items.shape[0], device=items.device), items[:, 2] - items[:, 1],
        output_size=c.col.shape[0])


def chunked_row_sum(c: CSR, vals: torch.Tensor) -> torch.Tensor:
    """Per row of ``c``, ``vals`` (one row a sorted edge) summed as the
    kernels add them: each chunk in edge order from +0.0, then a split
    row's chunk sums in chunk order."""
    rows, chunk = chunks(c)
    part = vals.new_zeros((rows.shape[0],) + vals.shape[1:]).index_add(0, chunk, vals)
    return vals.new_zeros((c.num_nodes,) + vals.shape[1:]).index_add(0, rows, part)


def edge_terms(w: torch.Tensor, xg: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Each edge's term ``g = w x`` from its weights ``w [...]`` and
    gathered x rows ``xg [..., D]``, with the compute dtype's roundings (as
    B7's TPU kernel, ``tpugraph/ops/pallas_packets.py:113-133``): with
    bfloat16, ``w`` and ``x`` rounded to bf16, their product exact in f32
    and rounded to bf16 again."""
    if compute_dtype == torch.bfloat16:
        w = w.to(torch.bfloat16).float()
        xg = xg.to(torch.bfloat16).float()
        return (w[..., None] * xg).to(torch.bfloat16).float()
    return w[..., None] * xg


def spmm_csr_plain(c: CSR, weight: torch.Tensor, x: torch.Tensor,
                   compute_dtype: torch.dtype = torch.float32,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: ``y = A @ x`` over the
    work list of ``c``, each edge's term ``weight[eid] x[col]``
    (:func:`edge_terms`), summed by :func:`chunked_row_sum` in f32 and
    rounded once to ``out_dtype``."""
    g = edge_terms(weight.reshape(-1)[c.eid.long()], x[c.col.long()], compute_dtype)
    return chunked_row_sum(c, g).to(out_dtype or torch.float32)


def launch(lib, entries: Tuple[str, Optional[str]], c: CSR, weight: torch.Tensor,
           x: torch.Tensor, y: torch.Tensor, flags: Tuple[int, ...] = (),
           reduce_flags: Tuple[int, ...] = (),
           launches: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """``y [N, D] = A @ x`` over ``c`` on x's device and stream: ``lib``'s
    main pass ``entries[0]`` and, where rows are split, its reduce pass
    ``entries[1]`` (None: no reduce pass), each counted in ``launches``
    under its name.  The caller checks ``weight``, ``x`` and ``y``.  The
    entries take ``(col, eid, weight, work, n_items, x, y, partial, d, vec,
    *flags, stream)`` and ``(splits, n_split, partial, y, d, vec,
    *reduce_flags, stream)``; ``vec``: D % 4 == 0 and x 16-byte aligned."""
    dev = x.device
    for name in ("col", "eid"):
        check_tensor(name, getattr(c, name), torch.int32, 1, dev)
    check_tensor("items", c.items, torch.int32, 2, dev)
    check_tensor("splits", c.splits, torch.int32, 2, dev)
    if c.eid.shape[0] != c.col.shape[0]:
        raise ValueError("col and eid must hold the same edges")
    n, d = y.shape
    if n == 0 or d == 0:
        return y
    vec = int(d % 4 == 0 and x.data_ptr() % 16 == 0)
    partial = torch.empty((c.num_parts, d), dtype=torch.float32, device=dev)
    main, reduce = entries
    with torch.cuda.device(dev):
        raise_on(getattr(lib, main)(
            c.col.data_ptr(), c.eid.data_ptr(), weight.data_ptr(), c.items.data_ptr(),
            c.items.shape[0], x.data_ptr(), y.data_ptr(), partial.data_ptr(), d, vec,
            *flags, stream(dev)), main)
        if launches is not None:
            launches[main] += 1
        if reduce is not None and c.splits.shape[0]:
            raise_on(getattr(lib, reduce)(
                c.splits.data_ptr(), c.splits.shape[0], partial.data_ptr(),
                y.data_ptr(), d, vec, *reduce_flags, stream(dev)), reduce)
            if launches is not None:
                launches[reduce] += 1
    return y
