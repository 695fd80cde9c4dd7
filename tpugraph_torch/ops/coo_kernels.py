"""The COO adjacency product over a CSR of the edge list, and its autograd
wrapper: the training path's ``A @ x`` on a :class:`SparseAdj` that carries
an :class:`EdgeCSR`.

The JAX package computes this product with XLA's gather and
``segment_sum`` (``tpugraph/ops/message.py:22``), outside any Pallas
kernel, so this kernel replaces none: it replaces the port's plain
``index_select``, multiply and atomic ``index_add_``
(:func:`tpugraph_torch.ops.message.spmm`), which wrote an E x D message
tensor and summed it with atomics.

* :func:`edge_csr` — the :class:`~tpugraph_torch.ops.csr.CSR` of A (edges
  stable-sorted by receiver) and of A^T (by sender) with each row's work
  list, built once by :func:`~tpugraph_torch.ops.csr.row_csrs` on the
  edges' own device (device sorts and scans on the card, one host sync for
  the work lists' sizes).
* :func:`spmm_csr` — ``y = A @ x`` on one direction: the row walk of
  ``tpugraph_torch/csrc/row_spmm.cuh`` (``spmm_coo_csr`` and its reduce
  pass in ``csrc/coo_kernels.cu``) on a CUDA tensor; it raises on any
  other, where :func:`message.spmm` is the product.
* :class:`CsrMatvec` — ``A @ x`` with ``dx = A^T g`` through the same
  kernel, and, where the weights need a gradient (attention on COO),
  ``dw_e = <g[r_e], x[s_e]>`` by :func:`message.sddmm`.
* :func:`gat_attention` — GAT's multi-head edge attention over the same
  work lists (:class:`GatAttention`): for each receiver ``i`` and head
  ``h``, ``y_i^h = sum_j softmax_j(LeakyReLU(el_j^h + er_i^h)) z_j^h`` over
  its in-edges, forward on ``A``'s work list, backward on ``A^T``'s.

``ops/csr.py`` says how the kernel walks the work list.  A row that is one
chunk has the bits of :func:`message.spmm` on the CPU (which sums each row
in edge order); a split row differs by the reassociation of its chunk
sums.  The kernel runs at about the speed of ``torch.sparse.mm`` on a CSR
tensor of the same edges; it is hand-written for what the library call
does not give: the same bits on every launch, the CPU's bits on unsplit
rows, and a product independent of the cuSPARSE one that the benchmark's
reference job computes.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict

import torch

from tpugraph_torch.ops._build import check_tensor, library, raise_on, stream
from tpugraph_torch.ops.csr import CSR, chunked_row_sum, chunks, launch, row_csrs
from tpugraph_torch.ops.message import sddmm

LAUNCHES: Dict[str, int] = {"spmm_coo_csr": 0, "spmm_coo_csr_reduce": 0,
                            "gat_attention": 0, "gat_attention_reduce": 0,
                            "gat_attention_backward": 0,
                            "gat_attention_backward_reduce": 0,
                            "gat_attention_dst_sum": 0}
# Heads the attention kernels hold at most, and the widest row (all heads)
# a warp holds: 16 slots a lane of 2 columns (1 where a head's width is odd).
GAT_MAX_HEADS = 8
_GAT_SLOTS = (1, 2, 4, 8, 12, 16)
_bound = False


@dataclasses.dataclass
class EdgeCSR:
    """The CSR of ``A`` (rows are receivers, ``A[r, s] = w``) and of
    ``A^T`` (rows are senders) of one padded COO edge list."""

    a: CSR
    a_t: CSR

    def to(self, device) -> "EdgeCSR":
        return EdgeCSR(self.a.to(device), self.a_t.to(device))


def edge_csr(senders: torch.Tensor, receivers: torch.Tensor,
             num_nodes: int) -> EdgeCSR:
    """The :class:`EdgeCSR` of edges ``senders[e] -> receivers[e]`` over
    ``num_nodes`` nodes (int32 or int64 indices, padding edges included),
    with torch on the edges' device, in chunks of ``csr.CHUNK_EDGES``.
    Within a row the edges keep their order in the edge list.  One host
    sync fetches the work lists' sizes and, with them, the check that every
    index lies in ``[0, num_nodes)``: each direction's rows span all the
    edges."""
    if senders.shape != receivers.shape or senders.dim() != 1:
        raise ValueError("senders and receivers must be 1-D and of one length")
    e = senders.shape[0]
    s, r = senders.int(), receivers.int()
    csrs = row_csrs([(receivers, lambda eid: torch.gather(s, 0, eid)),
                     (senders, lambda eid: torch.gather(r, 0, eid))], num_nodes)
    if any(c.eid.shape[0] != e for c in csrs):
        raise ValueError(f"edge indices must lie in [0, {num_nodes})")
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
        cf = ctypes.c_float
        lib.gat_attn_fwd.argtypes = ([vp, vp, ci] + [vp] * 7
                                     + [ci, ci, ci, cf, ci, ci, vp])
        lib.gat_attn_fwd_reduce.argtypes = [vp, ci] + [vp] * 4 + [ci, ci, ci, vp]
        lib.gat_attn_bwd.argtypes = ([vp, vp, vp, ci] + [vp] * 11
                                     + [ci, ci, ci, cf, ci, ci, vp])
        lib.gat_attn_bwd_reduce.argtypes = [vp, ci] + [vp] * 4 + [ci, ci, vp]
        lib.gat_attn_dst_sum.argtypes = [vp, vp, ci, vp, vp, ci, vp]
        for name in ("gat_attn_fwd", "gat_attn_fwd_reduce", "gat_attn_bwd",
                     "gat_attn_bwd_reduce", "gat_attn_dst_sum"):
            getattr(lib, name).restype = ci
        _bound = True
    return lib


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
    check_tensor("weight", weight, torch.float32, 1, x.device)
    check_tensor("x", x, torch.float32, 2, x.device)
    if weight.shape[0] != c.col.shape[0]:
        raise ValueError(f"weight must hold the {c.col.shape[0]} edges")
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    return launch(_lib(), ("spmm_coo_csr", "spmm_coo_csr_reduce"), c, weight, x, y,
                  launches=LAUNCHES)


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


# ---------------------------------------------------------------------------
# GAT edge attention over the CSR work lists


def _leaky(sc: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(sc > 0, sc, sc * slope)


def gat_attention_plain(c: CSR, z: torch.Tensor, el: torch.Tensor, er: torch.Tensor,
                        heads: int, slope: float):
    """What :func:`gat_attention_csr` computes, in plain PyTorch over the
    same work list: for each chunk the running maximum of the scores, the
    sum of ``exp(e - m)`` and of ``exp(e - m) z_j``, then a split row's
    chunks merged in order by their maxima.  Returns ``(y [N, D], lse [N,
    H])``, ``lse = m + log(sum)`` (``+inf`` on a row with no edge, whose
    ``y`` is 0)."""
    n, d = c.num_nodes, z.shape[1]
    f = d // heads
    rows_i, item = chunks(c)
    src, rows = c.col.long(), rows_i[item]
    e = _leaky(el[src] + er[rows], slope)
    n_items = rows_i.shape[0]
    m = e.new_full((n_items, heads), -torch.inf).scatter_reduce(
        0, item[:, None].expand(-1, heads), e, "amax", include_self=True)
    p = torch.exp(e - m[item])
    s = e.new_zeros((n_items, heads)).index_add(0, item, p)
    acc = z.new_zeros((n_items, d)).index_add(
        0, item, p.repeat_interleave(f, 1) * z[src])
    big = e.new_full((n, heads), -torch.inf).scatter_reduce(
        0, rows_i[:, None].expand(-1, heads), m, "amax", include_self=True)
    coef = torch.where(torch.isfinite(m), torch.exp(m - big[rows_i]), 0.0)
    total = e.new_zeros((n, heads)).index_add(0, rows_i, s * coef)
    acc = z.new_zeros((n, d)).index_add(0, rows_i, acc * coef.repeat_interleave(f, 1))
    live = total > 0
    y = torch.where(live.repeat_interleave(f, 1),
                    acc / torch.where(live, total, 1.0).repeat_interleave(f, 1), 0.0)
    lse = torch.where(live, big + torch.log(torch.where(live, total, 1.0)), torch.inf)
    return y, lse


def gat_attention_backward_plain(c_t: CSR, z: torch.Tensor, g: torch.Tensor,
                                 el: torch.Tensor, er: torch.Tensor, lse: torch.Tensor,
                                 t: torch.Tensor, heads: int, slope: float):
    """What :func:`gat_attention_backward_csr` computes, in plain PyTorch
    over ``A^T``'s work list (rows are senders ``j``, columns receivers
    ``i``): ``alpha_ij`` recomputed from ``lse``, ``ds_ij = alpha_ij
    (<g_i, z_j> - t_i) LeakyReLU'``, per head; returns ``(dz [N, D] =
    sum_i alpha_ij g_i, d_el [N, H] = sum_i ds_ij, de [E, H] = ds`` in
    the edge list's order``)``."""
    n, d = c_t.num_nodes, z.shape[1]
    f = d // heads
    rows_i, item = chunks(c_t)
    dst, rows = c_t.col.long(), rows_i[item]
    sc = el[rows] + er[dst]
    alpha = torch.exp(_leaky(sc, slope) - lse[dst])
    gi = g[dst]
    dot = (gi.view(-1, heads, f) * z[rows].view(-1, heads, f)).sum(-1)
    ds = alpha * (dot - t[dst]) * torch.where(sc > 0, 1.0, slope)
    dz = chunked_row_sum(c_t, alpha.repeat_interleave(f, 1) * gi)
    d_el = chunked_row_sum(c_t, ds)
    de = torch.empty_like(ds)
    de[c_t.eid.long()] = ds
    return dz, d_el, de


def gat_dst_sum_plain(c: CSR, de: torch.Tensor) -> torch.Tensor:
    """``d_er [N, H]``: each row of ``A`` (a receiver) sums ``de`` over its
    edges, in CSR order."""
    rows, item = chunks(c)
    return de.new_zeros((c.num_nodes, de.shape[1])).index_add(
        0, rows[item], de[c.eid.long()])


def _gat_shape(d: int, heads: int, ptrs) -> tuple:
    """(columns a slot, slots a lane) of the kernels for rows of ``d``
    columns over ``heads`` heads: 2 columns a slot (8-byte loads) where a
    head's width is even and the rows 8-byte aligned."""
    if not 1 <= heads <= GAT_MAX_HEADS:
        raise ValueError(f"the attention kernels take 1 to {GAT_MAX_HEADS} heads, "
                         f"got {heads}")
    if d % heads:
        raise ValueError(f"D = {d} is not a multiple of {heads} heads")
    pair = (d // heads) % 2 == 0 and all(p % 8 == 0 for p in ptrs)
    w = 2 if pair else 1
    need = -(-d // (32 * w))
    for nv in _GAT_SLOTS:
        if nv >= need:
            return int(pair), nv
    raise NotImplementedError(f"the attention kernels hold rows of at most "
                              f"{32 * w * _GAT_SLOTS[-1]} columns, got D = {d}")


def _check_gat(c: CSR, z, el, er, heads):
    dev = z.device
    for name, t in (("col", c.col), ("eid", c.eid)):
        check_tensor(name, t, torch.int32, 1, dev)
    check_tensor("items", c.items, torch.int32, 2, dev)
    check_tensor("splits", c.splits, torch.int32, 2, dev)
    check_tensor("z", z, torch.float32, 2, dev)
    for name, t in (("el", el), ("er", er)):
        check_tensor(name, t, torch.float32, 2, dev)
        if tuple(t.shape) != (c.num_nodes, heads):
            raise ValueError(f"{name} must be [{c.num_nodes}, {heads}], got {tuple(t.shape)}")
    if z.shape[0] != c.num_nodes:
        raise ValueError(f"z must be [{c.num_nodes}, D], got {tuple(z.shape)}")


def _dispatch(name: str, z: torch.Tensor) -> bool:
    """True for the kernel (a CUDA tensor), False for the plain version (a
    CPU tensor); raises on any other device."""
    if z.device.type == "cuda":
        return True
    if z.device.type == "cpu":
        return False
    raise ValueError(f"{name} runs on CUDA (the kernel) or the CPU (its plain "
                     f"version), not {z.device}")


def gat_attention_csr(c: CSR, z: torch.Tensor, el: torch.Tensor, er: torch.Tensor,
                      heads: int, slope: float):
    """``(y [N, D], lse [N, H])`` of the edge softmax over ``c`` (the CSR of
    ``A``, rows receivers): the kernel on a CUDA tensor (main pass, then the
    reduce pass where rows are split), :func:`gat_attention_plain` on a CPU
    tensor.  ``z [N, D]`` the senders' features (``D = heads * F``), ``el
    [N, H]`` the sender scores, ``er [N, H]`` the receiver scores."""
    if not _dispatch("gat_attention", z):
        return gat_attention_plain(c, z, el, er, heads, slope)
    _check_gat(c, z, el, er, heads)
    n, d = z.shape
    dev = z.device
    pair, nv = _gat_shape(d, heads, (z.data_ptr(),))
    y = torch.empty((n, d), dtype=torch.float32, device=dev)
    lse = torch.empty((n, heads), dtype=torch.float32, device=dev)
    if n == 0:
        return y, lse
    part_acc = torch.empty((c.num_parts, d), dtype=torch.float32, device=dev)
    part_ms = torch.empty((c.num_parts, 2 * heads), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        raise_on(lib.gat_attn_fwd(
            c.col.data_ptr(), c.items.data_ptr(), c.items.shape[0], z.data_ptr(),
            el.data_ptr(), er.data_ptr(), y.data_ptr(), lse.data_ptr(),
            part_acc.data_ptr(), part_ms.data_ptr(), d, d // heads, heads, slope,
            pair, nv, stream(dev)), "gat_attn_fwd")
        LAUNCHES["gat_attention"] += 1
        if c.splits.shape[0]:
            raise_on(lib.gat_attn_fwd_reduce(
                c.splits.data_ptr(), c.splits.shape[0], part_acc.data_ptr(),
                part_ms.data_ptr(), y.data_ptr(), lse.data_ptr(), d, d // heads,
                heads, stream(dev)), "gat_attn_fwd_reduce")
            LAUNCHES["gat_attention_reduce"] += 1
    return y, lse


def gat_attention_backward_csr(c_t: CSR, z, g, el, er, lse, t, heads: int,
                               slope: float):
    """``(dz [N, D], d_el [N, H], de [E, H])`` of the attention's backward
    over ``c_t`` (the CSR of ``A^T``, rows senders): the kernel on a CUDA
    tensor, :func:`gat_attention_backward_plain` on a CPU tensor.  ``g`` is
    the gradient of the attention's output ``y``, ``lse`` the forward's,
    ``t [N, H] = <g_i^h, y_i^h>``."""
    if not _dispatch("gat_attention_backward", z):
        return gat_attention_backward_plain(c_t, z, g, el, er, lse, t, heads, slope)
    _check_gat(c_t, z, el, er, heads)
    dev = z.device
    check_tensor("g", g, torch.float32, 2, dev)
    for name, v in (("lse", lse), ("t", t)):
        check_tensor(name, v, torch.float32, 2, dev)
        if v.shape != el.shape:
            raise ValueError(f"{name} must be shaped as el, {tuple(el.shape)}")
    if g.shape != z.shape:
        raise ValueError(f"g must be shaped as z, {tuple(z.shape)}")
    n, d = z.shape
    e = c_t.col.shape[0]
    pair, nv = _gat_shape(d, heads, (z.data_ptr(), g.data_ptr()))
    dz = torch.empty((n, d), dtype=torch.float32, device=dev)
    d_el = torch.empty((n, heads), dtype=torch.float32, device=dev)
    de = torch.empty((e, heads), dtype=torch.float32, device=dev)
    if n == 0:
        return dz, d_el, de
    part_dz = torch.empty((c_t.num_parts, d), dtype=torch.float32, device=dev)
    part_del = torch.empty((c_t.num_parts, heads), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        raise_on(lib.gat_attn_bwd(
            c_t.col.data_ptr(), c_t.eid.data_ptr(), c_t.items.data_ptr(),
            c_t.items.shape[0], z.data_ptr(), g.data_ptr(), el.data_ptr(),
            er.data_ptr(), lse.data_ptr(), t.data_ptr(), dz.data_ptr(),
            d_el.data_ptr(), de.data_ptr(), part_dz.data_ptr(), part_del.data_ptr(),
            d, d // heads, heads, slope, pair, nv, stream(dev)), "gat_attn_bwd")
        LAUNCHES["gat_attention_backward"] += 1
        if c_t.splits.shape[0]:
            raise_on(lib.gat_attn_bwd_reduce(
                c_t.splits.data_ptr(), c_t.splits.shape[0], part_dz.data_ptr(),
                part_del.data_ptr(), dz.data_ptr(), d_el.data_ptr(), d, heads,
                stream(dev)), "gat_attn_bwd_reduce")
            LAUNCHES["gat_attention_backward_reduce"] += 1
    return dz, d_el, de


def gat_dst_sum(c: CSR, de: torch.Tensor) -> torch.Tensor:
    """``d_er [N, H]``, ``de`` summed over each row of ``c`` (the CSR of
    ``A``): the kernel on a CUDA tensor (a warp a row, a fixed order),
    :func:`gat_dst_sum_plain` on a CPU tensor."""
    if not _dispatch("gat_dst_sum", de):
        return gat_dst_sum_plain(c, de)
    dev = de.device
    check_tensor("de", de, torch.float32, 2, dev)
    check_tensor("rowptr", c.rowptr, torch.int32, 1, dev)
    check_tensor("eid", c.eid, torch.int32, 1, dev)
    if de.shape[0] != c.eid.shape[0] or not 1 <= de.shape[1] <= GAT_MAX_HEADS:
        raise ValueError(f"de must be [{c.eid.shape[0]}, H <= {GAT_MAX_HEADS}], "
                         f"got {tuple(de.shape)}")
    n, heads = c.num_nodes, de.shape[1]
    der = torch.empty((n, heads), dtype=torch.float32, device=dev)
    if n == 0:
        return der
    with torch.cuda.device(dev):
        raise_on(_lib().gat_attn_dst_sum(c.rowptr.data_ptr(), c.eid.data_ptr(), n,
                                         de.data_ptr(), der.data_ptr(), heads,
                                         stream(dev)), "gat_attn_dst_sum")
        LAUNCHES["gat_attention_dst_sum"] += 1
    return der


class GatAttention(torch.autograd.Function):
    """GAT's edge attention through an :class:`EdgeCSR`: forward
    :func:`gat_attention_csr` on ``A``, keeping the log-sum-exp of each
    row and head; backward ``t = <g, y>`` by head (so the softmax's
    backward needs no extra pass over the rows), one pass over ``A^T``
    (:func:`gat_attention_backward_csr`: ``dz``, the sender scores'
    gradient and each edge's ``ds``), and ``ds`` summed over ``A``'s rows
    for the receiver scores' gradient (:func:`gat_dst_sum`)."""

    @staticmethod
    def forward(ctx, z, el, er, csr, heads, slope):
        z, el, er = z.contiguous(), el.contiguous(), er.contiguous()
        y, lse = gat_attention_csr(csr.a, z, el, er, heads, slope)
        ctx.csr, ctx.heads, ctx.slope = csr, heads, slope
        ctx.save_for_backward(z, el, er, y, lse)
        return y

    @staticmethod
    def backward(ctx, g):
        z, el, er, y, lse = ctx.saved_tensors
        g = g.contiguous()
        n, d = g.shape
        t = (g * y).view(n, ctx.heads, d // ctx.heads).sum(-1)
        dz, d_el, de = gat_attention_backward_csr(ctx.csr.a_t, z, g, el, er, lse, t,
                                                  ctx.heads, ctx.slope)
        return dz, d_el, gat_dst_sum(ctx.csr.a, de), None, None, None


def gat_attention(csr: EdgeCSR, z: torch.Tensor, el: torch.Tensor, er: torch.Tensor,
                  heads: int, slope: float) -> torch.Tensor:
    """Differentiable multi-head edge attention (gradients to ``z``, ``el``
    and ``er``): ``y_i^h = sum_j alpha_ij^h z_j^h`` with ``alpha_ij^h =
    softmax_j LeakyReLU_slope(el_j^h + er_i^h)`` over the in-edges ``j -> i``
    of the edge list whose :class:`EdgeCSR` is ``csr``.  ``z [N, H F]``,
    ``el``, ``er [N, H]`` -> ``[N, H F]``, heads side by side."""
    return GatAttention.apply(z, el, er, csr, heads, slope)
