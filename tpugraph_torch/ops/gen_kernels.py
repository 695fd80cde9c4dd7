"""GENConv's softmax aggregation (DeeperGCN, Li et al., arXiv:2006.07739,
``softmax_sg``) over the self-looped adjacency's :class:`EdgeCSR`, and its
autograd wrapper.  The JAX package has no such layer, so these kernels
replace none.

For receiver ``v`` and channel ``c`` over its in-edges ``u``, with ``mu =
ReLU(x) + eps``::

    w_uv,c = softmax_u (t mu_u,c)        (per receiver AND per channel)
    m_v,c  = sum_u w_uv,c mu_u,c

with the weights ``w`` under ``no_grad``, as the published aggregator
computes them: the gradient flows through ``mu`` alone,

    dx_u,c = [x_u,c > 0] sum_v exp(t mu_u,c - lse_v,c) g_v,c

with ``lse_v,c = log sum_u exp(t mu_u,c)`` kept from the forward.

* :func:`softmax_aggr_csr` — ``(m, lse)`` over ``A``'s work list
  (``csr.CSR``, rows receivers): ``gen_aggr_fwd`` (:func:`softmax_aggr_main`)
  and, where rows are split, ``gen_aggr_fwd_reduce``
  (:func:`softmax_aggr_reduce`; ``csrc/gen_kernels.cu``) on a CUDA tensor;
  :func:`softmax_aggr_plain` on a CPU tensor.
* :func:`softmax_aggr_backward_csr` — ``dx`` over ``A^T``'s work list
  (rows senders): ``gen_aggr_bwd`` and its reduce pass on a CUDA tensor;
  :func:`softmax_aggr_backward_plain` on a CPU tensor.
* :func:`softmax_aggr` — the two as one differentiable call
  (:class:`SoftmaxAggr`).

The plain versions walk the same chunks as the kernels (``ops/csr.py``):
each chunk's maximum, sum and weighted sum per channel, a split row's
chunks merged in order by their maxima.  Every row is normalised by its
own maximum, so no weight underflows whatever ``t`` and ``x`` are.  The
kernels and the plain versions differ by f32 reordering (the kernels'
online softmax rescales as the maximum grows).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from tpugraph_torch.ops._build import check_tensor, library, raise_on, stream
from tpugraph_torch.ops.coo_kernels import EdgeCSR, _dispatch
from tpugraph_torch.ops.csr import CSR, chunked_row_sum, chunks

LAUNCHES: Dict[str, int] = {"softmax_aggr": 0, "softmax_aggr_reduce": 0,
                            "softmax_aggr_backward": 0, "softmax_aggr_backward_reduce": 0}
_bound = False


def _lib():
    global _bound
    lib = library("gen_kernels")
    if not _bound:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gen_aggr_fwd.argtypes = [vp, vp, ci] + [vp] * 4 + [ci, ci, cf, cf, ci, vp]
        lib.gen_aggr_fwd_reduce.argtypes = [vp, ci, vp, ci, vp, vp, ci, ci, vp]
        lib.gen_aggr_bwd.argtypes = [vp, vp, ci] + [vp] * 5 + [ci, cf, cf, ci, vp]
        lib.gen_aggr_bwd_reduce.argtypes = [vp, ci, vp, vp, ci, ci, vp]
        for name in ("gen_aggr_fwd", "gen_aggr_fwd_reduce", "gen_aggr_bwd",
                     "gen_aggr_bwd_reduce"):
            getattr(lib, name).restype = ci
        _bound = True
    return lib


def softmax_aggr_plain(c: CSR, x: torch.Tensor, t: float,
                       eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """What :func:`softmax_aggr_csr` computes, in plain PyTorch over the
    same work list: for each chunk of each row of ``c`` (rows receivers)
    the per-channel maximum of ``t mu`` over its edges, the sum of ``exp(t
    mu - max)`` and of ``exp(t mu - max) mu``, then a split row's chunks
    merged in order by their maxima.  Returns ``(m [N, D], lse [N, D])``
    (``m = 0`` and ``lse = +inf`` on a row with no edge)."""
    n, d = c.num_nodes, x.shape[1]
    rows_i, item = chunks(c)
    mu = (torch.relu(x) + eps)[c.col.long()]
    s = t * mu
    n_items = rows_i.shape[0]
    mx = s.new_full((n_items, d), -torch.inf).scatter_reduce(
        0, item[:, None].expand(-1, d), s, "amax", include_self=True)
    p = torch.exp(s - mx[item])
    sm = s.new_zeros((n_items, d)).index_add(0, item, p)
    ac = s.new_zeros((n_items, d)).index_add(0, item, p * mu)
    big = s.new_full((n, d), -torch.inf).scatter_reduce(
        0, rows_i[:, None].expand(-1, d), mx, "amax", include_self=True)
    coef = torch.where(torch.isfinite(mx), torch.exp(mx - big[rows_i]), 0.0)
    tot = s.new_zeros((n, d)).index_add(0, rows_i, sm * coef)
    acc = s.new_zeros((n, d)).index_add(0, rows_i, ac * coef)
    live = tot > 0
    m = torch.where(live, acc / torch.where(live, tot, 1.0), 0.0)
    lse = torch.where(live, big + torch.log(torch.where(live, tot, 1.0)), torch.inf)
    return m, lse


def softmax_aggr_backward_plain(c_t: CSR, x: torch.Tensor, g: torch.Tensor,
                                lse: torch.Tensor, t: float, eps: float) -> torch.Tensor:
    """What :func:`softmax_aggr_backward_csr` computes, in plain PyTorch
    over ``A^T``'s work list (rows senders ``u``, columns receivers
    ``v``): ``dx_u = [x_u > 0] sum_v exp(t mu_u - lse_v) g_v``, each row
    summed as :func:`~tpugraph_torch.ops.csr.chunked_row_sum` adds."""
    rows_i, item = chunks(c_t)
    dst = c_t.col.long()
    s = t * (torch.relu(x) + eps)
    dx = chunked_row_sum(c_t, torch.exp(s[rows_i[item]] - lse[dst]) * g[dst])
    return torch.where(x > 0, dx, 0.0)


def _check(c: CSR, x: torch.Tensor) -> None:
    dev = x.device
    check_tensor("col", c.col, torch.int32, 1, dev)
    check_tensor("items", c.items, torch.int32, 2, dev)
    check_tensor("splits", c.splits, torch.int32, 2, dev)
    check_tensor("x", x, torch.float32, 2, dev)
    if x.shape[0] != c.num_nodes:
        raise ValueError(f"x must be [{c.num_nodes}, D], got {tuple(x.shape)}")


def _vec(d: int, *tensors: torch.Tensor) -> int:
    """1 where the kernels take 16-byte loads: D % 4 == 0 and every array
    16-byte aligned."""
    return int(d % 4 == 0 and all(v.data_ptr() % 16 == 0 for v in tensors))


def softmax_aggr_csr(c: CSR, x: torch.Tensor, t: float,
                     eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(m [N, D], lse [N, D])`` of the per-channel softmax aggregation
    over ``c`` (the CSR of ``A``, rows receivers) of ``x [N, D]``: the
    kernel on a CUDA tensor (main pass, then the reduce pass where rows are
    split), :func:`softmax_aggr_plain` on a CPU tensor."""
    if not _dispatch("softmax_aggr", x):
        return softmax_aggr_plain(c, x, t, eps)
    m, lse, partial = softmax_aggr_main(c, x, t, eps)
    if c.splits.shape[0] and m.numel():
        softmax_aggr_reduce(c, partial, m, lse)
    return m, lse


def softmax_aggr_main(c: CSR, x: torch.Tensor, t: float, eps: float):
    """The forward's main pass alone (CUDA tensors): ``(m, lse, partial)``,
    the rows that are one chunk written in ``m`` and ``lse [N, D]``, each
    chunk of a split row's maximum, sum and weighted sum in ``partial [3,
    parts, D]`` for :func:`softmax_aggr_reduce`."""
    _check(c, x)
    n, d = x.shape
    dev = x.device
    m = torch.empty((n, d), dtype=torch.float32, device=dev)
    lse = torch.empty((n, d), dtype=torch.float32, device=dev)
    partial = torch.empty((3, c.num_parts, d), dtype=torch.float32, device=dev)
    if n == 0 or d == 0:
        return m, lse, partial
    with torch.cuda.device(dev):
        raise_on(_lib().gen_aggr_fwd(
            c.col.data_ptr(), c.items.data_ptr(), c.items.shape[0], x.data_ptr(),
            m.data_ptr(), lse.data_ptr(), partial.data_ptr(), c.num_parts, d, t, eps,
            _vec(d, x, m, lse, partial), stream(dev)), "gen_aggr_fwd")
        LAUNCHES["softmax_aggr"] += 1
    return m, lse, partial


def softmax_aggr_reduce(c: CSR, partial: torch.Tensor, m: torch.Tensor,
                        lse: torch.Tensor) -> None:
    """The forward's reduce pass alone (CUDA tensors): ``m`` and ``lse`` of
    ``c``'s split rows from the main pass's ``partial [3, parts, D]`` (each
    chunk's maximum, sum and weighted sum), merged in chunk order."""
    dev = m.device
    check_tensor("partial", partial, torch.float32, 3, dev)
    d = m.shape[1]
    if tuple(partial.shape) != (3, c.num_parts, d):
        raise ValueError(f"partial must be [3, {c.num_parts}, {d}]")
    with torch.cuda.device(dev):
        raise_on(_lib().gen_aggr_fwd_reduce(
            c.splits.data_ptr(), c.splits.shape[0], partial.data_ptr(), c.num_parts,
            m.data_ptr(), lse.data_ptr(), d, _vec(d, partial, m, lse), stream(dev)),
            "gen_aggr_fwd_reduce")
        LAUNCHES["softmax_aggr_reduce"] += 1


def softmax_aggr_backward_csr(c_t: CSR, x: torch.Tensor, g: torch.Tensor,
                              lse: torch.Tensor, t: float, eps: float) -> torch.Tensor:
    """``dx [N, D]`` of the aggregation's backward over ``c_t`` (the CSR of
    ``A^T``, rows senders): the kernel on a CUDA tensor,
    :func:`softmax_aggr_backward_plain` on a CPU tensor.  ``g`` is the
    gradient of ``m``, ``lse`` the forward's."""
    if not _dispatch("softmax_aggr_backward", x):
        return softmax_aggr_backward_plain(c_t, x, g, lse, t, eps)
    _check(c_t, x)
    dev = x.device
    for name, v in (("g", g), ("lse", lse)):
        check_tensor(name, v, torch.float32, 2, dev)
        if v.shape != x.shape:
            raise ValueError(f"{name} must be shaped as x, {tuple(x.shape)}")
    n, d = x.shape
    dx = torch.empty((n, d), dtype=torch.float32, device=dev)
    if n == 0 or d == 0:
        return dx
    partial = torch.empty((c_t.num_parts, d), dtype=torch.float32, device=dev)
    vec = _vec(d, x, g, lse, dx, partial)
    lib = _lib()
    with torch.cuda.device(dev):
        raise_on(lib.gen_aggr_bwd(
            c_t.col.data_ptr(), c_t.items.data_ptr(), c_t.items.shape[0], x.data_ptr(),
            g.data_ptr(), lse.data_ptr(), dx.data_ptr(), partial.data_ptr(), d, t, eps, vec,
            stream(dev)), "gen_aggr_bwd")
        LAUNCHES["softmax_aggr_backward"] += 1
        if c_t.splits.shape[0]:
            raise_on(lib.gen_aggr_bwd_reduce(
                c_t.splits.data_ptr(), c_t.splits.shape[0], partial.data_ptr(),
                dx.data_ptr(), d, vec, stream(dev)), "gen_aggr_bwd_reduce")
            LAUNCHES["softmax_aggr_backward_reduce"] += 1
    return dx


class SoftmaxAggr(torch.autograd.Function):
    """The aggregation through an :class:`EdgeCSR`: forward
    :func:`softmax_aggr_csr` on ``A``, keeping ``lse``; backward one pass
    over ``A^T`` (:func:`softmax_aggr_backward_csr`).  The weights carry no
    gradient (``softmax_sg``), so nothing else is saved."""

    @staticmethod
    def forward(ctx, x, csr, t, eps):
        x = x.contiguous()
        m, lse = softmax_aggr_csr(csr.a, x, t, eps)
        ctx.csr, ctx.t, ctx.eps = csr, t, eps
        ctx.save_for_backward(x, lse)
        return m

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        dx = softmax_aggr_backward_csr(ctx.csr.a_t, x, g.contiguous(), lse, ctx.t, ctx.eps)
        return dx, None, None, None


def softmax_aggr(csr: EdgeCSR, x: torch.Tensor, t: float, eps: float) -> torch.Tensor:
    """Differentiable ``m [N, D]``: for each receiver and channel the
    softmax over its in-edges of ``t (ReLU(x_u) + eps)``, under no gradient,
    weighing ``ReLU(x_u) + eps`` (gradients to ``x``), over the edge list
    whose :class:`EdgeCSR` is ``csr``."""
    return SoftmaxAggr.apply(x, csr, float(t), float(eps))
