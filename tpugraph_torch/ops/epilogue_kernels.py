"""The row epilogue of each ``GraphConv`` in ``ConvStack``, in one pass
forward and one pass backward: for ``y_lin [N, F]``, the layer's product
before its bias,

``y = y_lin + b``, ``n = y * rsqrt(sum(y^2) + 1e-24)``
(``normalize_embedding``), ``r = relu(n)`` and ``(r - mean r) *
rsqrt(var r + 1e-5)`` (``fresh_batch_norm`` per node, over the features),

per row, with the ReLU and the standardisation on hidden layers only
(``relu``, ``bn``).  The JAX package has no kernel for it: XLA fuses the
chain into the layer's own fusion, so the hand-written kernels of
``tpugraph_torch/csrc/epilogue_kernels.cu`` replace no ``pallas_call``;
they replace torch's seven passes forward and fourteen backward.

* :func:`epilogue_forward` — the output and, for the backward, each row's
  ``(q, mean, s)``: the kernel on a CUDA tensor, the plain version
  :func:`epilogue_forward_plain` (the port's op sequence) on the CPU.
* :func:`epilogue_backward` — the gradient to ``y_lin`` from the output's
  gradient, ``y_lin`` and the row statistics: the kernel, or
  :func:`epilogue_backward_plain` (the kernel's formulas in torch).
* :func:`row_epilogue` — the differentiable epilogue
  (:class:`RowEpilogue`; the bias gradient is ``dy.sum(0)``), which also
  runs under ``torch.func.vmap`` (the multigraph trainer maps the model
  over graphs): the mapped rows are rows, so the batch is one launch.

On the card each row's sums are taken in the kernel's order (a lane's
columns, then across the warp), not torch's: the results differ from the
plain version by f32 reassociation, and repeat bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from tpugraph_torch.ops._build import check_tensor, library, raise_on, stream

LAUNCHES: Dict[str, int] = {"epilogue_fwd": 0, "epilogue_bwd": 0}
NORM_EPS = 1e-24
BN_EPS = 1e-5
_bound = False


def _lib():
    global _bound
    lib = library("epilogue_kernels")
    if not _bound:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.epilogue_fwd.argtypes = [vp] * 4 + [ci] * 3 + [vp]
        lib.epilogue_bwd.argtypes = [vp, ci] + [vp] * 4 + [ci] * 3 + [vp]
        lib.epilogue_fwd.restype = lib.epilogue_bwd.restype = ci
        _bound = True
    return lib


def _mode(relu: bool, bn: bool) -> int:
    """The kernels' variant: 0 normalise only, 1 + ReLU, 2 + ReLU + bn."""
    if bn and not relu:
        raise ValueError("the epilogue standardises after the ReLU: bn needs relu")
    return int(relu) + int(bn)


def epilogue_forward_plain(y_lin: torch.Tensor, bias: Optional[torch.Tensor],
                           relu: bool, bn: bool
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The epilogue as the port's ops compute it (``GraphConv``'s bias add
    and ``normalize_embedding``, ``torch.relu``, ``fresh_batch_norm`` on
    ``[N, F]``), and each row's ``(q, mean, s)`` ``[N, 3]`` (mean 0 and s 1
    without ``bn``)."""
    _mode(relu, bn)
    y = y_lin if bias is None else y_lin + bias
    q = torch.rsqrt(torch.sum(y * y, dim=-1, keepdim=True) + NORM_EPS)
    out = y * q
    mean, s = torch.zeros_like(q), torch.ones_like(q)
    if relu:
        out = torch.relu(out)
    if bn:
        mean = torch.mean(out, dim=(1,), keepdim=True)
        s = torch.rsqrt(torch.var(out, dim=(1,), keepdim=True, correction=0) + BN_EPS)
        out = (out - mean) * s
    return out, torch.cat([q, mean, s], dim=1)


def epilogue_backward_plain(g: torch.Tensor, y_lin: torch.Tensor,
                            bias: Optional[torch.Tensor], stats: torch.Tensor,
                            relu: bool, bn: bool) -> torch.Tensor:
    """The kernel's backward formulas in torch: ``dr = s (g - mean g - o
    mean(g o))`` with ``o = (r - mean) s`` (``bn``; else ``dr = g``), ``dn
    = dr`` where ``r > 0`` (``relu``), ``dy = q dn - y q^3 sum(dn y)``."""
    _mode(relu, bn)
    y = y_lin if bias is None else y_lin + bias
    q, mean, s = stats[:, 0:1], stats[:, 1:2], stats[:, 2:3]
    dn = g
    if relu:
        r = torch.relu(y * q)
        if bn:
            o = (r - mean) * s
            dn = s * (g - g.mean(-1, keepdim=True) - o * (g * o).mean(-1, keepdim=True))
        dn = torch.where(r <= 0, 0.0, dn)
    t = torch.sum(dn * y, dim=-1, keepdim=True)
    return q * dn - y * (q * q * q * t)


def _cuda(t: torch.Tensor, what: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or the CPU, not {t.device}")
    return t.device


def _check_bias(bias: Optional[torch.Tensor], f: int, dev) -> None:
    if bias is not None:
        check_tensor("bias", bias, torch.float32, 1, dev)
        if bias.shape[0] != f:
            raise ValueError(f"bias must hold {f} entries, got {bias.shape[0]}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def epilogue_forward(y_lin: torch.Tensor, bias: Optional[torch.Tensor], relu: bool,
                     bn: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [N, F], stats [N, 3])`` of ``y_lin [N, F]`` float32 and
    ``bias [F]`` (or None): the kernel on a CUDA tensor,
    :func:`epilogue_forward_plain` on the CPU."""
    mode = _mode(relu, bn)
    if y_lin.device.type == "cpu":
        return epilogue_forward_plain(y_lin, bias, relu, bn)
    dev = _cuda(y_lin, "the epilogue")
    check_tensor("y_lin", y_lin, torch.float32, 2, dev)
    n, f = y_lin.shape
    _check_bias(bias, f, dev)
    out = torch.empty_like(y_lin)
    stats = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n and f:
        with torch.cuda.device(dev):
            raise_on(_lib().epilogue_fwd(y_lin.data_ptr(), _ptr(bias), out.data_ptr(),
                                         stats.data_ptr(), n, f, mode, stream(dev)),
                     "epilogue_fwd")
        LAUNCHES["epilogue_fwd"] += 1
    return out, stats


def epilogue_backward(g: torch.Tensor, y_lin: torch.Tensor,
                      bias: Optional[torch.Tensor], stats: torch.Tensor, relu: bool,
                      bn: bool) -> torch.Tensor:
    """``dy [N, F]``, the gradient to ``y_lin`` of the output's gradient
    ``g [N, F]`` (rows may lie apart, as a slice of the concatenation's
    gradient does), from ``y_lin``, ``bias`` and the forward's ``stats``:
    the kernel on a CUDA tensor, :func:`epilogue_backward_plain` on the
    CPU."""
    mode = _mode(relu, bn)
    if y_lin.device.type == "cpu":
        return epilogue_backward_plain(g, y_lin, bias, stats, relu, bn)
    dev = _cuda(y_lin, "the epilogue's backward")
    check_tensor("y_lin", y_lin, torch.float32, 2, dev)
    n, f = y_lin.shape
    _check_bias(bias, f, dev)
    check_tensor("stats", stats, torch.float32, 2, dev)
    if g.shape != y_lin.shape or stats.shape != (n, 3):
        raise ValueError(f"g must be {tuple(y_lin.shape)} and stats ({n}, 3), got "
                         f"{tuple(g.shape)} and {tuple(stats.shape)}")
    if g.dtype != torch.float32 or g.device != dev:
        raise ValueError(f"g must be float32 on {dev}, got {g.dtype} on {g.device}")
    if f > 1 and g.stride(1) != 1 or n > 1 and g.stride(0) < f:
        g = g.contiguous()
    dy = torch.empty_like(y_lin)
    if n and f:
        with torch.cuda.device(dev):
            raise_on(_lib().epilogue_bwd(g.data_ptr(), g.stride(0), y_lin.data_ptr(),
                                         _ptr(bias), stats.data_ptr(), dy.data_ptr(), n,
                                         f, mode, stream(dev)), "epilogue_bwd")
        LAUNCHES["epilogue_bwd"] += 1
    return dy


class RowEpilogue(torch.autograd.Function):
    """The epilogue, ``(out, stats)``, with its gradient to ``y_lin`` by
    :func:`epilogue_backward` and to ``bias`` as ``dy``'s column sum."""

    @staticmethod
    def forward(y_lin, bias, relu, bn):
        return epilogue_forward(y_lin.contiguous(), bias, relu, bn)

    @staticmethod
    def setup_context(ctx, inputs, output):
        y_lin, bias, relu, bn = inputs
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(y_lin, bias, output[1])
        ctx.relu, ctx.bn = relu, bn

    @staticmethod
    def backward(ctx, g, _):
        y_lin, bias, stats = ctx.saved_tensors
        dy = epilogue_backward(g, y_lin.contiguous(), bias, stats, ctx.relu, ctx.bn)
        db = dy.sum(0) if ctx.needs_input_grad[1] else None
        return dy, db, None, None

    @staticmethod
    def vmap(info, in_dims, y_lin, bias, relu, bn):
        """Rows mapped over a batch are rows: one launch on the batch's
        ``[B N, F]`` rows; a mapped bias is added to ``y_lin`` first."""
        y_dim, b_dim = in_dims[:2]
        y = (y_lin.movedim(y_dim, 0) if y_dim is not None
             else y_lin.expand(info.batch_size, *y_lin.shape))
        if b_dim is not None:
            y, bias = y + bias.movedim(b_dim, 0)[:, None, :], None
        b, n, f = y.shape
        out, stats = RowEpilogue.apply(y.reshape(b * n, f), bias, relu, bn)
        return (out.reshape(b, n, f), stats.reshape(b, n, 3)), (0, 0)


def row_epilogue(y_lin: torch.Tensor, bias: Optional[torch.Tensor], relu: bool,
                 bn: bool) -> torch.Tensor:
    """The epilogue of ``y_lin [N, F]`` float32, differentiable."""
    return RowEpilogue.apply(y_lin, bias, relu, bn)[0]
