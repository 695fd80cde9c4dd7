"""The row epilogue of ``ConvStack``'s layers (``ops/epilogue_kernels.py``)
on the CPU: the plain forward is the port's op sequence bit for bit, the
plain backward (the kernel's formulas in torch) agrees with autograd of the
plain forward, and ``ConvStack`` on CPU tensors keeps its separate ops, so
its output and gradients are those of the op sequence it had.  The kernels
themselves are held to these twins on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from tpugraph_torch import ops
from tpugraph_torch.nn import GcnEncoderNode, SparseAdj
from tpugraph_torch.nn.layers import fresh_batch_norm, normalize_embedding
from tpugraph_torch.ops import epilogue_kernels as ek

torch.set_num_threads(1)

VARIANTS = [(False, False), (True, False), (True, True)]  # (relu, bn)
WIDTHS = [20, 256, 300]


def _rows(n, f, seed):
    """``y_lin [n, f]`` with all-zero (padded) rows 0-1 and rows 2-3 that
    the ReLU zeroes whole (every entry negative: the batch norm's variance
    is 0 there), a bias and an output gradient."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((n, f)).astype(np.float32)
    y[:2] = 0.0
    y[2:4] = -np.abs(y[2:4]) - 5.0
    b = (0.1 * rng.standard_normal(f)).astype(np.float32)
    g = rng.standard_normal((n, f)).astype(np.float32)
    return torch.from_numpy(y), torch.from_numpy(b), torch.from_numpy(g)


def _close(got, ref, rel=1e-5):
    """Each entry within ``rel`` of its row's largest |ref| (row sums in
    another order)."""
    scale = ref.abs().amax(-1, keepdim=True) + 1e-30
    assert bool(((got - ref).abs() <= rel * scale).all()), \
        float(((got - ref).abs() / scale).max())


def _port_ops(y_lin, bias, relu, bn):
    y = y_lin if bias is None else y_lin + bias
    y = normalize_embedding(y)
    if relu:
        y = torch.relu(y)
    if bn:
        y = fresh_batch_norm(y)
    return y


@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("relu,bn", VARIANTS)
def test_backward_twin_matches_autograd(relu, bn, use_bias, f):
    y_lin, b, g = _rows(48, f, seed=f + 7 * relu + 3 * bn)
    bias = b if use_bias else None
    y_req = y_lin.clone().requires_grad_()
    b_req = b.clone().requires_grad_() if use_bias else None
    out, stats = ek.epilogue_forward_plain(y_req, b_req, relu, bn)
    out.backward(g)
    dy = ek.epilogue_backward_plain(g, y_lin, bias, stats.detach(), relu, bn)
    _close(dy, y_req.grad)
    assert bool(torch.isfinite(dy).all())
    if use_bias:
        _close(dy.sum(0)[None], b_req.grad[None])
    if relu:  # rows the ReLU zeroes whole: nothing flows back there
        assert bool((dy[0 if bias is None else 2:4] == 0).all())


@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("relu,bn", VARIANTS)
def test_forward_plain_is_the_port_ops(relu, bn, f):
    y_lin, b, _ = _rows(40, f, seed=f)
    for bias in (None, b):
        out, stats = ek.epilogue_forward_plain(y_lin, bias, relu, bn)
        assert torch.equal(out, _port_ops(y_lin, bias, relu, bn))
        y = y_lin if bias is None else y_lin + bias
        assert torch.equal(stats[:, 0], torch.rsqrt((y * y).sum(-1) + 1e-24))
        if not bn:
            assert bool((stats[:, 1] == 0).all() and (stats[:, 2] == 1).all())
            continue
        # variance 0 on the rows the ReLU zeroes whole: s = rsqrt(1e-5), output 0
        zeroed = slice(0 if bias is None else 2, 4)
        assert bool((out[zeroed] == 0).all())
        torch.testing.assert_close(stats[zeroed, 2],
                                   torch.full_like(stats[zeroed, 2], 1e-5 ** -0.5),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("relu,bn", VARIANTS)
def test_row_epilogue_on_cpu_takes_the_twins(relu, bn):
    """On CPU tensors the autograd wrapper runs the plain forward and the
    plain backward and counts no launch."""
    y_lin, b, g = _rows(32, 20, seed=3)
    ops.reset_launch_counts()
    y_req, b_req = y_lin.clone().requires_grad_(), b.clone().requires_grad_()
    out = ek.row_epilogue(y_req, b_req, relu, bn)
    out.backward(g)
    ref, stats = ek.epilogue_forward_plain(y_lin, b, relu, bn)
    assert torch.equal(out.detach(), ref)
    dy = ek.epilogue_backward_plain(g, y_lin, b, stats, relu, bn)
    assert torch.equal(y_req.grad, dy)
    assert torch.equal(b_req.grad, dy.sum(0))
    with torch.no_grad():
        assert torch.equal(ek.row_epilogue(y_req, b_req, relu, bn), ref)
    assert sum(ops.launch_counts().values()) == 0


@pytest.mark.parametrize("bias_mapped", [False, True])
@pytest.mark.parametrize("relu,bn", VARIANTS)
def test_row_epilogue_under_vmap_is_the_flat_rows(relu, bn, bias_mapped):
    """Mapped over a batch with ``torch.func.vmap`` (as the multigraph
    trainer maps the model over graphs), the epilogue is the flat rows'
    epilogue, output and gradients bit for bit; a mapped bias too."""
    y_lin, b, g = _rows(48, 20, seed=5)
    y3, g3 = y_lin.reshape(3, 16, 20), g.reshape(3, 16, 20)
    bias = (torch.stack([b, 2 * b, -b]) if bias_mapped else b)
    b_flat = (bias[:, None, :].expand(3, 16, 20).reshape(48, 20) if bias_mapped
              else bias)
    grads = []
    for mapped in (True, False):
        y_req, b_req = y3.clone().requires_grad_(), bias.clone().requires_grad_()
        if mapped:
            out = torch.func.vmap(
                lambda y, bb: ek.row_epilogue(y, bb, relu, bn),
                in_dims=(0, 0 if bias_mapped else None))(y_req, b_req)
        else:
            y = y_req.reshape(48, 20)
            if bias_mapped:  # the mapped bias is added first, as the rule does
                y = y + b_req[:, None, :].expand(3, 16, 20).reshape(48, 20)
            out = ek.row_epilogue(y, None if bias_mapped else b_req, relu,
                                  bn).reshape(3, 16, 20)
        out.backward(g3)
        grads.append((out.detach(), y_req.grad, b_req.grad))
    for got, ref in zip(*grads):
        assert torch.equal(got, ref)
    flat = ek.epilogue_forward_plain(y3.reshape(48, 20), b_flat, relu, bn)[0]
    assert torch.equal(grads[0][0].reshape(48, 20), flat)
    with torch.no_grad():
        out = torch.func.vmap(lambda y: ek.row_epilogue(y, b, relu, bn))(y3)
    assert torch.equal(out.reshape(48, 20),
                       ek.epilogue_forward_plain(y3.reshape(48, 20), b, relu, bn)[0])


def test_epilogue_rejects_bn_without_relu_and_other_devices():
    y_lin, b, g = _rows(8, 20, seed=1)
    with pytest.raises(ValueError, match="bn needs relu"):
        ek.epilogue_forward(y_lin, b, relu=False, bn=True)
    with pytest.raises(ValueError, match="runs on CUDA or the CPU"):
        ek.epilogue_forward(y_lin.to("meta"), None, relu=True, bn=True)
    with pytest.raises(ValueError, match="runs on CUDA or the CPU"):
        ek.epilogue_backward(g.to("meta"), y_lin.to("meta"), None,
                             torch.zeros((8, 3), device="meta"), relu=True, bn=False)


def _graph(n, e, seed):
    rng = np.random.default_rng(seed)
    s = torch.from_numpy(rng.integers(0, n, e).astype(np.int64))
    r = torch.from_numpy(rng.integers(0, n - 3, e).astype(np.int64))  # 3 lonely rows
    w = torch.from_numpy(rng.random(e).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((n, 10)).astype(np.float32))
    return SparseAdj(s, r, w), x


def _stack_ops_before(stack, x, adj):
    """``ConvStack.forward`` as the separate ops compute it: each layer's
    own forward, then ReLU and batch norm on the hidden ones, concatenated."""
    outs = []
    for conv in [stack.conv_first, *stack.conv_block]:
        x, _ = conv(x, adj)
        x = torch.relu(x)
        if stack.bn:
            x = fresh_batch_norm(x)
        outs.append(x)
    x, _ = stack.conv_last(x, adj)
    outs.append(x)
    return torch.cat(outs, dim=-1)


@pytest.mark.parametrize("bn,add_self", [(False, False), (True, False), (True, True)])
def test_conv_stack_on_cpu_is_bit_identical_to_its_ops(bn, add_self):
    adj, x = _graph(60, 300, seed=11)
    model = GcnEncoderNode(10, 20, 20, 4, 4, bn=bn, add_self=add_self,
                           generator=torch.Generator().manual_seed(0), device="cpu")
    ops.reset_launch_counts()
    grads = []
    for run in (lambda: model.stack(x, adj)[0],
                lambda: _stack_ops_before(model.stack, x, adj)):
        model.zero_grad()
        emb = run()
        (emb * torch.linspace(-1, 1, emb.shape[1])).sum().backward()
        grads.append((emb.detach(), {k: p.grad.clone()
                                     for k, p in model.stack.named_parameters()}))
    (e0, g0), (e1, g1) = grads
    assert torch.equal(e0, e1)
    assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0)
    assert sum(ops.launch_counts().values()) == 0
