"""The port's trace regions on the CPU: a tiny COO job and a tiny packets
job under a profiler record each span the expected number of times,
nested on one clock, with bit-identical results; with no profiler no
region is entered.  Then the benchmark's attribution of device operations
to those spans (``gnnbench/spans.py``) on synthetic events, and today's
per-layer readers on a synthetic trace."""

import collections

import numpy as np
import pytest
import torch

from gnnbench import readers, span_readers, spans
from gnnbench.trace import Trace
from tpugraph_torch.core.graph import graph_from_edges
from tpugraph_torch.nn import GcnEncoderNode
from tpugraph_torch.train.loop import TrainConfig, train_node_classifier
from tpugraph_torch.utils.profiling import trace_backward

torch.set_num_threads(1)

EPOCHS = 3
LAYERS = 3
FORMATS = ("coo", "packets")


def _job(fmt: str):
    """A 3-epoch, 3-layer job on a 60-node random graph: COO, or the
    packets' CPU twin."""
    rng = np.random.default_rng(5)
    n, e = 60, 200
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    g = graph_from_edges(np.concatenate([s, r]), np.concatenate([r, s]), n)
    feat = rng.standard_normal((n, 8)).astype(np.float32)
    labels = rng.integers(0, 3, n)
    torch.manual_seed(0)
    model = GcnEncoderNode(8, 16, 16, 3, LAYERS, bn=True, device="cpu")
    cfg = TrainConfig(num_epochs=EPOCHS, use_bcsr=fmt == "packets",
                      bcsr_format="packets", packet_geom=(32, 32, 8))
    return train_node_classifier(model, g, feat, labels, cfg, device="cpu")


def _profiled(fmt: str):
    """The job under a CPU profiler: its result and its user annotations
    ``(name, thread, start ns, end ns)``."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = _job(fmt)
    spans = [(e.name(), e.start_thread_id(), e.start_ns(),
              e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    return res, spans


@pytest.mark.parametrize("fmt", FORMATS)
def test_each_span_recorded_as_often_as_expected(fmt):
    _, spans = _profiled(fmt)
    got = collections.Counter(name for name, *_ in spans)
    want = {"train.pack": 1, "train.pack.upload": 1, "train.inputs": 1,
            "train_epoch": EPOCHS, "train.forward": EPOCHS,
            "train.backward": EPOCHS, "train.optimizer": EPOCHS,
            "train.eval": 1,
            # every layer of every forward, the closing evaluation's too
            "nn.aggregate": LAYERS * (EPOCHS + 1),
            # the first layer's input features need no gradient
            "nn.aggregate.backward": (LAYERS - 1) * EPOCHS}
    if fmt == "packets":
        want.update({"train.pack.choose": 1, "train.pack.host": 1})
    else:  # COO only uploads its edge list
        want.update({"train.pack.choose": 0, "train.pack.host": 0})
    for name, count in want.items():
        assert got[name] == count, name


@pytest.mark.parametrize("fmt", FORMATS)
def test_spans_nest_on_one_clock(fmt):
    _, spans = _profiled(fmt)
    assert len({tid for _, tid, _, _ in spans}) == 1  # the CPU runs backward inline

    def within(child, parents):
        kids = [(a, b) for n, _, a, b in spans if n == child]
        outer = [(a, b) for n, _, a, b in spans if n in parents]
        assert kids
        for a, b in kids:
            assert any(pa <= a and b <= pb for pa, pb in outer), child

    within("train.pack.upload", {"train.pack"})
    if fmt == "packets":
        within("train.pack.choose", {"train.pack"})
        within("train.pack.host", {"train.pack"})
    for child in ("train.forward", "train.backward", "train.optimizer"):
        within(child, {"train_epoch"})
    within("nn.aggregate", {"train.forward", "train.eval"})
    within("nn.aggregate.backward", {"train.backward"})
    order = sorted((a, n) for n, _, a, _ in spans
                   if n in ("train.pack", "train.inputs", "train_epoch", "train.eval"))
    assert [n for _, n in order] == (["train.pack", "train.inputs"]
                                     + ["train_epoch"] * EPOCHS + ["train.eval"])


@pytest.mark.parametrize("fmt", FORMATS)
def test_results_bit_identical_under_the_profiler(fmt):
    plain = _job(fmt)
    traced, _ = _profiled(fmt)
    assert plain["history"]["loss"] == traced["history"]["loss"]
    assert np.array_equal(plain["ypred"], traced["ypred"])
    assert plain["params"].keys() == traced["params"].keys()
    for k, v in plain["params"].items():
        assert torch.equal(v, traced["params"][k]), k


@pytest.mark.parametrize("fmt", FORMATS)
def test_no_region_or_hook_without_a_profiler(monkeypatch, fmt):
    """With no profiler no ``record_function`` is made, and the backward
    region registers its hooks only with one in hand, so none is
    registered either."""
    def boom(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    res = _job(fmt)
    assert len(res["history"]["loss"]) == EPOCHS


def test_backward_region_opens_only_where_autograd_reaches_x():
    """A backward that stops short of ``x`` (a gradient to the weights
    alone) opens no region, so none is left open; one that reaches ``x``
    opens one, and the gradients are those of the plain product."""
    x = torch.randn(4, 3, requires_grad=True)
    w = torch.randn(4, requires_grad=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        y = trace_backward("bwd", x, lambda xs: xs * w[:, None])
        (gw,) = torch.autograd.grad(y.sum(), [w])
        y = trace_backward("bwd", x, lambda xs: xs * w[:, None])
        y.sum().backward()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    assert names.count("bwd") == 1
    assert torch.equal(gw, x.detach().sum(1))
    assert torch.equal(x.grad, w.detach()[:, None].expand(4, 3))


# ---------------------------------------------------------------- attribution

# The main thread's spans, an autograd thread's product backward inside
# train.backward, the launch calls (kernels, a copy, a set) and the device
# operations they made, on one clock (s).
HOST = [
    ("train_epoch", 0.0, 10.0), ("train.forward", 0.0, 4.0),
    ("nn.aggregate", 1.0, 2.0), ("aten::index_add", 1.2, 1.8),
    ("train.backward", 4.0, 8.0), ("nn.aggregate.backward", 5.0, 6.0),
    ("train.optimizer", 8.0, 10.0), ("Optimizer.step#Adam.step", 8.1, 9.9),
    ("cudaLaunchKernel", 0.5, 0.51),      # forward, outside the product
    ("cudaLaunchKernel", 1.5, 1.51),      # inside nn.aggregate
    ("cudaMemsetAsync", 1.6, 1.61),       # inside nn.aggregate
    ("cuLaunchKernel", 4.5, 4.51),        # autograd's thread, no span of its own
    ("cudaLaunchKernelExC", 5.5, 5.51),   # inside nn.aggregate.backward
    ("cudaMemcpyAsync", 9.0, 9.01),       # inside Adam's own annotation
    ("cudaStreamSynchronize", 9.5, 9.6),  # launches nothing
]
DEVICE = [("k_fwd", 0.6, 1.1), ("k_agg", 1.52, 2.52), ("Memset (Device)", 2.52, 2.62),
          ("k_bwd", 4.6, 5.0), ("k_aggb", 5.6, 6.6), ("Memcpy DtoD (Device -> Device)", 9.1, 9.2),
          ("k_late", 10.5, 10.6)]  # no launch call left for it


def test_launches_matched_by_stream_order_within_each_kind():
    times = spans.launch_times(DEVICE, HOST)
    assert times == [0.5, 1.5, 1.6, 4.5, 5.5, 9.0, None]


def test_a_device_op_a_few_microseconds_before_its_launch_still_matches():
    """The card's clock is converted to the host's with an error of some
    microseconds: order, not time, matches."""
    assert spans.launch_times([("k", 0.999995, 1.2)], [("cudaLaunchKernel", 1.0, 1.01)]) == [1.0]


def test_attribution_innermost_main_thread_and_unattributed():
    paths = spans.attribute(DEVICE, HOST)
    assert paths[0] == ("train_epoch", "train.forward")
    # nested spans: the innermost is the product's
    assert paths[1] == paths[2] == ("train_epoch", "train.forward", "nn.aggregate")
    # another thread with no span: the main thread's open span
    assert paths[3] == ("train_epoch", "train.backward")
    assert paths[4] == ("train_epoch", "train.backward", "nn.aggregate.backward")
    # torch's own annotation is not a program span
    assert paths[5] == ("train_epoch", "train.optimizer")
    assert paths[6] is None


def test_a_launch_under_no_program_span_has_an_empty_path():
    host = [("gnnbench.train_node_classifier", 0.0, 5.0), ("cudaLaunchKernel", 1.0, 1.1)]
    assert spans.attribute([("k", 1.2, 1.3)], host) == [()]


def test_busy_share():
    assert spans.busy_share([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]) == pytest.approx(0.75)
    assert spans.busy_share([]) is None


def _ctx(host=HOST, device=DEVICE, epochs=1):
    tr = Trace(12.0, 3.0, device, host, [])
    return {"trace": tr, "traced_epochs": epochs, "num_nodes": 1000, "nnz": 8000,
            "model": {"layer_inputs": [4, 8], "layer_outputs": [8, 8],
                      "head_input": 16, "classes": 3},
            "jobs": [{"epochs": epochs, "wall_s": 12.0, "pack_s": 0.5}]}


def test_span_readers_on_a_synthetic_job():
    ctx = _ctx(epochs=2)
    agg_s = 1.0 + 0.1 + 1.0  # k_agg, the memset, k_aggb
    least = readers.least_seconds(1000, 8000, readers.product_widths([4, 8], 2))
    assert span_readers.product_roofline(ctx) == pytest.approx(100 * least / agg_s)
    assert span_readers.product_ms_per_epoch(ctx) == pytest.approx(1e3 * agg_s / 2)
    assert span_readers.dense_ms_per_epoch(ctx) == pytest.approx(1e3 * (0.5 + 0.4) / 2)
    assert span_readers.optimizer_ms_per_epoch(ctx) == pytest.approx(1e3 * 0.1 / 2)
    busy = 0.5 + 1.1 + 0.4 + 1.0 + 0.1
    assert span_readers.loop_idle_share(ctx) == pytest.approx(100 * (1 - busy / (9.2 - 0.6)))
    assert span_readers.launches_per_epoch(ctx) == 3.0


def test_span_readers_read_nothing_without_the_spans():
    """A program that marks only its epochs (the parent of these spans)
    gets no product, dense or optimizer reading; without a trace, none."""
    host = [h for h in HOST if not h[0].startswith(("nn.", "train."))]
    ctx = _ctx(host=host)
    for name in ("product_roofline", "product_ms_per_epoch", "dense_ms_per_epoch",
                 "optimizer_ms_per_epoch"):
        assert getattr(span_readers, name)(ctx) is None, name
    assert span_readers.launches_per_epoch(ctx) == 6.0
    for name in ("product_roofline", "loop_idle_share", "launches_per_epoch"):
        assert getattr(span_readers, name)({"traced_epochs": 1}) is None


def test_todays_readers_unchanged_on_a_synthetic_trace():
    """``step_mfu``, ``idle_share``, ``aggregate_roofline`` and ``pack_s``
    read what they read before the spans."""
    host = [("cudaLaunchKernel", 0.0, 0.1)]
    device = [("spmm_packets_kernel_x", 1.0, 3.0), ("indexFuncLargeIndex", 4.0, 5.0),
              ("elementwise_kernel", 5.0, 6.0)]
    ctx = _ctx(host=host, device=device, epochs=2)
    ctx["jobs"].append({"epochs": 2, "wall_s": 8.0, "pack_s": 0.25})
    args = (1000, 8000, [4, 8], [8, 8], 16, 3)
    flops = 2 * (2 * readers.epoch_flops(*args) + readers.forward_flops(*args))
    assert readers.step_mfu(ctx) == pytest.approx(100 * flops / 20.0 / 67e12)
    assert readers.idle_share(ctx) == pytest.approx(75.0)
    least = readers.least_seconds(1000, 8000, readers.product_widths([4, 8], 2))
    assert readers.aggregate_roofline(ctx) == pytest.approx(100 * least / 3.0)
    assert readers.pack_s(ctx) == pytest.approx(0.375)
