"""The port's profiling helpers: ``benchmark`` returns ``tpugraph``'s keys
and rate on a CPU function, ``profile_trace`` writes a Chrome trace that
``device_busy`` reads, and a CPU result is never fenced by a CUDA call."""

import json
import os

import numpy as np
import pytest
import torch

from tpugraph.utils.profiling import benchmark as jax_benchmark
from tpugraph_torch.utils import profiling

torch.set_num_threads(1)


def test_benchmark_keys_and_rate(monkeypatch):
    import jax.numpy as jnp

    def boom():
        raise AssertionError("a CPU result was fenced with a CUDA call")

    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    want = jax_benchmark(lambda x: x * 2, jnp.ones(16), iters=3, warmup=1,
                         work_items=100)
    got = profiling.benchmark(lambda x: x * 2, torch.ones(16), iters=3, warmup=1,
                              work_items=100)
    assert set(got) == set(want) == {"median_s", "mean_s", "min_s", "iters",
                                     "items_per_s"}
    assert got["iters"] == 3.0
    assert got["items_per_s"] == pytest.approx(100 / got["median_s"])
    assert 0 <= got["min_s"] <= got["median_s"]
    no_rate = profiling.benchmark(lambda: [torch.ones(2)], iters=2, warmup=0)
    assert "items_per_s" not in no_rate


def test_profile_trace_writes_a_trace(tmp_path):
    with profiling.profile_trace(str(tmp_path)) as prof:
        with profiling.trace_annotation("region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.isfile(prof.trace_path)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "region" for e in events)
    busy = profiling.device_busy(prof.trace_path, "region")
    assert busy["window_us"] > 0
    assert busy["kernels"] == busy["launches"] == busy["busy_us"] == 0.0
    with pytest.raises(ValueError, match="no region"):
        profiling.device_busy(prof.trace_path, "absent")


def test_device_busy_unions_kernel_intervals(tmp_path):
    """The kernels the region launched (by correlation id) count once where
    they overlap, the window runs to the last of them, and the region's
    device-side copies (``gpu_user_annotation``) are not taken for it."""
    def ev(name, cat, ts, dur, corr=None):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
                **({"args": {"correlation": corr}} if corr else {})}

    events = [
        ev("step", "user_annotation", 100, 100), ev("step", "user_annotation", 300, 50),
        ev("cudaLaunchKernel", "cuda_runtime", 105, 4, 1),
        ev("cudaLaunchKernel", "cuda_runtime", 115, 6, 2),
        ev("cudaLaunchKernel", "cuda_runtime", 190, 2, 3),
        ev("k1", "kernel", 110, 20, 1), ev("k2", "kernel", 120, 20, 2),
        ev("k3", "kernel", 195, 25, 3), ev("k0", "kernel", 10, 30, 9),
        ev("step", "gpu_user_annotation", 110, 110), ev("step", "gpu_user_annotation", 400, 5),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = profiling.device_busy(str(path), "step", index=0)
    assert got["window_us"] == 120 and got["busy_us"] == 30 + 25
    assert got["busy_share"] == pytest.approx(55 / 120)
    assert got["kernels"] == 3 and got["launches"] == 3
    assert got["launch_api_us"] == 4 and got["window_us_per_launch"] == 40
    last = profiling.device_busy(str(path), "step")
    assert last["launches"] == 0 and last["window_us"] == 50


def test_trace_annotation_records_only_under_a_profiler(monkeypatch):
    """Outside a profiler the annotation enters no ``record_function``."""
    def boom(name):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    with profiling.trace_annotation("train_epoch"):
        pass
