"""The port's profiler (``profiler.py``) and ``scripts/torch_analyze_trace.py``
against the JAX package's ``profiler.py`` (the cases of
``tests/test_profiler.py``).

``StepTimer`` breakdowns are held equal to JAX's for the same phase
durations; ``compiled_flops`` of a 256x256 matmul and of a small
convolution equal JAX's count (XLA's cost analysis) exactly;
``SystemInfoSampler``'s keys are JAX's. The port holds no TPU peak: its
default peak is the card's.
"""

import inspect
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu import profiler as jprof  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch import profiler  # noqa: E402
from deeplearning4j_tpu_torch.telemetry import MetricsRegistry  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
try:
    import torch_analyze_trace as ta  # noqa: E402
finally:
    sys.path.pop(0)


# ------------------------------------------------------------- StepTimer
def test_step_timer_breakdown_is_jaxs():
    mine, theirs = profiler.StepTimer(), jprof.StepTimer()
    for name, s in (("data", 0.0125), ("step", 0.25), ("data", 0.0375), ("sync", 1e-4)):
        mine.add(name, s)
        theirs.add(name, s)
    assert mine.breakdown() == theirs.breakdown()
    assert mine.breakdown()["data"] == {"total_s": 0.05, "count": 2, "mean_ms": 25.0}
    mine.reset()
    assert mine.breakdown() == {} and mine.totals == {} and mine._open is None


def test_step_timer_phases_tick_tock_and_exceptions():
    t = profiler.StepTimer()
    with t.phase("a"):
        pass
    t.tick("b")
    t.tick("c")  # closes b
    t.tock()
    t.tock()  # nothing open
    assert {k: v["count"] for k, v in t.breakdown().items()} == {"a": 1, "b": 1, "c": 1}
    with pytest.raises(RuntimeError):
        with t.phase("x"):
            raise RuntimeError("boom")
    assert t.breakdown()["x"]["count"] == 1


def test_step_timer_observes_into_the_registry():
    reg = MetricsRegistry()
    t = profiler.StepTimer(registry=reg, component="fit")
    t.add("step", 0.5)
    t.add("step", 0.25)
    text = reg.prometheus_text()
    assert 'dl4jtpu_phase_seconds_count{component="fit",phase="step"} 2' in text


# --------------------------------------------------------- FLOPs and MFU
def test_compiled_flops_of_a_matmul_equal_jaxs():
    a = np.random.default_rng(0).normal(size=(256, 256)).astype(np.float32)
    want = jprof.compiled_flops(jax.jit(lambda x, y: x @ y), jnp.asarray(a), jnp.asarray(a))
    got = profiler.compiled_flops(lambda x, y: x @ y, torch.from_numpy(a), torch.from_numpy(a))
    assert got == want == 2 * 256 ** 3


def test_compiled_flops_of_a_convolution_equal_jaxs():
    x = np.ones((2, 8, 8, 3), np.float32)
    w = np.ones((3, 3, 3, 4), np.float32)
    conv = jax.jit(lambda x, w: jax.lax.conv_general_dilated(
        x, w, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    want = jprof.compiled_flops(conv, jnp.asarray(x), jnp.asarray(w))
    got = profiler.compiled_flops(torch.nn.functional.conv2d,
                                  torch.from_numpy(x).permute(0, 3, 1, 2),
                                  torch.from_numpy(w).permute(3, 2, 0, 1))
    assert got == want == 2 * (2 * 6 * 6 * 4) * (3 * 3 * 3)


def test_compiled_flops_is_none_where_it_counts_nothing():
    assert profiler.compiled_flops(lambda x: torch.tanh(x) + 1, torch.ones(8)) is None


def test_compiled_flops_counts_a_network_forward():
    net = pt.MultiLayerNetwork(pt.MultiLayerConfiguration(
        layers=[pt.DenseLayer(n_out=16, activation="relu"),
                pt.OutputLayer(n_out=3, activation="softmax")],
        input_type=pt.InputType.feed_forward(8)), device="cpu").init()
    flops = profiler.compiled_flops(net.output, np.ones((4, 8), np.float32))
    assert flops == 2 * 4 * (8 * 16 + 16 * 3)


def test_mfu_arithmetic():
    assert profiler.mfu(100e12, 1.0, peak_tflops=200) == pytest.approx(50.0) == \
        jprof.mfu(100e12, 1.0, peak_tflops=200)
    assert profiler.mfu(1.0, 0.0, peak_tflops=1.0) == 0.0
    assert profiler.mfu(1.0, 1.0, peak_tflops=0.0) == 0.0


def test_default_peak_is_the_cards_and_no_tpu_figure(monkeypatch):
    monkeypatch.delenv(profiler.PEAK_ENV, raising=False)
    assert profiler.PEAK_ENV == "DL4J_TPU_PEAK_BF16_TFLOPS"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=profiler.PEAK_ENV):
        profiler.mfu(1e12, 1.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=0: "NVIDIA H100 80GB HBM3")
    assert profiler.peak_bf16_tflops() == 989.0
    assert profiler.mfu(989e12, 2.0) == pytest.approx(50.0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=0: "Some Other Card")
    with pytest.raises(RuntimeError, match="Some Other Card"):
        profiler.peak_bf16_tflops()
    monkeypatch.setenv(profiler.PEAK_ENV, "250")
    assert profiler.peak_bf16_tflops() == 250.0
    assert "197" not in inspect.getsource(profiler)
    assert not hasattr(profiler, "PEAK_BF16_TFLOPS")


# -------------------------------------------------------------- traces
def test_trace_writes_a_chrome_trace_the_analyzer_buckets(tmp_path):
    logdir = str(tmp_path / "trace")
    a = torch.ones(256, 256)
    with profiler.trace(logdir):
        b = a @ a
    assert float(b[0, 0]) == 256.0
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    assert "traceEvents" in json.load(open(os.path.join(logdir, files[0])))
    report = ta.analyze(logdir)
    assert report["source"] == "host_ops" and report["total_device_ns"] > 0
    assert report["buckets_pct"].get("matmul", 0) > 0, report["buckets_pct"]
    assert any(op["name"] == "aten::mm" and op["count"] == 1 for op in report["top_ops"])
    assert set(report["kernel_launches"]) == {label for label, _ in ta.KERNEL_ROWS}


def test_analyzer_counts_the_ports_kernel_rows_on_device_events(tmp_path):
    """A card trace's kernel events: each hand-written kernel counts in its
    row, the library's kernels in their families."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "void sxent_fwd<float, float>(float const*)",
         "dur": 2.0},
        {"ph": "X", "cat": "kernel", "name": "void sxent_bwd<float, float>(float const*)",
         "dur": 3.0},
        {"ph": "X", "cat": "kernel", "name": "void adam_multi<1>(Leaves, Scalars)", "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_fprop_implicit_gemm_f32", "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "ampere_sgemm_128x64_nn", "dur": 20.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "dur": 4.0},
        {"ph": "X", "cat": "kernel",
         "name": "void at::native::vectorized_elementwise_kernel<4>(int)", "dur": 6.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 100.0},
        {"ph": "i", "cat": "kernel", "name": "instant"},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events * 2}))
    r = ta.analyze(str(path))
    assert r["source"] == "device" and r["total_device_ns"] == 2 * 50.0 * 1e3
    launches = r["kernel_launches"]
    assert (launches["softmax_xent fwd, row 10"], launches["softmax_xent bwd, row 11"],
            launches["adam, row 12"]) == (2, 2, 2)
    assert r["buckets_pct"]["convolution fprop"] == 20.0 and r["buckets_pct"]["matmul"] == 40.0
    assert r["buckets_pct"]["copies"] == 8.0 and r["buckets_pct"]["elementwise"] == 12.0
    assert ta.bucket_of("void lstm_bwd_step_mma<float>()") == "lstm, rows 1-2 and 5-9"
    assert ta.bucket_of("void lrn_fwd<float, true>()") == "lrn, rows 3-4"
    assert ta.bucket_of("flash_bwd_dq") == "flash attention, rows 13-15"


def test_profiling_listener_finalizes_on_epoch_end(tmp_path):
    lst = profiler.ProfilingListener(str(tmp_path / "t"), start=1, duration=99)
    lst.iteration_done(object(), 1, torch.zeros(()))
    assert lst._active
    lst.on_epoch_end(object(), 1)  # training ended before start+duration
    assert not lst._active and os.path.exists(lst.trace_path)
    lst.stop()  # again: nothing to do
    with profiler.trace(str(tmp_path / "t2")):  # a later capture works
        torch.ones(4) + 1


def test_profiling_listener_traces_its_window_of_a_fit(tmp_path):
    """Attached to a fit over an epoch of 7 batches: the trace starts after
    update ``start`` and stops after ``duration`` more, so it holds that
    many updates (the output layer's forward matmul once each, counted by
    the analyzer); a trace still open at the epoch's end is finalized
    there."""
    net = pt.MultiLayerNetwork(pt.MultiLayerConfiguration(
        layers=[pt.OutputLayer(n_out=3, activation="softmax")],
        input_type=pt.InputType.feed_forward(4)), device="cpu").init()
    lst = profiler.ProfilingListener(str(tmp_path / "fit"), start=2, duration=3)
    net.set_listeners(lst)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(56, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 56)]
    net.fit(pt.NumpyDataSetIterator(x, y, 8, shuffle=False))
    assert not lst._active and net.iteration == 7
    report = ta.analyze(lst.trace_path)
    counts = {op["name"]: op["count"] for op in report["top_ops"]}
    mm_forward = counts.get("aten::addmm", 0) + counts.get("aten::mm", 0)
    assert mm_forward >= 3 and mm_forward % 3 == 0, counts


def test_system_info_sampler_keys_are_jaxs():
    mine, theirs = profiler.SystemInfoSampler.sample(), jprof.SystemInfoSampler.sample()
    assert set(mine) == set(theirs)
    assert mine["host_rss_mb"] > 0 and mine["device_count"] >= 1
    assert mine["device_platform"] == theirs["device_platform"] == "cpu"
    assert profiler.device_memory_stats() == []  # no card here
