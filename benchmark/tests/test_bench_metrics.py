"""The metric arithmetic: readers over a window's numbers, and the trace
reduction over a hand-made trace."""

from types import SimpleNamespace

import pytest

from benchmark import spec, trace


def ctx(**kw):
    base = dict(batch=32, processes=1, setup_s=12.5, peak_bytes=3 * 2 ** 30,
                window={"seconds": 10.0, "steps": 25, "intervals_ms": [],
                        "host_s": []}, trace=None, out_bytes=4,
                config=spec.cell("k400_simclr_r21d.b32").config)
    base.update(kw)
    return SimpleNamespace(**base)


def test_rate_counts_every_step_over_the_whole_window():
    c = ctx(window={"seconds": 10.0, "steps": 25, "intervals_ms": [],
                    "host_s": []})
    assert spec.reader("samples_per_s").read(c) == pytest.approx(80.0)
    c.processes, c.batch = 4, 8  # the global batch's samples
    assert spec.reader("samples_per_s").read(c) == pytest.approx(80.0)


def test_mfu_is_a_share_of_every_chip():
    from benchmark import counts
    c = ctx(window={"seconds": 10.0, "steps": 25})
    one = spec.reader("step.mfu_pct").read(c)
    assert one == pytest.approx(100 * counts.step_flops(c.config, 32)
                                / counts.BF16_FLOPS_PER_S / 0.4)
    c.processes, c.batch = 4, 8
    four = spec.reader("step.mfu_pct").read(c)
    assert four == pytest.approx(one / 4)


def test_p90_shows_a_stall():
    steady = [100.0] * 100
    stalled = [100.0] * 85 + [400.0] * 15
    r = spec.reader("step_ms_p90")
    assert r.read(ctx(window={"intervals_ms": steady})) == pytest.approx(100)
    assert r.read(ctx(window={"intervals_ms": stalled})) == pytest.approx(400)
    # a best-chain minimum or a median would hide it
    assert sorted(stalled)[len(stalled) // 2] == 100.0


def test_p90_needs_ten_intervals():
    assert spec.reader("step_ms_p90").read(
        ctx(window={"intervals_ms": [1.0] * 9})) is None


def test_memory_and_setup():
    assert spec.reader("peak_mem_gib").read(ctx()) == pytest.approx(3.0)
    assert spec.reader("setup_s").read(ctx()) == 12.5


def test_host_ms_is_the_mean_call():
    c = ctx(window={"host_s": [0.1, 0.3]})
    assert spec.reader("trainer.host_ms").read(c) == pytest.approx(200.0)


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def hand_trace():
    """One step: a conv forward span launching kernel 1, a bn backward span
    on the autograd thread launching kernel 2, the optimizer's span
    launching kernel 3, and an aug kernel launched outside any span."""
    return [
        _x("bench.window", "user_annotation", 0, 100),
        _x("bench.step", "user_annotation", 0, 90),
        _x("bench.fwd.conv", "user_annotation", 10, 10),
        _x("cudaLaunchKernel", "cuda_runtime", 12, 1, correlation=1),
        _x("bench.bwd.bn", "user_annotation", 30, 10, tid=2),
        _x("cudaLaunchKernel", "cuda_runtime", 31, 1, tid=2, correlation=2),
        _x("Optimizer.step#SGD.step", "user_annotation", 50, 10),
        _x("cudaLaunchKernel", "cuda_runtime", 52, 1, correlation=3),
        _x("cudaLaunchKernel", "cuda_runtime", 5, 1, correlation=4),
        _x("aten::copy_", "cpu_op", 60, 30),
        _x("conv_kernel", "kernel", 20, 20, tid=7, correlation=1),
        _x("bn_kernel", "kernel", 40, 10, tid=7, correlation=2),
        _x("sgd_kernel", "kernel", 55, 5, tid=7, correlation=3),
        _x("void aug_band_kernel<float, false>(unsigned char const*)",
           "kernel", 6, 4, tid=7, correlation=4),
    ]


def test_trace_reduction_attributes_by_span():
    t = trace.reduce_trace(hand_trace())
    assert t["steps"] == 1
    assert t["group_s"] == pytest.approx({"conv": 20e-6, "bn": 10e-6})
    assert t["optimizer_s"] == pytest.approx(5e-6)
    # busy: [6,10] [20,50] [55,60] of the window [0, 100]
    assert t["window_s"] == pytest.approx(100e-6)
    assert t["busy_s"] == pytest.approx(39e-6)
    gaps = dict(t["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(40e-6)
    assert gaps["bench.fwd.conv"] == pytest.approx(10e-6)


def test_trace_readers():
    t = trace.reduce_trace(hand_trace())
    c = ctx(trace=t)
    assert spec.reader("device.idle_pct").read(c) == pytest.approx(61.0)
    assert spec.reader("backbone.bn_ms").read(c) == pytest.approx(0.01)
    assert spec.reader("optimizer.ms").read(c) == pytest.approx(0.005)
    from benchmark import counts
    need = counts.aug_bytes(c.config, 32, 4)
    assert spec.reader("aug_fused_roofline").read(c) == pytest.approx(
        100 * need / counts.HBM_BYTES_PER_S / 4e-6)


def test_readers_without_anything_to_read_return_none():
    empty = trace.reduce_trace([])
    c = ctx(trace=empty)
    for name in ("aug_fused_roofline", "backbone.conv_roofline",
                 "backbone.bn_ms", "optimizer.ms", "device.idle_pct"):
        assert spec.reader(name).read(c) is None, name
