"""The spans' arithmetic (``span_arith``) on a synthetic Chrome trace, the
readers of the program's spans and counters, and the events they take from a
live profiler against the Chrome trace the same profiler exports."""

import json

import pytest
import torch

import span_arith
import trace_arith
from readers import Context, idle_program, lane_use, ns_per_lane, program, span_host_ms


def _trace():
    """Two frames on the main thread (µs): ``ca3d.frame`` 0-40 holding
    ``ca3d.k1`` 10-30, and 50-80; runtime calls 12-14 and 20-28 (a launch
    blocked on a full queue) in K1, 35-36 and 60-61 in the frames; device
    events 5-15, 25-45, 70-90 and a copy 40-42; on another thread a
    ``ca3d.frame`` 42-48 and one host op."""
    def x(cat, name, a, b, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": float(a), "dur": float(b - a),
                "pid": 0 if cat in trace_arith.DEVICE_CATS else 1, "tid": tid, "args": args}

    return [
        x("cpu_op", "aten::empty", 0, 1), x("cpu_op", "aten::empty", 50, 51),
        x("user_annotation", "ca3d.frame", 0, 40), x("user_annotation", "ca3d.k1", 10, 30),
        x("user_annotation", "ca3d.frame", 50, 80), x("user_annotation", "other", 45, 70),
        x("cuda_runtime", "cudaLaunchKernel", 12, 14),
        x("cuda_runtime", "cudaLaunchKernel", 20, 28), x("cuda_driver", "cuLaunchKernel", 21, 27),
        x("cuda_runtime", "cudaLaunchKernel", 35, 36),
        x("cuda_runtime", "cudaLaunchKernel", 60, 61),
        x("kernel", "render_kernel<0>", 5, 15, tid=7),
        x("kernel", "render_kernel<0>", 25, 45, tid=7),
        x("gpu_memcpy", "Memcpy DtoD", 40, 42, tid=7),
        x("kernel", "ca_step_kernel<1>", 70, 90, tid=7),
        x("cpu_op", "aten::empty", 42, 43, tid=2),
        x("user_annotation", "ca3d.frame", 42, 48, tid=2),
    ]


def test_spans_host_time_and_idle():
    s = span_arith.summarize(_trace())
    frame, k1 = s["spans"]["ca3d.frame"], s["spans"]["ca3d.k1"]
    assert frame["count"] == 3 and frame["ms"] == pytest.approx(0.076)
    # The runtime calls inside (the driver call nested in a launch once)
    # are not the host's own time.
    assert frame["host_ms"] == pytest.approx((40 - 11) / 1e3 + (30 - 1) / 1e3 + 6 / 1e3)
    assert k1 == {"count": 1, "ms": pytest.approx(0.020), "host_ms": pytest.approx(0.010)}
    assert set(s["spans"]) == {"ca3d.frame", "ca3d.k1"}
    # Idle as trace_arith computes it: the window 5-90 less the device's union.
    t = trace_arith.summarize(_trace())
    assert s["window_ms"] == pytest.approx(t["window_ms"]) == pytest.approx(0.085)
    assert s["idle_ms"] == pytest.approx(t["window_ms"] - t["busy_ms"]) == pytest.approx(0.035)
    # 15-25 in K1 and 50-70 in the second frame; 45-50 outside the main
    # thread's spans (the other thread's frame does not count).
    assert s["idle_in_spans_ms"] == pytest.approx(0.030)
    assert s["idle_outside_spans_ms"] == pytest.approx(0.005)
    assert [(g["ms"], g["span"]) for g in s["gaps"]] == [
        (pytest.approx(0.025), None), (pytest.approx(0.010), "ca3d.k1")]


def test_without_device_events_nothing_is_idle():
    s = span_arith.summarize([e for e in _trace() if e["cat"] not in trace_arith.DEVICE_CATS])
    assert s["window_ms"] == 0 and s["idle_ms"] == 0 and s["idle_in_spans_ms"] == 0
    assert s["spans"]["ca3d.frame"]["count"] == 3


def _ctx(summary=None, frames=2):
    summary = summary or trace_arith.summarize(_trace(), frames=frames, top=100)
    return Context(summary, frames, {"grid_size": 256, "width": 1920, "height": 1080}, None)


def test_the_readers_find_nothing_without_a_live_profiler(monkeypatch):
    ctx = _ctx()
    assert program.spans() is None
    assert span_host_ms.read(ctx, {"span": "ca3d.frame"}) is None
    assert idle_program.read(ctx, {}) is None
    monkeypatch.setattr(program, "counts", lambda: None)
    assert lane_use.read(ctx, {}) is None
    spec = {"kernels": ["render_kernel"], "counter": "occlusion_lanes"}
    assert ns_per_lane.read(ctx, spec) is None


def test_the_counter_readers(monkeypatch):
    ctx = _ctx()
    monkeypatch.setattr(program, "counts",
                        lambda: {"occlusion_lanes": 4000, "occlusion_lanes_read": 3000})
    assert lane_use.read(ctx, {}) == pytest.approx(75.0)
    spec = {"kernels": ["render_kernel"], "counter": "occlusion_lanes"}
    assert ns_per_lane.read(ctx, spec) == pytest.approx(30e-6 * 1e9 / 4000)
    assert ns_per_lane.read(ctx, dict(spec, kernels=["shadow_sweep_kernel"])) is None


def _profiled():
    """A profiler (its ``with`` block ended) over spans of the program's names."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    with torch.profiler.profile(activities=acts) as prof:
        x = torch.ones(1 << 16, device=dev)
        for _ in range(3):
            with torch.profiler.record_function("ca3d.frame"):
                with torch.profiler.record_function("ca3d.k1"):
                    x = x * 2 + 1
                x = x.sqrt()
        if dev == "cuda":
            torch.cuda.synchronize()
    return prof


def test_a_live_profilers_events_are_its_chrome_trace(tmp_path):
    prof = _profiled()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    want = span_arith.summarize(str(path))
    got = span_arith.summarize(program.trace_events(prof))
    assert set(got["spans"]) == set(want["spans"]) == {"ca3d.frame", "ca3d.k1"}
    for name, row in want["spans"].items():
        assert got["spans"][name]["count"] == row["count"] == 3
        assert got["spans"][name]["ms"] == pytest.approx(row["ms"], abs=1e-3)
        assert got["spans"][name]["host_ms"] == pytest.approx(row["host_ms"], abs=1e-3)
    for key in ("window_ms", "idle_ms", "idle_in_spans_ms"):
        assert got[key] == pytest.approx(want[key], abs=1e-3)
    with open(path) as f:
        cats = {e.get("cat") for e in json.load(f)["traceEvents"] if e.get("ph") == "X"}
    assert {e["cat"] for e in program.trace_events(prof)} <= cats
    # A reader called while the profiler is live in a caller's frame finds it.
    ctx = _ctx(frames=3)
    assert span_host_ms.read(ctx, {"span": "ca3d.frame"}) == pytest.approx(
        got["spans"]["ca3d.frame"]["host_ms"] / 3)
