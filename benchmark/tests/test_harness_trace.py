"""The trace arithmetic on a synthetic Chrome trace, the per-layer readers
on its summary, and the trace's check against the launch counters."""

import pytest

import harness
import trace_arith


def _trace():
    """Two frames of a host thread launching three kernels each: device
    events at 0-10, 12-20, 30-40 and 50-60, 62-70, 80-90 µs (a copy
    overlapping the first), each with its launch."""
    ev = [{"ph": "X", "cat": "cpu_op", "name": "Engine.tick", "ts": 0.0, "dur": 100.0,
           "pid": 1, "tid": 1, "args": {"External id": 1}}]
    spans = [(0, 10, "ca_step_kernel<1>"), (12, 20, "coarse_occupancy_kernel<4>"),
             (30, 40, "render_kernel<0>"), (50, 60, "ca_step_kernel<1>"),
             (62, 70, "coarse_occupancy_kernel<4>"), (80, 90, "render_kernel<0>"),
             (2, 6, "Memcpy DtoD")]
    for k, (a, b, name) in enumerate(spans):
        cat = "gpu_memcpy" if name.startswith("Memcpy") else "kernel"
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": float(a), "dur": float(b - a),
                   "pid": 0, "tid": 7, "args": {"correlation": 100 + k}})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "ts": float(a) - 1.0 if a else 0.0, "dur": 0.5, "pid": 1, "tid": 1,
                   "args": {"correlation": 100 + k}})
    return ev


def test_summary_arithmetic():
    s = trace_arith.summarize(_trace(), frames=2, top=100, gaps=10)
    assert s["window_ms"] == pytest.approx(0.090)
    assert s["busy_ms"] == pytest.approx(0.056)        # the copy inside the first kernel
    assert s["idle_share"] == pytest.approx(34 / 90)
    assert s["device_events"] == 7 and s["launches_per_frame"] == 3.5
    by = {k["name"]: k for k in s["kernels"]}
    assert by["render_kernel<0>"]["device_ms"] == pytest.approx(0.020)
    assert by["ca_step_kernel<1>"]["launches"] == 2
    assert [round(g["ms"] * 1e3) for g in s["gaps"]] == [10, 10, 10, 2, 2]
    assert s["gaps"][0]["host_op"] == "Engine.tick"


def _ctx(peaks={"hbm_bytes_per_s": 3.35e12}):
    from readers import Context
    s = trace_arith.summarize(_trace(), frames=2, top=100, gaps=10)
    return Context(s, 2, {"grid_size": 256, "width": 1920, "height": 1080}, peaks)


def test_readers():
    from readers import ca_step_roofline, idle_share, k1_roofline, kernel_ms, launches
    ctx = _ctx()
    assert kernel_ms.read(ctx, {"kernels": ["render_kernel"]}) == pytest.approx(0.010)
    assert kernel_ms.read(ctx, {"kernels": ["shadow_sweep_kernel"]}) is None
    assert launches.read(ctx, {}) == 3.5
    assert idle_share.read(ctx, {}) == pytest.approx(100 * 34 / 90)
    want = 100 * 2 * (2 * 256**3 // 8) / 3.35e12 / 20e-6
    assert ca_step_roofline.read(ctx, {"kernels": ["ca_step_kernel"]}) == pytest.approx(want)
    want = 100 * 2 * (256**3 // 8 + 1920 * 1080 * 6) / 3.35e12 / 20e-6
    assert k1_roofline.read(ctx, {"kernels": ["render_kernel"]}) == pytest.approx(want)
    assert k1_roofline.read(_ctx(None), {"kernels": ["render_kernel"]}) is None


def test_per_layer_metrics_of_a_cell():
    cell = harness.load_cell("clustered256.pinned")
    ctx = _ctx()
    got = harness.per_layer_metrics(cell, ctx.summary, 2, ctx.engine, ctx.peaks)
    assert set(got) == {"launches_per_frame", "device_idle_share", "ca_step_ms",
                        "ca_step_roofline", "occupancy_ms", "k1_ms", "k1_roofline"}
    assert got["k1_ms"] == {"value": pytest.approx(0.010), "unit": "ms/frame"}


def test_a_trace_that_lost_launches_is_refused():
    names = {"render_kernel<0>": 10, "ca_step_kernel<1>": 10, "other": 3}
    assert harness.lost_launches(names, {"render_kernel": 10, "ca_step_kernel": 10}) == {}
    assert harness.lost_launches(names, {"render_kernel": 12, "compose_kernel": 1}) == {
        "render_kernel": (10, 12), "compose_kernel": (0, 1)}
