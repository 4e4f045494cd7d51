"""The port's attribution tools (``cellularautomatons3d_tpu_torch.tools``) on
the CPU: the trace summary on a hand-written Chrome trace whose numbers are
known and on a real CPU ``torch.profiler`` trace, each tool's ``--device cpu
--small`` form, the tools' scenes against the JAX tools' (the JAX package's
``make_multi_step`` under XLA on the CPU, no Pallas; ``pack_cam``), no JAX
import in any tool, a default device that raises without a card, and K4's
and K2's column-skip switch out of reach on the CPU.
"""

import json
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cellularautomatons3d_tpu as ca
from cellularautomatons3d_tpu.ops.loop import make_multi_step as jax_multi_step
from cellularautomatons3d_tpu.render import render_fast as jax_rf
from cellularautomatons3d_tpu.utils import mat4 as jax_mat4
from cellularautomatons3d_tpu_torch.ops.occupancy import coarse_occupancy, occupied_box
from cellularautomatons3d_tpu_torch.render import render_fast, render_slab
from cellularautomatons3d_tpu_torch.tools import (
    bench_512_ablate, bench_dense, bench_scale, common, profile_frame, profile_gi,
    profile_trace, trace_summary,
)
from cellularautomatons3d_tpu_torch.utils.profiling import profile_trace as trace_block

TOOLS = ("profile_trace", "trace_summary", "profile_gi", "profile_frame", "bench_dense",
         "bench_scale", "bench_512_ablate")
DEVICE_TOOLS = [t for t in TOOLS if t != "trace_summary"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's small torch ops: the suite runs
    several workers (restored after the file)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# A trace with known numbers (times in µs): thread 1 launches k1 from
# aten::a inside the range "frame", then k2 and k3 from aten::b inside the
# nested range "part".  Thread 2 runs aten::other across the first gap,
# which the gap must not report: only the launching thread counts.
HAND_TRACE = {"traceEvents": [
    {"ph": "X", "cat": "user_annotation", "name": "frame", "pid": 1, "tid": 1, "ts": 0, "dur": 100,
     "args": {"External id": 1}},
    {"ph": "X", "cat": "cpu_op", "name": "aten::a", "pid": 1, "tid": 1, "ts": 5, "dur": 10,
     "args": {"External id": 2}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1, "ts": 8,
     "dur": 2, "args": {"correlation": 11}},
    {"ph": "X", "cat": "user_annotation", "name": "part", "pid": 1, "tid": 1, "ts": 22, "dur": 40,
     "args": {"External id": 3}},
    {"ph": "X", "cat": "cpu_op", "name": "aten::b", "pid": 1, "tid": 1, "ts": 25, "dur": 35,
     "args": {"External id": 4}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1, "ts": 55,
     "dur": 2, "args": {"correlation": 12}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1, "ts": 58,
     "dur": 1, "args": {"correlation": 13}},
    {"ph": "X", "cat": "cpu_op", "name": "aten::other", "pid": 1, "tid": 2, "ts": 28, "dur": 30,
     "args": {"External id": 5}},
    {"ph": "X", "cat": "kernel", "name": "k1", "pid": 0, "tid": 7, "ts": 20, "dur": 10,
     "args": {"correlation": 11, "stream": 7}},
    {"ph": "X", "cat": "kernel", "name": "k2", "pid": 0, "tid": 7, "ts": 70, "dur": 30,
     "args": {"correlation": 12, "stream": 7}},
    {"ph": "X", "cat": "kernel", "name": "k3", "pid": 0, "tid": 7, "ts": 105, "dur": 15,
     "args": {"correlation": 13, "stream": 7}},
    {"ph": "i", "name": "Record Window End", "pid": 1, "tid": 1, "ts": 120, "s": "g"},
]}


def test_kernels_between_counts_what_runs_between_two_kernels():
    """The device events between each ``first`` kernel and the next ``last``
    one, in start order: a lighting frame's kernels between K1 and the shade
    kernel, a stray torch kernel counted, nothing outside the pairs."""
    def kernel(name, ts):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": 1}

    names = ["elementwise_a", "render_kernel", "lighting_queries_kernel", "shadow_sweep_kernel",
             "elementwise_b", "cell_state_kernel", "lighting_shade_kernel", "elementwise_c",
             "render_kernel", "lighting_queries_kernel", "lighting_shade_kernel"]
    events = [kernel(n, 10 * i) for i, n in enumerate(names)][::-1]  # start order, not list order
    events.append({"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 35, "dur": 1})
    got = trace_summary.kernels_between(events, "render_kernel", "lighting_shade_kernel")
    assert got == {"lighting_queries_kernel": 2, "shadow_sweep_kernel": 1, "elementwise_b": 1,
                   "cell_state_kernel": 1}


def test_trace_summary_hand_written(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(HAND_TRACE))
    s = trace_summary.summarize(str(path), frames=3, gaps=5)
    # The window runs from k1's start (20) to k3's end (120); the host's
    # 20 µs before k1 are the lead.
    assert s["window_ms"] == pytest.approx(0.1)
    assert s["lead_ms"] == pytest.approx(0.02)
    assert s["busy_ms"] == pytest.approx(0.055)
    assert s["busy_share"] == pytest.approx(0.55)
    assert s["idle_share"] == pytest.approx(0.45)
    assert s["launches_by_name"] == {"k1": 1, "k2": 1, "k3": 1}
    assert s["launches_per_frame"] == 1.0
    assert [(k["name"], k["launches"]) for k in s["kernels"]] == [("k2", 1), ("k3", 1), ("k1", 1)]
    assert s["kernels"][0]["device_ms_per_frame"] == pytest.approx(0.01)
    # The two idle stretches, longest first: 30-70 (aten::b open on the
    # launching thread at 30, inside "part"), then 100-105 (the range
    # "frame" has ended at 100: no host op is open).
    assert [(round(g["start_ms"], 6), round(g["ms"], 6)) for g in s["gaps"]] == [
        (0.01, 0.04), (0.08, 0.005)]
    assert [g["host_op"] for g in s["gaps"]] == ["aten::b", None]
    assert s["gaps"][0]["host_stack"] == ["frame", "part", "aten::b"]
    assert s["gaps"][1]["host_stack"] == []
    assert [g["next"] for g in s["gaps"]] == ["k2", "k3"]
    ranges = trace_summary.by_range(str(path))
    assert ranges["frame"]["kernels"] == {"k1": [pytest.approx(0.01), 1]}
    assert ranges["part"]["kernels"] == {"k2": [pytest.approx(0.03), 1],
                                         "k3": [pytest.approx(0.015), 1]}
    assert ranges["part"]["wall_ms"] == pytest.approx(0.04)
    # Named ranges alone: "part"'s kernels go to "frame", open around it.
    ranges = trace_summary.by_range(str(path), names={"frame"})
    assert ranges["frame"]["kernels"] == {"k1": [pytest.approx(0.01), 1],
                                          "k2": [pytest.approx(0.03), 1],
                                          "k3": [pytest.approx(0.015), 1]}
    assert ranges["part"]["kernels"] == {}
    assert trace_summary.main([str(path), "--frames", "3"])["busy_ms"] == pytest.approx(0.055)


def test_trace_summary_cpu_profile(tmp_path):
    """A real torch.profiler trace of a 32³ frame on the CPU: host ops and
    ranges, no device events."""
    vol = common.scene(32, 80, "cpu")
    cam = common.cam(64, 32)
    with trace_block(str(tmp_path)):
        with torch.profiler.record_function("frame"):
            render_fast.raytrace_tiles(vol, coarse_occupancy(vol), cam, grid_size=32,
                                       width=64, height=32)
    s = trace_summary.summarize(str(tmp_path / "trace.json"))
    assert s["device_events"] == 0 and s["kernels"] == [] and s["busy_ms"] == 0.0
    assert s["idle_share"] == 1.0 and s["window_ms"] > 0.0
    ranges = trace_summary.by_range(str(tmp_path / "trace.json"))
    assert ranges["frame"]["occurrences"] == 1 and ranges["frame"]["launches"] == 0


def small_args(tool, tmp_path):
    small = ["--device", "cpu", "--small", "--reps", "1"]
    return {
        "profile_trace": small + ["--frames", "2", "--out", str(tmp_path / "t")],
        "profile_gi": small + ["--calls", "1", "--out", str(tmp_path / "gi")],
        "profile_frame": small + ["--calls", "1"],
        "bench_dense": small + ["230", "2"],
        "bench_scale": small + ["--frames", "1"],
        "bench_512_ablate": small + ["1", "--calls", "1"],
    }[tool]


MODULES = {"profile_trace": profile_trace, "trace_summary": trace_summary,
           "profile_gi": profile_gi, "profile_frame": profile_frame, "bench_dense": bench_dense,
           "bench_scale": bench_scale, "bench_512_ablate": bench_512_ablate}
LINES = {"profile_trace": 1, "trace_summary": 1, "profile_gi": 9, "profile_frame": 5,
         "bench_dense": 1, "bench_scale": 5, "bench_512_ablate": 3}


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_small_lines(tool, tmp_path, capsys):
    """Each tool's test-size form prints its JSON lines with their keys."""
    if tool == "trace_summary":
        path = tmp_path / "trace.json"
        path.write_text(json.dumps(HAND_TRACE))
        argv = [str(path)]
    else:
        argv = small_args(tool, tmp_path)
    launched = (render_slab.primary_sweep_cuda.launches, render_slab.shadow_sweep_cuda.launches)
    MODULES[tool].main(argv)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(lines) == LINES[tool]
    keys = getattr(MODULES[tool], "KEYS", ("busy_ms", "idle_share", "kernels", "gaps"))
    for rec in lines:
        assert rec["tool"] == tool
        assert set(keys) <= set(rec), set(keys) - set(rec)
        if tool != "trace_summary":
            assert rec["device"] == "cpu" and rec["card"] is None and rec["clock"] == "host"
    # The CPU runs the plain twins: no kernel wrapper was called.
    assert (render_slab.primary_sweep_cuda.launches,
            render_slab.shadow_sweep_cuda.launches) == launched


@pytest.mark.parametrize("what", ["gen-80", "gen-230", "pack_cam"])
def test_tool_scenes_equal_jax(what):
    """The tools' scene and camera are the JAX tools' at 32³ / 64×32."""
    if what == "pack_cam":
        want = jax_rf.pack_cam(jax_mat4.initial_view_matrix(), 64, 32, (0.721, 1.0, 1.0), 5.0,
                               0.85, 0.29, (0.17, 0.17, 0.17), (0.0, 0.0, 0.0),
                               elapsed_time=0.1)
        np.testing.assert_array_equal(common.cam(64, 32), np.asarray(want))
        return
    gen = int(what.split("-")[1])
    spec = ca.AutomatonSpec.from_config(ca.EngineConfig(grid_size=32))
    want = np.asarray(jax_multi_step(spec, gen)(jnp.asarray(ca.pack_grid(ca.seed_center(32)))))
    got = common.scene(32, gen, "cpu").numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    assert common.population(common.scene(32, gen, "cpu")) == int(np.unpackbits(
        want.view(np.uint8)).sum())


def test_tools_import_no_jax():
    """No tool module imports JAX (an import with JAX blocked)."""
    code = ("import sys; sys.modules['jax'] = None\n"
            + "".join(f"import cellularautomatons3d_tpu_torch.tools.{t}\n" for t in TOOLS)
            + "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("tool", DEVICE_TOOLS)
def test_tool_default_device_raises(tool):
    """A tool runs on the card by default, and without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        MODULES[tool].main([])
    with pytest.raises(ValueError, match="--small"):
        MODULES[tool].main(["--device", "cpu"])


def test_column_skip_switch_needs_the_card():
    """K4's and K2's column_skip=False, as K1's, exists only in the kernels:
    on CPU tensors the wrappers raise and the plain twins have no skip."""
    n, w, h = 64, 64, 32
    vol = common.scene(n, 160, "cpu")
    coarse = coarse_occupancy(vol)
    box = occupied_box(coarse, n)
    cam = common.cam(w, h)
    with pytest.raises(ValueError, match="CUDA"):
        render_slab.primary_sweep_cuda(vol, coarse, box, cam, grid_size=n, width=w, height=h,
                                       column_skip=False)
    t, idx = render_slab.primary_sweep(vol, cam, grid_size=n, width=w, height=h)
    q, _, coords, found, _ = render_slab.hit_geometry(cam, idx, t, grid_size=n, width=w, height=h)
    light = torch.tensor([0.721, 1.0, 1.0])
    ops = render_slab.stack_occlusion_queries([(q, light, coords, found)], w, h)
    with pytest.raises(ValueError, match="CUDA"):
        render_slab.shadow_sweep_cuda(vol, coarse, box, *ops, grid_size=n, cell_half=0.01,
                                      column_skip=False)
    with pytest.raises(ValueError, match="CUDA"):
        render_fast.raytrace_cuda(vol, coarse, cam, grid_size=n, width=w, height=h,
                                  column_skip=False)
    assert render_slab.primary_sweep_cuda.noskip_launches == 0
    assert render_slab.shadow_sweep_cuda.noskip_launches == 0


def test_families_and_counters():
    """Kernel names of a trace map to the wrappers' counters by family."""
    names = {"void (anonymous namespace)::render_kernel<true, 0, false, 0>(unsigned int)": 3,
             "void (anonymous namespace)::ca_step_kernel<2, false, false>(int)": 2,
             "void (anonymous namespace)::age_masks_kernel(unsigned int const*)": 4,
             "void at::native::vectorized_elementwise_kernel<4>(int)": 9}
    assert common.families(names) == {"render_kernel": 3, "ca_step_kernel": 2,
                                      "age_masks_kernel": 4}
    with common.counted() as launched:
        render_fast.raytrace_cuda.launches += 2
        render_slab.cell_state_cuda.launches += 1
    render_fast.raytrace_cuda.launches -= 2
    render_slab.cell_state_cuda.launches -= 1
    assert launched == {"render_kernel": 2, "cell_state_kernel": 1}
