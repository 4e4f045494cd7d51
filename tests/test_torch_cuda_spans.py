"""The work counters and the spans on the card (``utils.profiling``).

Marked ``cuda`` and skipped without a CUDA device; imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_spans.py

* The occlusion kernel's and the shade kernel's counters, read around one
  lighting frame traced by ``torch.profiler``, equal the plain twins' counts
  on the same frame and the counts taken from its masks and states (a
  deeper frame's K2 traces only the lanes the shade reads), for the
  forms the frames run: K1's one-bounce frame, composed and not, the
  temporal mode, two bounces, the sliced frame's.  Untraced, nothing counts.
* K2's count, in either of its kernels, is the lanes it traces (after its
  gate of the last GI level in the strip kernel).
* Every launch of a traced tick with two-bounce lighting lies inside the
  span of its layer, and every launch of a traced fused call inside its
  frame's ``ca3d.frame``, the only span the fused loop's frames open (each
  loop traced in a process of its own).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.render import render_fast as rf
from cellularautomatons3d_tpu_torch.render import render_slab as rs
from cellularautomatons3d_tpu_torch.utils import mat4, profiling

pytestmark = pytest.mark.cuda

W, H = 128, 64
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _hits(device, n, light):
    """A random volume's primary hits as the lighting passes take them:
    (prepped, cam, K1's rgb or None, t, idx, kw), K1 up to 256³ (its hard
    shadow without soft shadows), K4 above."""
    rng = np.random.default_rng(n)
    dense = (rng.random((n, n, n)) < (0.05 if n <= 64 else 0.003)).astype(np.uint8)
    vol = ct.from_reference(ct.pack_grid(dense), device)
    prepped = rs.prep_volume(vol)
    cam = rf.pack_cam(mat4.initial_view_matrix(), W, H, (0.721, 1.0, 1.0), 5.0, 0.85, 0.29,
                      (0.17, 0.2, 0.3), (0.0,) * 3, light_radius=0.08, elapsed_time=0.37,
                      emissive_color=(0.02, 0.03, 0.04), emissive_strength=0.5)
    kw = dict(grid_size=n, width=W, height=H)
    if n > 256:
        t, idx, *_ = rs.primary_sweep_cuda(vol, prepped.coarse, prepped.box, cam, **kw)
        return prepped, cam, None, t, idx, kw
    soft = light.soft_k is not None and light.soft_k > 1
    rgb, t, idx = rf.raytrace_cuda(vol, prepped.coarse, cam, shadow=not soft, **kw)
    return prepped, cam, rgb, t, idx, kw


def _delta(device, thunk):
    """The work counters of ``device`` added while ``thunk()`` runs under a
    profiler."""
    before = profiling.work_counts(device)
    with profiling.profile_trace():
        thunk()
    after = profiling.work_counts(device)
    return {k: after[k] - before[k] for k in after}


FRAMES = {
    "full_quality": (rs.Lighting(soft_k=4, gi=True), 64, False),
    "full_quality_composed": (rs.Lighting(soft_k=4, gi=True), 64, True),
    "temporal_composed": (rs.Lighting(soft_k=4, jitter_k=1, gi=True, gi_slot=3), 64, True),
    "hard_gi": (rs.Lighting(soft_k=1, gi=True), 64, False),
    "two_bounces": (rs.Lighting(soft_k=4, gi=True, bounces=2), 64, False),
    "three_bounces": (rs.Lighting(soft_k=1, gi=True, bounces=3), 64, False),
    "sliced_full_quality": (rs.Lighting(soft_k=4, gi=True), 320, False),
    "sliced_two_bounces": (rs.Lighting(soft_k=4, gi=True, bounces=2), 320, False),
    "sliced_hard": (rs.Lighting(soft_k=1), 320, False),
}


@pytest.mark.parametrize("name", list(FRAMES))
def test_the_kernels_count_as_the_twins(cuda, name):
    light, n, composed = FRAMES[name]
    prepped, cam, rgb, t, idx, kw = _hits(cuda, n, light)
    hist = None
    if composed:
        g = torch.Generator(cuda).manual_seed(3)
        hist = (torch.rand((H, W, 3), device=cuda, generator=g),
                torch.where(torch.rand((H, W), device=cuda, generator=g) < 0.7, idx, -1))
    skw = dict(rgb=rgb, history=hist, **kw)
    card = _delta(cuda, lambda: rs.lighting_passes(cam, idx, t, prepped, light, **skw))

    # The twins on the same frame: the stacked queries (their masks are the
    # kernel's), the GI states (K3 and the level launch, which count
    # nothing), the plain K2 and the plain shade.
    ops = rs.lighting_queries_stacked(cam, idx, t, light, **kw)
    states = rs.gi_states(cam, idx, t, ops, prepped, light, **kw) if light.n_slots else None
    deep = light.bounces > 1
    gate = dict(states=states, q_gate=light.n_soft + rs.Lighting.level_span(light.bounces)[0]
                ) if deep else {}

    def twins():
        flags = rs.shadow_sweep(prepped.vol, *ops, grid_size=n, cell_half=rs._cell_half(cam, n),
                                **gate)
        rs.lighting_shade(cam, idx, t, flags, states, light, **skw)

    twin = _delta("cpu", twins)
    active, n_soft = ops[3], light.n_soft
    read = int(active[:n_soft].sum())
    if states is not None:
        read += int((active[n_soft:] & (states == 1)).sum())
    traced = int(rs.gated_lanes(active, **gate).sum())
    assert card == twin == {"occlusion_lanes": traced, "occlusion_lanes_read": read}
    assert 0 < card["occlusion_lanes_read"] <= card["occlusion_lanes"]
    if deep:
        assert card["occlusion_lanes_read"] == card["occlusion_lanes"]  # K2 traces what is read
    # Untraced, the same frame counts nothing.
    before = profiling.work_counts(cuda)
    rs.lighting_passes(cam, idx, t, prepped, light, **skw)
    assert profiling.work_counts(cuda) == before


# The span each kernel family's launches lie in.
LAYER_OF = {
    "ca_step_kernel": "ca3d.step",
    "coarse_occupancy_kernel": "ca3d.occupancy",
    "render_kernel": "ca3d.k1",
    "lighting_queries_kernel": "ca3d.lighting.queries",
    "lighting_level_kernel": "ca3d.lighting.states",
    "cell_state_kernel": "ca3d.lighting.states",
    "shadow_sweep_kernel": "ca3d.lighting.occlusion",
    "lighting_shade_kernel": "ca3d.lighting.shade",
    "compose_kernel": "ca3d.compose",
}
# (Engine settings, the loop, whether its frames open the layers' spans).
LOOPS = {
    "tick": (dict(soft_shadow_samples=4, indirect_lighting=True, light_radius=0.08,
                  indirect_bounces=2), lambda eng: [eng.tick() for _ in range(3)], True),
    "fused": (dict(), lambda eng: eng.run_fused(4, reset_every=2), False),
}


def _trace_loop(loop, out_dir):
    """Run the loop once, then trace its second run to ``out_dir/trace.json``."""
    config, run, _ = LOOPS[loop]
    eng = ct.Engine(grid_size=64, width=W, height=H, device=torch.device("cuda", 0), **config)
    eng.step(20)
    run(eng)
    with profiling.profile_trace(str(out_dir)):
        run(eng)


@pytest.mark.parametrize("loop", list(LOOPS))
def test_every_launch_lies_in_its_layers_span(cuda, loop, tmp_path):
    # A fresh process makes the trace: the profiler sessions that earlier
    # tests opened in this one can leave a later trace short of a kernel
    # family's events.
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, __file__, loop, str(tmp_path)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    _, _, layers = LOOPS[loop]
    with open(tmp_path / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("ca3d.")]
    seen = set()
    for k in (e for e in events if e.get("cat") == "kernel"):
        fam = next((f for f in LAYER_OF if f in k["name"]), None)
        if fam is None:
            continue  # torch's own kernels (the fused call's fill and f16 cast)
        call = launch[k["args"]["correlation"]]
        t = float(call["ts"])
        open_ = [s for s in spans if s["tid"] == call["tid"]
                 and float(s["ts"]) <= t <= float(s["ts"]) + float(s["dur"])]
        inner = max(open_, key=lambda s: (float(s["ts"]), -float(s["dur"])), default=None)
        want = LAYER_OF[fam] if layers else "ca3d.frame"
        assert inner is not None and inner["name"] == want, (k["name"], inner)
        assert any(s["name"] == "ca3d.frame" for s in open_)
        seen.add(fam)
    want = {"ca_step_kernel", "coarse_occupancy_kernel", "render_kernel"}
    if loop == "tick":
        want |= {"lighting_queries_kernel", "lighting_level_kernel", "cell_state_kernel",
                 "shadow_sweep_kernel", "lighting_shade_kernel", "compose_kernel"}
    assert seen == want


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("tiles", [1, 8])
def test_k2_counts_its_traced_lanes_in_either_form(cuda, tiles, ragged):
    """K2 adds the lanes it traces to ``occlusion_lanes`` as the twin counts
    them: the tile kernel (a block a tile) its active lanes, the strip
    kernel (8 tiles a block) with the last query rows gated by states the
    lanes left after the gate; on the whole frame (16-byte rows) and on a
    ragged 100×37 window of it."""
    light = rs.Lighting(soft_k=4, gi=True, bounces=2)
    prepped, cam, rgb, t, idx, kw = _hits(cuda, 64, light)
    ops = rs.lighting_queries_stacked(cam, idx, t, light, **kw)
    states = rs.gi_states(cam, idx, t, ops, prepped, light, **kw)
    h, w = (37, 100) if ragged else (H, W)
    window = tuple(op[..., :h, :w].contiguous() for op in (*ops, states))
    gate = {}
    if tiles == 8:
        gate = dict(states=window[4], q_gate=light.n_soft + rs.Lighting.level_span(2)[0])
    k2 = dict(grid_size=64, cell_half=rs._cell_half(cam, 64), **gate)
    card = _delta(cuda, lambda: rs.shadow_sweep_cuda(prepped.vol, prepped.coarse, prepped.box,
                                                     *window[:4], _tiles=tiles, **k2))
    twin = _delta("cpu", lambda: rs.shadow_sweep(prepped.vol, *window[:4], **k2))
    traced = int(rs.gated_lanes(window[3], **gate).sum())
    assert card["occlusion_lanes"] == twin["occlusion_lanes"] == traced
    assert 0 < traced <= int(window[3].sum())
    if gate:
        assert traced < int(window[3].sum())  # the gate took dead neighbours' lanes


if __name__ == "__main__":
    _trace_loop(*sys.argv[1:])
