"""The port's spans and work counters on the CPU (``utils.profiling``).

* A ``torch.profiler`` trace of an ``Engine.tick`` with lighting, and of a
  ``run_fused`` call, holds the layers' ``ca3d.*`` spans, nested as
  ``utils/profiling.py`` lists them; the fused loop's frames of K1 alone hold
  only ``ca3d.frame``.
* With no profiler recording no span enters ``record_function`` (it is
  patched to raise) and :func:`profiling.span` is one shared no-op context.
* The plain twins' counters (``work_counts("cpu")``) on small lighting frames
  equal the counts taken directly from the queries' masks and the GI states:
  K2's lanes are the active lanes (a deeper frame's last level gated by
  its states), the shade's the hits' direct-shadow lanes and the live GI
  slots; lanes read ≤ lanes traced, and equal in a deeper frame.

tests/test_torch_cuda_spans.py holds the kernels' counters to these twins and
the launches to their spans on the card.
"""

import json

import pytest
import torch

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.ops.occupancy import occupancy_rebuild
from cellularautomatons3d_tpu_torch.render import render_slab as rs
from cellularautomatons3d_tpu_torch.render.render_fast import raytrace_tiles
from cellularautomatons3d_tpu_torch.render.renderer_fast import _cam_vec
from cellularautomatons3d_tpu_torch.utils import profiling

SMALL = dict(grid_size=32, width=64, height=32, device="cpu")
LIGHTING = dict(soft_shadow_samples=4, indirect_lighting=True, light_radius=0.08)


def _spans(log_dir, thunk):
    """The ``ca3d.*`` spans of a trace of ``thunk()``: (name, start, end)
    sorted by start, outermost first."""
    with profiling.profile_trace(str(log_dir)):
        thunk()
    with open(log_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
           if e.get("ph") == "X" and str(e.get("name", "")).startswith("ca3d.")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _parent(spans, child):
    """The innermost span that holds ``child``, or None."""
    name, a, b = child
    outer = [s for s in spans if s is not child and s[1] <= a and b <= s[2]
             and (s[1], -s[2]) < (a, -b)]
    return max(outer, key=lambda s: (s[1], -s[2]))[0] if outer else None


def _nesting(spans):
    """{span name: the set of its parents' names}."""
    out = {}
    for s in spans:
        out.setdefault(s[0], set()).add(_parent(spans, s))
    return out


def test_a_traced_tick_with_lighting_holds_the_layers_spans(tmp_path):
    eng = ct.Engine(**SMALL, **LIGHTING, indirect_bounces=2)
    eng.step(10)
    eng.tick()
    eng.tick()  # the third tick steps
    spans = _spans(tmp_path, eng.tick)
    assert _nesting(spans) == {
        "ca3d.tick": {None},
        "ca3d.frame": {"ca3d.tick"},
        "ca3d.occupancy": {"ca3d.frame"},
        "ca3d.k1": {"ca3d.frame"},
        "ca3d.lighting": {"ca3d.frame"},
        "ca3d.lighting.queries": {"ca3d.lighting"},
        "ca3d.lighting.states": {"ca3d.lighting"},
        "ca3d.lighting.occlusion": {"ca3d.lighting"},
        "ca3d.lighting.shade": {"ca3d.lighting"},
        "ca3d.compose": {"ca3d.frame"},
        "ca3d.step": {"ca3d.frame"},
    }
    names = [s[0] for s in spans]
    assert names.count("ca3d.frame") == 1 and names.count("ca3d.step") == 1
    # The frame's layers in their order: the rebuild, K1, the lighting, the
    # composition, then the tick's step.
    order = [n for n in names if n.count(".") == 1 and n not in ("ca3d.tick", "ca3d.frame")]
    assert order == ["ca3d.occupancy", "ca3d.k1", "ca3d.lighting", "ca3d.compose", "ca3d.step"]


def test_a_traced_fused_call_holds_only_the_frame_spans(tmp_path):
    eng = ct.Engine(**SMALL)
    eng.step(6)
    spans = _spans(tmp_path, lambda: eng.run_fused(3, reset_every=2))
    assert _nesting(spans) == {"ca3d.run_fused": {None}, "ca3d.frame": {"ca3d.run_fused"}}
    assert [s[0] for s in spans].count("ca3d.frame") == 3


def test_without_a_profiler_no_span_enters_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not profiling.recording()
    assert profiling.span("ca3d.frame") is profiling.span("ca3d.k1")
    before = profiling.work_counts("cpu")
    eng = ct.Engine(**SMALL, **LIGHTING, indirect_bounces=2)
    eng.step(8)
    for _ in range(3):
        eng.tick()
    fused = ct.Engine(**SMALL)
    fused.run_fused(2, reset_every=2)
    assert profiling.work_counts("cpu") == before  # nothing counts either


# The lighting modes: one bounce with soft shadows, the hard shadow with GI,
# the temporal mode's one sample and slot, two bounces.
LIGHTINGS = {
    "full_quality": rs.Lighting(soft_k=4, gi=True),
    "gi_temporal": rs.Lighting(soft_k=4, jitter_k=1, gi=True, gi_slot=2),
    "two_bounces": rs.Lighting(soft_k=4, gi=True, bounces=2),
    "hard_gi": rs.Lighting(soft_k=1, gi=True),
}


def _frame(light):
    """K1's unshadowed frame of a small scene and what the lighting passes
    take: (cam, rgb, t, idx, prepped, kw)."""
    eng = ct.Engine(**SMALL, **LIGHTING)
    eng.step(12)
    s = eng.render_static
    cam = _cam_vec(eng.render_params(), s.width, s.height)
    occ = occupancy_rebuild(eng.state, box=True)
    kw = dict(grid_size=s.grid_size, width=s.width, height=s.height)
    rgb, t, idx = raytrace_tiles(eng.state, occ.coarse, cam, shadow=light.soft_k == 1, **kw)
    return cam, rgb, t, idx, rs.Prepped(eng.state, occ.coarse, occ.box), kw


@pytest.mark.parametrize("name", list(LIGHTINGS))
def test_the_twins_count_the_lanes_of_their_masks_and_states(name):
    light = LIGHTINGS[name]
    cam, rgb, t, idx, prepped, kw = _frame(light)
    before = profiling.work_counts("cpu")
    with profiling.profile_trace():
        rs.lighting_passes(cam, idx, t, prepped, light, rgb=rgb, **kw)
    after = profiling.work_counts("cpu")
    got = {k: after[k] - before[k] for k in after}

    # The same frame's masks and states, outside a profiler: the lanes K2
    # traces (the active lanes, after the states gate a deeper frame's level
    # 1 and, inside K2, its last level), and the lanes the shade reads, each
    # hit's direct-shadow lanes and the live slots.
    ops = rs.lighting_queries_stacked(cam, idx, t, light, **kw)
    states = rs.gi_states(cam, idx, t, ops, prepped, light, **kw)
    active, n_soft = ops[3], light.n_soft
    hits = int((idx >= 0).sum())
    assert hits > 0 and int(active[:n_soft].sum()) == n_soft * hits
    deep = light.bounces > 1
    traced = active
    if deep:
        traced = rs.gated_lanes(active, states, n_soft + rs.Lighting.level_span(light.bounces)[0])
        assert int(traced.sum()) < int(active.sum())  # the gate took dead neighbours' lanes
    want = {"occlusion_lanes": int(traced.sum()),
            "occlusion_lanes_read": int(active[:n_soft].sum())
            + int((active[n_soft:] & (states == 1)).sum())}
    assert got == want
    assert 0 < got["occlusion_lanes_read"] <= got["occlusion_lanes"]
    if deep:
        assert got["occlusion_lanes_read"] == got["occlusion_lanes"]  # K2 traces what is read
    elif light.n_slots > 1:
        assert got["occlusion_lanes_read"] < got["occlusion_lanes"]  # dead neighbours' lanes
