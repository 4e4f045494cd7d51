"""The reference the check compares with: the plain CA against an
independent NumPy count, the frozen frame against the port's plain twins,
and the check refusing the control and planted faults of the timed path."""

import numpy as np
import pytest
import torch

import harness
from _small import SEED, SMALL, run
from reference import ca, frozen

RULE = ca.rule_of(harness.load_cell("clustered256.pinned").config["engine"])


def numpy_step(cells: np.ndarray) -> np.ndarray:
    """B1,3/S0-6 over the six face neighbours, the far edge reading the first
    row or plane of its axis and the near edge reading dead."""
    n = cells.shape[0]
    pad = np.zeros((n + 2,) * 3, np.int32)
    pad[1:-1, 1:-1, 1:-1] = cells
    pad[-1, 1:-1, 1:-1] = cells[0]          # z = n reads z = 0
    pad[1:-1, -1, 1:-1] = cells[:, 0]       # y = n reads y = 0
    pad[1:-1, 1:-1, -1] = cells[:, :, 0]    # x = n reads x = 0
    c = pad[1:-1, 1:-1, 1:-1]
    count = (pad[2:, 1:-1, 1:-1] + pad[:-2, 1:-1, 1:-1] + pad[1:-1, 2:, 1:-1]
             + pad[1:-1, :-2, 1:-1] + pad[1:-1, 1:-1, 2:] + pad[1:-1, 1:-1, :-2])
    return np.where(c == 1, 1, np.isin(count, [1, 3])).astype(np.uint8)


@pytest.mark.parametrize("gens", [1, 12, 40])
def test_plain_ca_matches_numpy_count(gens):
    cells = ca.seed_block(32, SEED)
    got = torch.from_numpy(cells)
    for _ in range(gens):
        cells = numpy_step(cells)
        got = ca.step(got, RULE)
    assert np.array_equal(got.numpy(), cells)
    assert cells.sum() > 0


def test_packing_and_seed_match_the_port():
    from cellularautomatons3d_tpu_torch.ops import packing
    assert np.array_equal(ca.seed_centre(64), packing.seed_center(64))
    cells = ca.seed_block(64, SEED)
    assert np.array_equal(cells, packing.seed_random_block(64, rng=SEED))
    want = packing.pack_grid(cells).view(np.int32)
    assert np.array_equal(ca.pack(torch.from_numpy(cells)).numpy(), want)


def _scene(n=32, gens=20):
    return ca.scenes(ca.seed_block(n, SEED), RULE, gens, 0, "cpu")[0]


def _params(e, view, prev_view, t_ms=50.0):
    return harness.render_params(e, view, prev_view, t_ms)


@pytest.mark.parametrize("cfg", ["clustered-256", "pbr-256"])
def test_frozen_frame_equals_the_port_twins(cfg):
    """K1, the lighting passes and the moved composition of the frozen copy
    against the port's plain twins, bit for bit, at 32³ / 64×32."""
    from cellularautomatons3d_tpu_torch.render import render_fast, render_slab, renderer_fast
    from cellularautomatons3d_tpu_torch.render.renderer import RenderParams
    from cellularautomatons3d_tpu_torch.ops.occupancy import coarse_occupancy, occupied_box
    config = harness.load_json(harness.HERE / "configs" / f"{cfg}.json")
    e = harness.engine_settings(config, {"scene": "random"}, SEED, SMALL)
    vol = _scene()
    view, prev = harness.orbit_pose(37.0, 0.75, 0.0), harness.orbit_pose(36.0, 0.75, 0.0)
    p = _params(e, view, prev)
    cam = frozen.cam_vec(p, 64, 32)
    light = harness._lighting(e)
    tr = frozen.k1_trace(vol, cam, grid_size=32, width=64, height=32, shadow=light is None)
    rgb, depth, idx = render_fast.raytrace(vol, None, cam, grid_size=32, width=64, height=32,
                                           shadow=light is None)
    assert torch.equal(idx, tr.idx) and torch.equal(depth, tr.depth)
    assert torch.equal(rgb, tr.rgb)
    if light is None:
        mine = frozen.with_emissive(cam, tr)
        theirs = torch.where((idx >= 0)[..., None], rgb + torch.tensor(
            cam[frozen.P_EMIS:frozen.P_EMIS + 3] * cam[frozen.P_EMISS]), rgb)
    else:
        mine = frozen.lighting_passes(cam, tr.idx, tr.depth, vol, light, tr.rgb, grid_size=32,
                                      width=64, height=32)
        coarse = coarse_occupancy(vol)
        prepped = render_slab.Prepped(vol, coarse, occupied_box(coarse, 32))
        theirs = render_slab.lighting_passes(
            cam, idx, depth, prepped,
            render_slab.Lighting(soft_k=light.soft_k, gi=True, bounces=light.bounces),
            rgb=rgb, grid_size=32, width=64, height=32)
    assert torch.equal(mine, theirs)
    hist = (torch.rand(32, 64, 3, generator=torch.Generator().manual_seed(1)).half(),
            torch.where(torch.rand(32, 64) < 0.5, idx, -1).to(torch.int32))
    rp = RenderParams(view_mat=p.view_mat, prev_view_mat=prev, prev_proj_view=p.prev_proj_view,
                      elapsed_time=p.elapsed_time, cell_size=p.cell_size,
                      temporal_alpha=p.temporal_alpha, gamma=p.gamma, roughness=p.roughness,
                      base_reflectivity=p.base_reflectivity, material_color=p.material_color,
                      light_pos=p.light_pos, light_magnitude=p.light_magnitude,
                      show_depth_overlay=p.show_depth_overlay, light_radius=p.light_radius,
                      emissive_color=p.emissive_color, emissive_strength=p.emissive_strength)
    for static in (False, True):
        got = frozen.compose_frame(hist[0], hist[1], mine, depth, idx, p, 64, 32, static)
        want = renderer_fast.compose_frame(renderer_fast.FastHistory(*hist), theirs, depth, idx,
                                           rp, 64, 32, camera_static=static)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_frozen_k1_compose_equals_the_port():
    from cellularautomatons3d_tpu_torch.render import render_fast
    cell = harness.load_cell("clustered256.pinned")
    e = harness.engine_settings(cell.config, cell.mix, SEED, SMALL)
    vol = _scene()
    p = _params(e, harness.orbit_pose(0.0, 0.75, 0.0), None)
    cam = frozen.cam_vec(p, 64, 32)
    tr = frozen.k1_trace(vol, cam, grid_size=32, width=64, height=32)
    prev = (torch.rand(32, 64, 3, generator=torch.Generator().manual_seed(2)),
            torch.where(torch.rand(32, 64) < 0.5, tr.idx, -1).to(torch.int32))
    got = frozen.k1_compose(cam, tr, *prev)
    want = render_fast.raytrace(vol, None, cam, prev, grid_size=32, width=64, height=32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[3])


CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    rec, extra = run(cell)
    assert rec["correct"], extra["readings"]
    assert len(extra["readings"]) == 2


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference in bfloat16, one precision below the configuration's,
    in the program's place."""
    rec, extra = run(cell, control=torch.bfloat16)
    assert not rec["correct"], extra["readings"]


def _after(n, fault, real):
    """``fault`` in place of ``real`` from its ``n``-th call on."""
    calls = [0]

    def f(*a, **kw):
        calls[0] += 1
        return fault(*a, **kw) if calls[0] > n else real(*a, **kw)
    return f


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_returns_its_state_unchanged_is_caught(cell, monkeypatch):
    from cellularautomatons3d_tpu_torch import engine
    from cellularautomatons3d_tpu_torch.render import renderer_fast
    start = SMALL["mix"]["start_generation"]
    for mod in (engine, renderer_fast):
        monkeypatch.setattr(mod, "step_packed",
                            _after(start if mod is engine else 0, lambda st, spec: st,
                                   mod.step_packed))
    rec, extra = run(cell)
    assert not rec["correct"], extra["readings"]


def _altered(real, rows=None):
    """A frame path's output with one pixel's colour changed, or with the
    rows ``rows`` left as the history had them (half of the frame not
    rendered)."""
    def f(*a, **kw):
        out = list(real(*a, **kw))
        frame = out[0].clone()
        if rows is None:
            frame[3, 5] = frame[3, 5] + 0.01
        else:
            frame[rows] = 0.0
        out[0] = frame
        return tuple(out)
    return f


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("rows", [None, slice(16, None)], ids=["one_pixel", "half_frame"])
def test_an_altered_answer_is_caught(cell, rows, monkeypatch):
    from cellularautomatons3d_tpu_torch.render import renderer_fast
    name = "raytrace_tiles" if harness.load_cell(cell).mix["loop"] == "fused" \
        else "compose_frame"
    monkeypatch.setattr(renderer_fast, name, _altered(getattr(renderer_fast, name), rows))
    rec, extra = run(cell)
    assert not rec["correct"], extra["readings"]
