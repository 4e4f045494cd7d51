"""The multi-bounce GI tree as the lighting kernels' level mode, on the CPU
(no JAX): the level-mode twins (``render_slab.lighting_level_stacked``, the
tree evaluation of ``lighting_shade``) against the port's recursion
``render_slab.indirect_bounce`` (JAX's ``indirect_bounce`` op for op, which
no frame path runs any more), bit for bit at 1, 2 and 3 bounces; the
frames of ``lighting_passes`` (K1's and the sliced one) against the same
frames composed from the recursion; the masks' gating by the neighbours'
states, and K2's gate of the last level by them (the flags the shade
reads and the frames unchanged); and the wrappers' refusals before the
kernel library loads.
``tests/test_torch_lighting_bounces.py`` holds the two-bounce
``trace_shaded`` to JAX's.

The plain K2 sweeps every plane for every lane (~30 s for a two-bounce
frame's 20 rows at 64×32 here), so most cases stand a cheap occlusion in
for it (:func:`hashed_occlusion`: a fixed function of each lane's start
and excluded cell, 0 on untraced lanes), which both sides take through
``render_slab.shadow_sweep`` (the gate's cases through its sweep,
``render_slab._occlusion``, so the twin's own gate runs); one case runs
the plain K2 on a 32×16 window.
"""

import numpy as np
import pytest
import torch

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch import kernels
from cellularautomatons3d_tpu_torch.ops.occupancy import occupancy_rebuild
from cellularautomatons3d_tpu_torch.render import render_slab as rs
from cellularautomatons3d_tpu_torch.render.render_fast import raytrace_tiles
from cellularautomatons3d_tpu_torch.utils import profiling

from _torch_lighting_scene import H, N, W, scene_cam

KW = dict(grid_size=N, width=W, height=H)


def scene(width=W, height=H):
    """A denser blob than the lighting scene's (40 % of a 20³ block), so
    every level of a 3-bounce tree has live neighbours: (cam, prepped, K1's
    unshadowed rgb, depth, idx)."""
    from cellularautomatons3d_tpu_torch.render.render_fast import P_WIN
    rng = np.random.default_rng(5)
    dense = np.zeros((N, N, N), np.uint8)
    dense[6:26, 6:26, 6:26] = rng.random((20, 20, 20)) < 0.4
    vol = ct.from_reference(ct.pack_grid(dense), device="cpu")
    cam = scene_cam()
    cam[P_WIN : P_WIN + 2] = (width, height)
    occ = occupancy_rebuild(vol, box=True)
    rgb, depth, idx = raytrace_tiles(vol, occ.coarse, cam, shadow=False, grid_size=N,
                                     width=width, height=height)
    return cam, rs.Prepped(vol, occ.coarse, occ.box), rgb, depth, idx


@pytest.fixture(scope="module")
def frame():
    return scene()


def hashed_occlusion(vol, start, target, excl, active, *, grid_size, cell_half, states=None,
                     q_gate=None):
    """A stand-in for the plain K2 with its contract: flags int32 [nq, H, W],
    1 on about a third of the traced lanes, as a fixed function of the
    lane's start and excluded cell; 0 on untraced lanes (inactive, or gated
    by ``states`` from row ``q_gate`` on)."""
    key = (start * torch.tensor([97.0, 57.0, 31.0])[:, None, None]).sum(1) * 1000.0
    hashed = (key.floor().to(torch.int64) + excl.sum(1)) % 3 == 0
    return (hashed & rs.gated_lanes(active, states, q_gate)).to(torch.int32)


@pytest.fixture
def cheap_k2(monkeypatch):
    monkeypatch.setattr(rs, "shadow_sweep", hashed_occlusion)


@pytest.fixture
def cheap_sweep(monkeypatch):
    """The plain K2 with :func:`hashed_occlusion`'s flags in place of its
    sweep (``render_slab._occlusion``): its gate and counts its own."""
    def sweep(vol, start, target, active, exclude, grid_size, cell_half):
        return hashed_occlusion(vol, start, target, torch.stack(exclude, 1), active,
                                grid_size=grid_size, cell_half=cell_half)

    monkeypatch.setattr(rs, "_occlusion", sweep)


def same(a, b):
    """Equal, NaN where NaN (the BRDF's 0/0 on grazing slots)."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def level_pipeline(cam, prepped, depth, idx, light):
    ops = rs.lighting_queries_stacked(cam, idx, depth, light, **KW)
    states = rs.gi_states(cam, idx, depth, ops, prepped, light, **KW)
    return ops, states, rs.occlusion_flags(cam, ops, prepped, grid_size=N)


@pytest.mark.parametrize("bounces", [1, 2, 3])
def test_level_twins_equal_the_recursion(frame, cheap_k2, bounces):
    """The GI of the level mode (queries, K3 and the level launches level
    by level, K2 on every row, the tree bottom up) equals indirect_bounce."""
    cam, prepped, _, depth, idx = frame
    light = rs.Lighting(gi=True, bounces=bounces)
    ops, states, flags = level_pipeline(cam, prepped, depth, idx, light)
    assert light.nq == (4**(bounces + 1) - 4) // 3 == len(flags) == len(states)
    geo = rs._hit_geometry(cam, idx, depth, N, W, H)
    got = rs._gi_light(cam, N, geo, flags, states, light)
    want = rs.indirect_bounce(prepped.vol, cam, *geo[:4], prepped, bounces=bounces, **KW)
    assert same(got, want)
    assert float(want.nan_to_num().sum()) > 0
    # Every level has live neighbours, so the tree is exercised to its leaves.
    for k in range(1, bounces + 1):
        r0, rows = rs.Lighting.level_span(k)
        assert int(ops[3][r0 : r0 + rows].sum()) > 0, f"level {k} has no active lane"


@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("bounces", [2, 3])
def test_lighting_passes_equal_the_recursion_frames(frame, cheap_k2, bounces, sliced):
    """A soft-shadow frame of b bounces from lighting_passes (K1's frame, or
    the sliced frame's direct light and depth) equals the frame composed
    from the direct-shadow queries and indirect_bounce, as the per-level
    path composed it."""
    cam, prepped, rgb, depth, idx = frame
    light = rs.Lighting(soft_k=4, gi=True, bounces=bounces)
    got = rs.lighting_passes(cam, idx, depth, prepped, light,
                             rgb=None if sliced else rgb, **KW)
    direct = rs.Lighting(soft_k=4)
    flags = rs.occlusion_flags(cam, rs.lighting_queries_stacked(cam, idx, depth, direct, **KW),
                               prepped, grid_size=N)
    occl = rs._soft_occlusion(list(flags == 1), direct.occ_div)
    geo = rs.hit_geometry(cam, idx, depth, **KW)
    gi = rs.indirect_bounce(prepped.vol, cam, *geo[:4], prepped, bounces=bounces, **KW)
    want = rs._lighting_tail(cam, rs._hit_geometry(cam, idx, depth, N, W, H), idx, depth,
                             occl, gi, grid_size=N, rgb=None if sliced else rgb)
    if sliced:
        assert same(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        assert same(got, want)


def test_lighting_passes_equal_the_recursion_with_the_plain_k2():
    """Two bounces, soft shadows, K1's frame, the plain K2 on a 32×16
    window: lighting_passes equals the frame composed from indirect_bounce."""
    w, h = 32, 16
    kw = dict(grid_size=N, width=w, height=h)
    cam, prepped, rgb, depth, idx = scene(w, h)
    light = rs.Lighting(soft_k=4, gi=True, bounces=2)
    got = rs.lighting_passes(cam, idx, depth, prepped, light, rgb=rgb, **kw)
    flags = rs.occlusion_flags(
        cam, rs.lighting_queries_stacked(cam, idx, depth, rs.Lighting(soft_k=4), **kw),
        prepped, grid_size=N)
    geo = rs._hit_geometry(cam, idx, depth, N, w, h)
    gi = rs.indirect_bounce(prepped.vol, cam, *geo[:4], prepped, bounces=2, **kw)
    want = rs._lighting_tail(cam, geo, idx, depth, rs._soft_occlusion(list(flags == 1), 4),
                             gi, grid_size=N, rgb=rgb)
    assert same(got, want) and int((idx >= 0).sum()) > 20
    assert float(gi.nan_to_num().sum()) > 0


def test_level_masks_are_gated_by_the_states(frame, cheap_k2):
    """After the level launches a slot's mask is its ok (parent ok, entry,
    live neighbour) on every level but the last, whose masks are parent ok
    and entry only; gating those by their states too gives the ok of every
    level and the same light."""
    cam, prepped, rgb, depth, idx = frame
    light = rs.Lighting(gi=True, bounces=2)
    ops, states, flags = level_pipeline(cam, prepped, depth, idx, light)
    geo = rs._hit_geometry(cam, idx, depth, N, W, H)
    tree = rs._slot_tree(cam, N, geo, states, 2)
    ok = torch.stack([s[3] for level in tree for s in level])
    assert torch.equal(ops[3][:4], ok[:4])
    assert bool((ops[3][4:] >= ok[4:]).all()) and int(ops[3][4:].sum()) > int(ok[4:].sum())
    gated = ops[3].clone()
    gated[4:] &= states[4:] == 1
    assert torch.equal(gated, ok)
    flags_g = rs.occlusion_flags(cam, (*ops[:3], gated), prepped, grid_size=N)
    a = rs.lighting_shade(cam, idx, depth, flags, states, light, rgb=rgb, **KW)
    b = rs.lighting_shade(cam, idx, depth, flags_g, states, light, rgb=rgb, **KW)
    assert same(a, b)


def _hits(frame, sliced):
    """(cam, prepped, K1's rgb or None, depth, idx): K1's hits, or the
    sliced frame's (K4's, no rgb)."""
    cam, prepped, rgb, depth, idx = frame
    if not sliced:
        return frame
    depth, idx = rs.primary_hits(cam, prepped, None, **KW)
    return cam, prepped, None, depth, idx


def _read_lanes(cam, idx, depth, ops, states, light):
    """The lanes whose flag the shade reads: each hit's direct-shadow rows,
    and each GI slot its tree evaluates (parent ok, entry, live neighbour)."""
    geo = rs._hit_geometry(cam, idx, depth, N, W, H)
    tree = rs._slot_tree(cam, N, geo, states, light.bounces)
    return torch.cat([ops[3][:light.n_soft], torch.stack([s[3] for lv in tree for s in lv])])


@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("bounces", [2, 3])
def test_k2_gates_the_last_level_by_the_states(frame, cheap_sweep, bounces, sliced):
    """Gated by the states (as lighting_passes gives them), K2's flags equal
    the ungated ones on every lane the shade reads and everywhere but the
    last level's lanes whose state is not 1, which are 0; those lanes are
    the only ones the gate takes, and the traced lanes are the lanes read."""
    cam, prepped, _, depth, idx = _hits(frame, sliced)
    light = rs.Lighting(soft_k=4, gi=True, bounces=bounces)
    ops = rs.lighting_queries_stacked(cam, idx, depth, light, **KW)
    states = rs.gi_states(cam, idx, depth, ops, prepped, light, **KW)
    q_gate = light.n_soft + rs.Lighting.level_span(bounces)[0]
    ungated = rs.occlusion_flags(cam, ops, prepped, grid_size=N)
    before = profiling.work_counts("cpu")["occlusion_lanes"]
    with profiling.profile_trace():
        gated = rs.occlusion_flags(cam, ops, prepped, grid_size=N, states=states, q_gate=q_gate)
    traced = profiling.work_counts("cpu")["occlusion_lanes"] - before
    read = _read_lanes(cam, idx, depth, ops, states, light)
    dead = torch.zeros_like(read)
    dead[q_gate:] = states[q_gate - light.n_soft:] != 1
    assert torch.equal(gated[read], ungated[read])
    assert torch.equal(gated[~dead], ungated[~dead]) and int(gated[dead].sum()) == 0
    assert int(ungated[dead].sum()) > 0  # the gate took lanes the ungated K2 flagged
    assert traced == int(read.sum()) == int(rs.gated_lanes(ops[3], states, q_gate).sum())


@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("bounces", [2, 3])
def test_lighting_passes_frames_are_the_same_with_the_gate(frame, cheap_sweep, bounces,
                                                           sliced):
    """lighting_passes' frame, whose K2 gates the last level, equals the
    frame shaded from the same queries' ungated flags, bit for bit."""
    cam, prepped, rgb, depth, idx = _hits(frame, sliced)
    light = rs.Lighting(soft_k=4, gi=True, bounces=bounces)
    got = rs.lighting_passes(cam, idx, depth, prepped, light, rgb=rgb, **KW)
    ops = rs.lighting_queries_stacked(cam, idx, depth, light, **KW)
    states = rs.gi_states(cam, idx, depth, ops, prepped, light, **KW)
    flags = rs.occlusion_flags(cam, ops, prepped, grid_size=N)
    want = rs.lighting_shade(cam, idx, depth, flags, states, light, rgb=rgb, **KW)
    if sliced:
        assert same(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        assert same(got, want)


def test_level_span_is_the_kernels_layout():
    assert [rs.Lighting.level_span(k) for k in (1, 2, 3, 4)] == [(0, 4), (4, 16), (20, 64),
                                                                   (84, 256)]
    assert [rs.Lighting(gi=True, bounces=b).n_slots for b in (1, 2, 3, 4)] == [4, 20, 84, 340]
    assert rs.Lighting(soft_k=4, gi=True, bounces=2).nq == 24
    assert rs.Lighting(gi=True, gi_slot=2).n_slots == 1
    assert rs.Lighting(soft_k=4, bounces=3).n_slots == 0


@pytest.fixture
def no_library(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(kernels, "library", refuse)


def test_level_wrappers_reject(no_library, frame):
    cam, prepped, rgb, depth, idx = frame
    light = rs.Lighting(soft_k=4, gi=True, bounces=2)
    ops = rs.lighting_queries_stacked(cam, idx, depth, light, **KW)
    states = torch.zeros((light.n_slots, H, W), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rs.lighting_level_cuda(cam, idx, depth, ops, states, light, 2, **KW)
    for level in (1, 3):
        with pytest.raises(ValueError, match="not a deeper level"):
            rs.lighting_level_cuda(cam, idx, depth, ops, states, light, level, **KW)
    five = light._replace(bounces=5)
    for call in (lambda: rs.lighting_queries_cuda(cam, idx, depth, five, **KW),
                 lambda: rs.lighting_level_cuda(cam, idx, depth, ops, states, five, 2, **KW),
                 lambda: rs.lighting_shade_cuda(cam, idx, depth, None, None, five, rgb=rgb,
                                                **KW)):
        with pytest.raises(ValueError, match="at most 4 bounces"):
            call()
    with pytest.raises(ValueError, match="does not compose"):
        rs.lighting_shade_cuda(cam, idx, depth, None, None, light, rgb=rgb,
                               history=(rgb, idx), **KW)
    with pytest.raises(ValueError, match="requires bounces == 1"):
        rs.lighting_queries_stacked(cam, idx, depth, light._replace(gi_slot=1), **KW)


# (states, q_gate) of a 24-query frame (4 direct-shadow rows, 20 slots)
# that K2 refuses, and the refusal.
GATE_REFUSALS = {
    "states_dtype": (lambda: torch.zeros((20, H, W), dtype=torch.int32), 8, "torch.uint8"),
    "states_width": (lambda: torch.zeros((20, H, W + 1), dtype=torch.uint8), 8, "shape"),
    "states_rows": (lambda: torch.zeros((25, H, W), dtype=torch.uint8), 8, "shape"),
    "q_gate_below": (lambda: torch.zeros((20, H, W), dtype=torch.uint8), 3, "q_gate"),
    "q_gate_above": (lambda: torch.zeros((20, H, W), dtype=torch.uint8), 25, "q_gate"),
    "states_alone": (lambda: torch.zeros((20, H, W), dtype=torch.uint8), None, "together"),
}


@pytest.mark.parametrize("case", list(GATE_REFUSALS))
def test_k2_refuses_a_gate_it_does_not_take(no_library, frame, case):
    """K2's wrapper refuses states of the wrong dtype or shape and a q_gate
    outside [n_soft, nq] before the library loads, and the twin refuses
    them too."""
    cam, prepped, rgb, depth, idx = frame
    light = rs.Lighting(soft_k=4, gi=True, bounces=2)
    ops = rs.lighting_queries_stacked(cam, idx, depth, light, **KW)
    make, q_gate, match = GATE_REFUSALS[case]
    kw = dict(grid_size=N, cell_half=0.01, states=make(), q_gate=q_gate)
    with pytest.raises(ValueError, match=match):
        rs.shadow_sweep_cuda(prepped.vol, prepped.coarse, prepped.box, *ops, **kw)
    with pytest.raises(ValueError, match=match):
        rs.shadow_sweep(prepped.vol, *ops, **kw)


# K2's wrapper arguments that ask a kernel for what it does not do: the tile
# kernel (``_tiles=1``, ``column_skip=False``) takes no gate, the strip
# kernel (a gate, ``_tiles=8``) always skips columns; and the refusal.
FORM_REFUSALS = {
    "gate_in_the_tile_kernel": (dict(gate=True, _tiles=1), "gate"),
    "gate_without_column_skip": (dict(gate=True, column_skip=False), "gate"),
    "strip_without_column_skip": (dict(_tiles=8, column_skip=False), "skips columns"),
    "tiles_9": (dict(_tiles=9), "_tiles must be"),
}


@pytest.mark.parametrize("case", list(FORM_REFUSALS))
def test_k2_refuses_a_form_it_does_not_have(no_library, frame, case):
    """K2's wrapper refuses a gate or a column option its kernel lacks, and a
    ``_tiles`` other than 0, 1 and 8, before the library loads."""
    cam, prepped, rgb, depth, idx = frame
    light = rs.Lighting(soft_k=4, gi=True, bounces=2)
    ops = rs.lighting_queries_stacked(cam, idx, depth, light, **KW)
    kw, match = dict(FORM_REFUSALS[case][0]), FORM_REFUSALS[case][1]
    if kw.pop("gate", False):
        kw.update(states=torch.zeros((20, H, W), dtype=torch.uint8), q_gate=8)
    with pytest.raises(ValueError, match=match):
        rs.shadow_sweep_cuda(prepped.vol, prepped.coarse, prepped.box, *ops, grid_size=N,
                             cell_half=0.01, **kw)
