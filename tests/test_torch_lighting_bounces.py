"""Two-bounce GI and the fused extended-lighting loops of the port.

Against the JAX package (Pallas kernels in interpret mode), on the scene of
tests/test_gi_temporal.py: ``trace_shaded`` with ``indirect_bounces=2``,
within the contract of tests/test_torch_lighting_frames.py.  On the port
alone: the single-slot estimator of ``indirect_bounce`` (the mean of the
four slots equals the 4-slot call), the second bounce only adds light, and
each fused loop (``make_fused_loop``'s extended branch and its per-frame
branch) equals iterating ``render_frame_fast``.
"""

import numpy as np
import pytest
import torch

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.ops.occupancy import coarse_occupancy
from cellularautomatons3d_tpu_torch.render import render_slab
from cellularautomatons3d_tpu_torch.render.render_fast import raytrace_tiles
from cellularautomatons3d_tpu_torch.render.renderer import RenderParams, RenderStatic
from cellularautomatons3d_tpu_torch.render.renderer_fast import (
    init_fast_history,
    make_fused_loop,
    render_frame_fast,
)
from cellularautomatons3d_tpu_torch.utils import mat4

from _torch_lighting_scene import (
    LIGHTING,
    H,
    N,
    W,
    assert_frame_close,
    jax_trace_shaded,
    scene_cam,
    scene_words,
    torch_trace_shaded,
)

TWO = dict(LIGHTING, indirect_bounces=2)


def test_trace_shaded_two_bounces_matches_jax():
    want = jax_trace_shaded(TWO)[0]
    got = torch_trace_shaded(TWO)
    assert_frame_close(got, want)
    # The second bounce only adds light (the GI term is clamped ≥ 0).
    one = torch_trace_shaded(LIGHTING)
    assert np.all(got[0] >= one[0] - 1e-6) and np.any(got[0] > one[0] + 1e-4)


def test_single_slot_estimates_sum():
    """indirect_bounce(slot=i) == 4 × slot i's contribution: the mean of
    the four single-slot calls equals the full 4-slot call."""
    vol = ct.from_reference(scene_words())
    cam = scene_cam()
    _, depth, idx = raytrace_tiles(vol, coarse_occupancy(vol), cam, grid_size=N,
                                   width=W, height=H, shadow=False)
    q, origin, coords, found, _ = render_slab.hit_geometry(
        cam, idx, depth, grid_size=N, width=W, height=H)
    prepped = render_slab.prep_volume(vol)
    kw = dict(grid_size=N, width=W, height=H)
    full = render_slab.indirect_bounce(vol, cam, q, origin, coords, found, prepped, **kw)
    acc = torch.zeros_like(full)
    for i in range(4):
        acc += render_slab.indirect_bounce(
            vol, cam, q, origin, coords, found, prepped, slot=torch.tensor(i), **kw)
    torch.testing.assert_close(acc / 4.0, full, rtol=2e-5, atol=1e-6)
    assert float(full.max()) > 0.0
    with pytest.raises(ValueError, match="bounces == 1"):
        render_slab.indirect_bounce(vol, cam, q, origin, coords, found, prepped,
                                    slot=0, bounces=2, **kw)


def _params():
    view = mat4.initial_view_matrix()
    f32 = np.float32
    return RenderParams(
        view_mat=view, prev_view_mat=view, prev_proj_view=np.eye(4, dtype=f32),
        elapsed_time=f32(0.37), cell_size=f32(0.85),
        temporal_alpha=f32(0.1), gamma=f32(2.0), roughness=f32(0.29),
        base_reflectivity=np.full(3, 0.17, f32), material_color=np.zeros(3, f32),
        light_pos=f32([0.721, 1.0, 1.0]), light_magnitude=f32(5.0),
        show_depth_overlay=f32(0.0), light_radius=f32(0.08),
    )


@pytest.mark.parametrize("static_kw", [dict(LIGHTING, gi_temporal=True), TWO],
                         ids=["gi_temporal", "two_bounces"])
def test_fused_loop_matches_frame_sequence(static_kw):
    """The fused loop equals render_frame_fast frame after frame, the
    sample index being the loop counter.  The extended branch carries its
    history in f32 and quantizes once at exit, the per-frame path every
    frame: the tolerance covers that (the reference's own test's)."""
    s = RenderStatic(width=W, height=H, grid_size=N, **static_kw)
    spec = ct.AutomatonSpec.from_config(ct.EngineConfig(grid_size=N))
    st = ct.from_reference(scene_words())
    frames = 3
    st_out, hist_out, frame = make_fused_loop(s, spec, frames)(
        st, _params(), init_fast_history(W, H, "cpu"))

    st2, hist = st, init_fast_history(W, H, "cpu")
    for i in range(frames):
        st2 = ct.step_packed(st2, spec)
        frame2, _, hist = render_frame_fast(
            s, st2, _params(), hist, True, i if s.gi_temporal else None)
    assert torch.equal(st_out, st2)
    assert torch.equal(hist_out.hit_idx, hist.hit_idx)
    assert (hist.hit_idx >= 0).any()
    torch.testing.assert_close(frame, frame2, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(hist_out.color.float(), hist.color.float(),
                               rtol=2e-2, atol=2e-3)
