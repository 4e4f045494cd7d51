"""``render_frame_fast`` and ``make_fused_loop`` with a multi-state rule: the
port against the JAX package at 32³ / 64×32 in each of the fused loop's three
branches -- K1 compose mode (hard shadows), the extended frame (soft shadows
and temporally amortized GI) and ``render_frame_fast`` per iteration (the
sliced path, ``force_sliced``, K4 with its age output, f16 history between
frames) -- from a blob of random valid ages of an 8-state rule, with
``reset_every=2``: the K1 branches over 3 frames, the sliced one over 2 (the
second frame renders the state stepped twice over the first one's history,
then the state is restored).

Contract: states and history ids equal; frames and history colours within
rtol 3e-3 / atol 3e-4, soft-shadow frames with the flipped-pixel allowance of
tests/_torch_lighting_scene.py.  JAX's K1 branches run jitted with the Pallas
kernels in interpret mode, its sliced branch op by op under
``jax.disable_jit()`` as tests/test_render_slab.py runs it, ~35 s a frame.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellularautomatons3d_tpu.models.automaton import AutomatonSpec as JaxSpec
from cellularautomatons3d_tpu.render import renderer as jren
from cellularautomatons3d_tpu.render import renderer_fast as jrf

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.ops import ca_step
from cellularautomatons3d_tpu_torch.render import renderer, renderer_fast

from _torch_lighting_scene import H, LIGHTING, MAX_FLIPPED_FRACTION, N, W
from _torch_multistate_scene import pack_ages
from cellularautomatons3d_tpu_torch.utils import mat4

from _torch_multistate_scene import one_torch_thread  # noqa: F401

S = 8
RULE = dict(neighbourhood="moore", born="6-8", survive="4-7", total_states=S)
FRAMES, RESET = 3, 2
LIVE = dict(elapsed_time=0.37, cell_size=0.85, temporal_alpha=0.1, gamma=2.0,
            roughness=0.29, base_reflectivity=(0.17,) * 3, material_color=(0.0,) * 3,
            light_pos=(0.721, 1.0, 1.0), light_magnitude=5.0, show_depth_overlay=0.0,
            light_radius=0.08, emissive_color=(0.02, 0.03, 0.04), emissive_strength=0.5)
BRANCHES = {
    "compose": {},
    "extended": dict(LIGHTING, gi_temporal=True),
    "per_frame": dict(force_sliced=True),
}
# Frames of each branch's run against JAX.
JAX_FRAMES = {"compose": FRAMES, "extended": FRAMES, "per_frame": 2}


def blob_planes():
    """Age planes of a 30 %-dense 10³ blob of random ages 1..S-1."""
    rng = np.random.default_rng(11)
    ages = np.zeros((N, N, N), np.uint8)
    block = rng.integers(1, S, (10, 10, 10)).astype(np.uint8)
    ages[11:21, 11:21, 11:21] = np.where(rng.random((10, 10, 10)) < 0.3, block, 0)
    return pack_ages(ages, 3)


def _live():
    f32 = np.float32
    return {k: (np.asarray(v, f32) if isinstance(v, tuple) else f32(v))
            for k, v in LIVE.items()}


def jax_loop(static_kw, frames):
    """JAX ``make_fused_loop`` on the blob: numpy (state, history color,
    history ids, last frame)."""
    view = mat4.initial_view_matrix()
    bricks = dict(slab_planes=32, x_chunk_cells=32) if "force_sliced" in static_kw else {}
    s = jren.RenderStatic(width=W, height=H, grid_size=N, **static_kw, **bricks)
    params = jren.RenderParams(
        view_mat=jnp.asarray(view), prev_view_mat=jnp.asarray(view),
        prev_proj_view=jnp.eye(4, dtype=jnp.float32),
        **{k: jnp.asarray(v) for k, v in _live().items()})
    spec = JaxSpec.from_rule_strings(grid_size=N, **RULE)
    eager = jax.disable_jit() if s.force_sliced else contextlib.nullcontext()
    with eager:
        st, hist, frame = jrf.make_fused_loop(s, spec, frames, 1, RESET)(
            jnp.asarray(blob_planes()), params, jrf.init_fast_history(W, H))
        return tuple(np.asarray(a) for a in (st, hist.color, hist.hit_idx, frame))


def torch_static(static_kw):
    return renderer.RenderStatic(width=W, height=H, grid_size=N, **static_kw)


def torch_params():
    view = mat4.initial_view_matrix()
    return renderer.RenderParams(view_mat=view, prev_view_mat=view,
                                 prev_proj_view=np.eye(4, dtype=np.float32), **_live())


def assert_close_but_flipped(got, want, hit, soft):
    close = np.isclose(got, want, rtol=3e-3, atol=3e-4).all(axis=-1)
    allowed = MAX_FLIPPED_FRACTION * hit.sum() if soft else 0
    assert (~close).sum() <= allowed, f"{(~close).sum()} of {hit.sum()} hit pixels differ"


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_fused_loop_with_ages_matches_jax(branch):
    static_kw = BRANCHES[branch]
    frames = JAX_FRAMES[branch]
    want = jax_loop(static_kw, frames)
    spec = ct.AutomatonSpec.from_rule_strings(grid_size=N, **RULE)
    start = ct.from_reference(blob_planes(), device="cpu")
    st, hist, frame = renderer_fast.make_fused_loop(
        torch_static(static_kw), spec, frames, 1, RESET)(
        start, torch_params(), renderer_fast.init_fast_history(W, H, "cpu"))
    np.testing.assert_array_equal(ct.to_reference(st), want[0])
    np.testing.assert_array_equal(hist.hit_idx.numpy(), want[2])
    hit = want[2] >= 0
    assert hit.sum() > 50
    soft = "soft_shadow_samples" in static_kw
    assert_close_but_flipped(frame.numpy(), want[3], hit, soft)
    assert_close_but_flipped(hist.color.float().numpy(), want[1].astype(np.float32), hit, soft)
    # reset_every=2: the state is frames % 2 steps past the start.
    assert torch.equal(st, ca_step.step_packed(start, spec) if frames % RESET else start)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_fused_loop_with_ages_equals_the_frame_sequence(branch):
    """The fused loop equals step + render_frame_fast frame after frame on the
    visibility plane with the ages handed in; the K1 branches carry their
    history in f32 and quantize once at exit (the tolerance of
    tests/test_torch_lighting_bounces.py)."""
    s = torch_static(BRANCHES[branch])
    spec = ct.AutomatonSpec.from_rule_strings(grid_size=N, **RULE)
    start = ct.from_reference(blob_planes(), device="cpu")
    st, hist, frame = renderer_fast.make_fused_loop(s, spec, FRAMES)(
        start, torch_params(), renderer_fast.init_fast_history(W, H, "cpu"))
    st2, hist2 = start, renderer_fast.init_fast_history(W, H, "cpu")
    for i in range(FRAMES):
        st2 = ca_step.step_packed(st2, spec)
        frame2, _, hist2 = renderer_fast.render_frame_fast(
            s, ca_step.visibility_plane(st2, spec), torch_params(), hist2, True,
            i if s.gi_temporal else None, ages=st2, total_states=S)
    assert torch.equal(st, st2) and torch.equal(hist.hit_idx, hist2.hit_idx)
    torch.testing.assert_close(frame, frame2, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(hist.color.float(), hist2.color.float(), rtol=2e-2, atol=2e-3)
    # Without the ages the frame is brighter: the fade reached this branch.
    binary, _, _ = renderer_fast.render_frame_fast(
        s, ca_step.visibility_plane(st2, spec), torch_params(),
        renderer_fast.init_fast_history(W, H, "cpu"), True, 0 if s.gi_temporal else None)
    faded, _, _ = renderer_fast.render_frame_fast(
        s, ca_step.visibility_plane(st2, spec), torch_params(),
        renderer_fast.init_fast_history(W, H, "cpu"), True, 0 if s.gi_temporal else None,
        ages=st2, total_states=S)
    assert bool((faded <= binary).all()) and float(faded.sum()) < float(binary.sum())
