"""``RenderStatic.force_sliced``: a 64³ frame of ``render_frame_fast``
through the sliced path, the port's against the JAX package's with
``RenderStatic(force_sliced=True, slab_planes=32, x_chunk_cells=32)`` (4
bricks), over a history whose ids are the frame's own on half the pixels,
so the temporal EMA blends there.  Contract of _torch_sliced_scene.py on the
presentation (rgb tolerance), depth and the new history."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cellularautomatons3d_tpu.render import renderer as jren
from cellularautomatons3d_tpu.render import renderer_fast as jrf

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.render import renderer, renderer_fast
from cellularautomatons3d_tpu_torch.utils import mat4

from _torch_sliced_scene import BRICKS, H, N, W, random_words, scene_cam, torch_primary

LIVE = dict(elapsed_time=0.37, cell_size=0.85, temporal_alpha=0.1, gamma=2.0,
            roughness=0.29, base_reflectivity=(0.17,) * 3, material_color=(0.0,) * 3,
            light_pos=(0.721, 1.0, 1.0), light_magnitude=5.0, show_depth_overlay=0.0,
            emissive_color=(0.02, 0.03, 0.04), emissive_strength=0.5)


def _history(words):
    """f16 colours from numpy, ids: the frame's own on half the pixels."""
    rng = np.random.default_rng(4)
    _, idx = torch_primary(words, scene_cam("front"))
    keep = rng.random(idx.shape) < 0.5
    ids = np.where(keep, idx, -1).astype(np.int32)
    color = rng.uniform(0.0, 1.0, (H, W, 3)).astype(np.float16)
    return color, ids


def test_force_sliced_render_frame_fast_matches_jax():
    words = random_words(9, 0.02)
    color, ids = _history(words)
    view = mat4.initial_view_matrix()
    f32 = np.float32
    live = {k: (np.asarray(v, f32) if isinstance(v, tuple) else f32(v))
            for k, v in LIVE.items()}

    s_jax = jren.RenderStatic(width=W, height=H, grid_size=N, force_sliced=True, **BRICKS)
    params_jax = jren.RenderParams(
        view_mat=jnp.asarray(view), prev_view_mat=jnp.asarray(view),
        prev_proj_view=jnp.eye(4, dtype=jnp.float32),
        **{k: jnp.asarray(v) for k, v in live.items()})
    with jax.disable_jit():
        pres_j, depth_j, hist_j = jrf.render_frame_fast(
            s_jax, jnp.asarray(words), params_jax,
            jrf.FastHistory(color=jnp.asarray(color), hit_idx=jnp.asarray(ids)))
        want = [np.asarray(a) for a in (pres_j, depth_j, hist_j.color, hist_j.hit_idx)]

    s = renderer.RenderStatic(width=W, height=H, grid_size=N, force_sliced=True)
    params = renderer.RenderParams(view_mat=view, prev_view_mat=view,
                                   prev_proj_view=np.eye(4, dtype=f32), **live)
    pres, depth, hist = renderer_fast.render_frame_fast(
        s, ct.from_reference(words), params,
        renderer_fast.FastHistory(torch.from_numpy(color), torch.from_numpy(ids)))
    got = [a.numpy() for a in (pres, depth, hist.color, hist.hit_idx)]

    np.testing.assert_array_equal(got[3], want[3])
    assert (want[3] >= 0).sum() > 500
    np.testing.assert_allclose(got[1], want[1], atol=3e-5, rtol=0)
    np.testing.assert_allclose(got[0], want[0], rtol=3e-3, atol=3e-4)
    np.testing.assert_allclose(got[2].astype(np.float32), want[2].astype(np.float32),
                               rtol=3e-3, atol=3e-4)
    # The history blended where its ids matched the frame's.
    assert ((ids >= 0) & (ids == want[3])).sum() > 500
