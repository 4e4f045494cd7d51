"""The exact reference pipeline's frame: the port's
``render.renderer.render_frame`` on the CPU against the JAX package's on the
cases of tests/test_render.py:142-231 (32³ / 64×48), each from the same
numpy inputs.

Against the jitted JAX frame each test states the mismatch fractions it
allows (tests/_torch_reference_scene.py: hit mask, f16 depth beyond 1 ulp,
rgb beyond rtol 3e-3 / atol 3e-4 where the depth agrees); against the eager
JAX frame of the block scene every fraction is 0.
"""

import numpy as np
import pytest
import torch

from _torch_multistate_scene import one_torch_thread  # noqa: F401  (autouse)
from _torch_reference_scene import (
    H, N, W, block_words, compare, jax_frame, params, torch_frame,
)
from cellularautomatons3d_tpu_torch.render import renderer as tr
from cellularautomatons3d_tpu_torch.utils import mat4

FAST = dict(depth_samples=20, shadow_samples=10)
DEEP = dict(depth_samples=60, shadow_samples=10)
# A jitted block frame differs from the port on at most this fraction of
# pixels in depth, and as many again in rgb (measured: up to 8 and 9 of
# 3072; XLA's FMAs move a sample across a cell edge).  Eager JAX: none.
BLOCK = 3e-3


@pytest.fixture(scope="module")
def block_fast():
    """The block scene at 20 depth steps: (port, jitted JAX, eager JAX)."""
    words, p = block_words(), params()
    return (torch_frame(FAST, words, p)[0], jax_frame(FAST, words, p)[0],
            jax_frame(FAST, words, p, eager=True)[0])


def test_frame_deterministic_and_matches_jax(block_fast):
    got, want, eager = block_fast
    again = torch_frame(FAST, block_words(), params())[0]
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a, b)
    compare(got, want, depth=BLOCK, rgb=BLOCK)
    assert compare(got, eager) == dict(hit=0.0, depth=0.0, rgb=0.0)


def test_frame_hits_block_with_expected_depth():
    words, p = block_words(), params()
    got = torch_frame(DEEP, words, p)[0]
    compare(got, jax_frame(DEEP, words, p)[0], depth=BLOCK, rgb=BLOCK)
    frame, _, depth = got
    cy, cx = H // 2, W // 2
    assert frame[cy, cx].sum() > 0.01
    # The block's front face at z = 20/32 - 0.5, inset by the visible cube
    # (0.85 of a cell), seen from z = 0.75 (tests/test_render.py:157-159).
    assert 0.6 < depth[cy, cx, 0] < 0.66
    assert frame[0, 0].sum() == 0.0


def test_empty_grid_renders_black_volume():
    words, p = np.zeros((N // 32, N, N), np.uint32), params()
    got = torch_frame(FAST, words, p)[0]
    compare(got, jax_frame(FAST, words, p)[0])
    assert got[0].max() == 0.0


def test_light_cube_drawn_when_visible():
    from cellularautomatons3d_tpu_torch.render.camera import get_ray, pixel_uvs

    cy, cx = H // 2, W // 2
    uv = pixel_uvs(W, H)[cy, cx]
    ray = get_ray(uv, (W, H)).numpy()
    light = np.array([0.0, 0.0, 0.75], np.float32) + ray * np.float32(1.5)
    words, p = np.zeros((N // 32, N, N), np.uint32), params(light_pos=light)
    got = torch_frame(FAST, words, p)[0]
    compare(got, jax_frame(FAST, words, p)[0])
    np.testing.assert_allclose(got[0][cy, cx], 1.0, atol=1e-6)
    assert (got[0].sum(-1) > 0).sum() < 20


def test_depth_overlay():
    words, p = block_words(), params(show_depth_overlay=1.0)
    got = torch_frame(FAST, words, p)[0]
    compare(got, jax_frame(FAST, words, p)[0], depth=BLOCK, rgb=BLOCK)
    frame, _, depth = got
    left = frame[:, : W // 2]
    assert (left[..., 1:] == 0).all()
    np.testing.assert_allclose(left[H // 2, 5, 0], np.float32(depth[H // 2, 5, 0]) ** 0.5,
                               rtol=2e-2, atol=1e-3)


def test_temporal_accumulation_mixes_history():
    """Two frames, the second over the first's history (port history to the
    port, JAX's to JAX)."""
    words, p = block_words(), params()
    got1, th = torch_frame(DEEP, words, p)
    want1, jh = jax_frame(DEEP, words, p)
    got2 = torch_frame(DEEP, words, p, history=th)[0]
    want2 = jax_frame(DEEP, words, p, history=jh)[0]
    for got, want in ((got1, want1), (got2, want2)):
        compare(got, want, depth=BLOCK, rgb=BLOCK)
    assert np.abs(got1[0] - got2[0]).max() < 5e-2
    assert got2[0][H // 2, W // 2].sum() > 0.01


def test_frame_from_jax_history_matches():
    """The port started from JAX's history (``from_reference`` of its
    ``RenderHistory``) renders JAX's second frame."""
    import cellularautomatons3d_tpu_torch as ct

    words, p = block_words(), params()
    want1, jh = jax_frame(DEEP, words, p)
    hist = ct.from_reference(jh, device="cpu")
    assert isinstance(hist, tr.RenderHistory) and hist.depth.dtype == torch.float16
    np.testing.assert_array_equal(hist.depth.numpy(), want1[2])
    got2 = torch_frame(DEEP, words, p, history=hist)[0]
    compare(got2, jax_frame(DEEP, words, p, history=jh)[0], depth=BLOCK, rgb=BLOCK)


@pytest.mark.parametrize("move", ["pan", "rotate_90"])
def test_moving_camera_reprojects_history(move):
    """A camera move with the previous view-projection: a small pan keeps
    part of the history (reprojected), a 90° turn leaves the screen
    (tests/test_render.py:220-231); both frames are finite and match JAX."""
    view0 = mat4.initial_view_matrix()
    if move == "pan":
        view1 = mat4.rotate(mat4.translate(view0, (0.03, 0.01, -0.02)), (0, 1, 0), 0.05)
    else:
        view1 = mat4.rotate(view0, (0, 1, 0), np.pi / 2)
    s = dict(depth_samples=30, shadow_samples=10)
    words = block_words()
    _, th = torch_frame(s, words, params(view0))
    _, jh = jax_frame(s, words, params(view0))
    p1 = params(view1, prev=view0)
    got, th1 = torch_frame(s, words, p1, history=th)
    compare(got, jax_frame(s, words, p1, history=jh)[0], depth=BLOCK, rgb=BLOCK)
    assert np.isfinite(got[0]).all()
    if move == "pan":  # the history blended in on most lit pixels
        fresh = torch_frame(s, words, p1)[0]
        kept = ~np.isclose(got[0], fresh[0]).all(-1)
        assert kept.sum() > (fresh[0].sum(-1) > 0).sum() // 2
