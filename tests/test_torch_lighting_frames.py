"""The port's ``trace_shaded`` with soft shadows and one-bounce GI against
the JAX package (Pallas kernels in interpret mode) on the scene of
tests/test_gi_temporal.py: full quality (4 soft-shadow samples and 4 GI
slots every frame) and ``gi_temporal`` at sample indices 0-3.  Plus the
temporal mode's invariant on the port alone: the mean over one rotation
equals the full-quality frame.

The same frames through the two lighting kernels' twins step by step
(plain K1, ``lighting_queries_stacked``, plain K2 and K3,
``lighting_shade``), as the card runs the kernels.

Contract: ids equal, depth within 3e-5, rgb within rtol 3e-3 / atol 3e-4
on all but ≤ 5 % of the hit pixels (occlusion flags that flip on grazing
shadow rays; see _torch_lighting_scene.py).
"""

import numpy as np
import pytest

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.render.render_slab import Lighting

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
    twin_frame,
)

TEMPORAL = dict(LIGHTING, gi_temporal=True)


@pytest.fixture(scope="module")
def jax_frames():
    return {
        "full": jax_trace_shaded(LIGHTING)[0],
        "temporal": jax_trace_shaded(TEMPORAL, range(4)),
    }


def test_trace_shaded_full_quality_matches_jax(jax_frames):
    assert_frame_close(torch_trace_shaded(LIGHTING), jax_frames["full"])


@pytest.mark.parametrize("k", range(4))
def test_trace_shaded_gi_temporal_matches_jax(jax_frames, k):
    assert_frame_close(torch_trace_shaded(TEMPORAL, k), jax_frames["temporal"][k])


def test_temporal_rotation_mean_equals_full_lighting():
    """Each rotated sample equals the corresponding static sample, so the
    mean of the temporal frames over a full 4-sample rotation equals the
    non-temporal frame (soft_k=4 average + 4-slot GI sum)."""
    rgb_full, depth_full, idx_full = torch_trace_shaded(LIGHTING)
    acc = np.zeros_like(rgb_full)
    for k in range(4):
        rgb_k, depth_k, idx_k = torch_trace_shaded(TEMPORAL, k)
        np.testing.assert_array_equal(idx_k, idx_full)
        np.testing.assert_array_equal(depth_k, depth_full)
        acc = acc + rgb_k
    np.testing.assert_allclose(acc / 4.0, rgb_full, rtol=2e-5, atol=1e-6)
    # Without the frame counter the temporal config renders full quality.
    np.testing.assert_array_equal(torch_trace_shaded(TEMPORAL)[0], rgb_full)


@pytest.mark.parametrize("k", [None, 0, 1, 2, 3], ids=["full", "t0", "t1", "t2", "t3"])
def test_lighting_twins_match_jax_trace_shaded(jax_frames, k):
    """Full quality and gi_temporal's samples 0-3 through the queries and
    shade kernels' twins, step by step, against JAX's trace_shaded."""
    light = Lighting(soft_k=4, gi=True) if k is None else Lighting(
        soft_k=4, jitter_k=k, gi=True, gi_slot=k)
    got = twin_frame(ct.from_reference(scene_words(), device="cpu"), scene_cam(), light,
                     n=N, width=W, height=H)
    assert_frame_close(got, jax_frames["full"] if k is None else jax_frames["temporal"][k])
