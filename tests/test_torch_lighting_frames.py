"""The port's ``trace_shaded`` with soft shadows and one-bounce GI against
the JAX package (Pallas kernels in interpret mode) on the scene of
tests/test_gi_temporal.py: full quality (4 soft-shadow samples and 4 GI
slots every frame) and ``gi_temporal`` at sample indices 0-3.  Plus the
temporal mode's invariant on the port alone: the mean over one rotation
equals the full-quality frame.

Contract: ids equal, depth within 3e-5, rgb within rtol 3e-3 / atol 3e-4
on all but ≤ 5 % of the hit pixels (occlusion flags that flip on grazing
shadow rays; see _torch_lighting_scene.py).
"""

import numpy as np
import pytest

from _torch_lighting_scene import (
    LIGHTING,
    assert_frame_close,
    jax_trace_shaded,
    torch_trace_shaded,
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
