"""The sliced path with age planes: the port's ``raytrace_sliced(ages=…)``
(plain K4 with its age output, the age fade in torch) against the JAX
package's at 64³ / 128×64 over 2 bricks (32-plane slabs), whose per-brick age
layouts and age merge across bricks the port replaces by one fetch at the
hit, on a Generations scene of a 10-state rule with hard shadows.  The frame
of the temporally amortized lighting is
tests/test_torch_multistate_sliced_temporal.py (one JAX frame a file, so
``--dist loadfile`` spreads them).
Contract of tests/_torch_sliced_scene.py.
"""

import numpy as np
import pytest
import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.render.render_slab import primary_sweep

from _torch_multistate_scene import S_SLICED, check_sliced_frame_with_ages, hit_ages
from _torch_sliced_scene import H, N, W

from _torch_multistate_scene import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def hard_frame():
    return check_sliced_frame_with_ages(
        {}, {}, max_flipped=0, n=N, p_dead=0.98,
        bricks=dict(slab_planes=32, x_chunk_cells=64))


def test_sliced_hard_shadow_frame_with_ages_matches_jax(hard_frame):
    assert (hard_frame[4][2] >= 0).sum() > 500


def test_k4_age_image_equals_the_dense_ages_at_the_reference_hits(hard_frame):
    ages, planes, vis, cam, want = hard_frame
    t, idx, age = primary_sweep(ct.from_reference(vis), cam, ct.from_reference(planes),
                                grid_size=N, width=W, height=H)
    hit = want[2] >= 0
    np.testing.assert_array_equal(idx.numpy(), want[2])
    np.testing.assert_array_equal(age.numpy(), hit_ages(ages, want[2]))
    assert set(np.unique(age.numpy()[hit])) == set(range(1, S_SLICED))
    np.testing.assert_allclose(t.numpy()[hit], want[1][hit], atol=3e-5, rtol=0)
