"""The sliced path with age planes: the port's ``raytrace_sliced(ages=…)``
(plain K4 with its age output, the age fade in torch) against the JAX
package's, one module-scoped JAX frame per lighting mode:

* hard shadows at 64³ / 128×64 over 2 bricks (32-plane slabs), whose
  per-brick age layouts and age merge across bricks the port replaces by one
  fetch at the hit, on a Generations scene of a 10-state rule;
* the temporally amortized lighting (one rotating soft-shadow sample and one
  GI slot a frame) at 32³ / 128×64 over one brick: the fade multiplies the
  occlusion quotient of the direct term and not the GI added after it; a
  soft-shadow frame allows a few penumbra pixels
  (tests/_torch_lighting_scene.py).

Each frame also through the two lighting kernels' twins step by step (plain
K4 with ages, ``lighting_queries_stacked``, plain K2 and K3,
``lighting_shade`` fading the direct light).  Contract of
tests/_torch_sliced_scene.py.
"""

import numpy as np
import pytest
import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.render.render_slab import primary_sweep

from _torch_multistate_scene import S_SLICED, check_sliced_frame_with_ages, hit_ages
from _torch_sliced_scene import H, N, W

from _torch_multistate_scene import one_torch_thread  # noqa: F401

# Lighting mode: (raytrace_sliced options, camera options, flipped pixels
# allowed, grid, share of dead cells, bricks).
MODES = {
    "hard": ({}, {}, 0, N, 0.98, dict(slab_planes=32, x_chunk_cells=64)),
    "gi_temporal": (dict(soft_shadow_samples=4, indirect=True, sample_idx=2),
                    dict(light_radius=0.08, elapsed_time=0.37), 8, 32, 0.95,
                    dict(slab_planes=32, x_chunk_cells=32)),
}


@pytest.fixture(scope="module", params=list(MODES))
def sliced_frame(request):
    kw, cam_kw, flipped, n, p_dead, bricks = MODES[request.param]
    return request.param, check_sliced_frame_with_ages(
        kw, cam_kw, max_flipped=flipped, n=n, p_dead=p_dead, bricks=bricks)


def test_sliced_frame_with_ages_matches_jax(sliced_frame):
    mode, (_, _, _, _, want) = sliced_frame
    assert (want[2] >= 0).sum() > (500 if mode == "hard" else 50)


def test_k4_age_image_equals_the_dense_ages_at_the_reference_hits(sliced_frame):
    mode, (ages, planes, vis, cam, want) = sliced_frame
    t, idx, age = primary_sweep(ct.from_reference(vis, device="cpu"), cam,
                                ct.from_reference(planes, device="cpu"),
                                grid_size=MODES[mode][3], width=W, height=H)
    hit = want[2] >= 0
    np.testing.assert_array_equal(idx.numpy(), want[2])
    np.testing.assert_array_equal(age.numpy(), hit_ages(ages, want[2]))
    assert set(np.unique(age.numpy()[hit])) == set(range(1, S_SLICED))
    np.testing.assert_allclose(t.numpy()[hit], want[1][hit], atol=3e-5, rtol=0)


def test_lighting_twins_with_ages_match_jax(sliced_frame):
    from cellularautomatons3d_tpu_torch.render.render_slab import Lighting

    from _torch_lighting_scene import twin_frame
    from _torch_sliced_scene import assert_frame_close

    mode, (_, planes, vis, cam, want) = sliced_frame
    kw, _, flipped, n, _, _ = MODES[mode]
    light = Lighting(soft_k=1) if mode == "hard" else Lighting(
        soft_k=4, jitter_k=kw["sample_idx"] % 4, gi=True, gi_slot=kw["sample_idx"] % 4)
    got = twin_frame(ct.from_reference(vis, device="cpu"), cam, light, n=n, width=W, height=H,
                     ages=ct.from_reference(planes, device="cpu"), total_states=S_SLICED,
                     sliced=True)
    assert_frame_close(got, want, max_flipped=flipped)
