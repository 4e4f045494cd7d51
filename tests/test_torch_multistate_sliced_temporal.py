"""The sliced path with age planes under the temporally amortized lighting
(one rotating soft-shadow sample and one GI slot a frame): the port's
``raytrace_sliced(ages=…, sample_idx=…)`` against the JAX package's at 32³ /
128×64 (one brick; tests/test_torch_multistate_sliced.py holds the age merge
across bricks).  The fade multiplies the occlusion quotient of the
direct term and not the GI added after it.  Contract of
tests/_torch_sliced_scene.py; a soft-shadow frame allows a few penumbra
pixels (tests/_torch_lighting_scene.py)."""

from _torch_multistate_scene import check_sliced_frame_with_ages

from _torch_multistate_scene import one_torch_thread  # noqa: F401

TEMPORAL = dict(soft_shadow_samples=4, indirect=True, sample_idx=2)


def test_sliced_gi_temporal_frame_with_ages_matches_jax():
    check_sliced_frame_with_ages(
        TEMPORAL, dict(light_radius=0.08, elapsed_time=0.37), max_flipped=8,
        n=32, p_dead=0.95, bricks=dict(slab_planes=32, x_chunk_cells=32))
