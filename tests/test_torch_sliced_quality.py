"""The port's sliced path at full quality -- soft shadows ×4 (one K2
launch with the frame's 4 jittered samples and 4 GI slots) and one-bounce
GI (one K3 launch) -- against the JAX package's ``raytrace_sliced`` over 4
bricks (contract in _torch_sliced_scene.py; the penumbra pixels of
_torch_lighting_scene.py may flip: 0-3 of 90 hit pixels at 64×32 in the
lighting tests' measurements)."""

from _torch_sliced_scene import assert_frame_close, jax_sliced, random_words, scene_cam, torch_sliced

FULL_QUALITY = dict(soft_shadow_samples=4, indirect=True)
MAX_PENUMBRA_FLIPS = 3


def test_raytrace_sliced_full_quality_matches_jax():
    words = random_words(9, 0.02)
    cam = scene_cam("front", light_radius=0.08, elapsed_time=0.37)
    want = jax_sliced(words, cam, **FULL_QUALITY)
    got = torch_sliced(words, cam, **FULL_QUALITY)
    assert_frame_close(got, want, max_flipped=MAX_PENUMBRA_FLIPS)
    # The GI term and the soft shadows both changed the frame.
    hard = torch_sliced(words, cam)
    assert (got[0] != hard[0]).any()
