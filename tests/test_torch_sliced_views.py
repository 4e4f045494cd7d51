"""The port's sliced path from a rotated camera, without shadows, against
the JAX package's ``raytrace_sliced`` over 4 bricks (contract in
_torch_sliced_scene.py): the plain K4's hits and the shaded frame."""

import pytest

from _torch_sliced_scene import (
    assert_frame_close,
    assert_primary_close,
    jax_sliced,
    random_words,
    scene_cam,
    torch_primary,
    torch_sliced,
)


@pytest.fixture(scope="module")
def rotated_frame():
    words, cam = random_words(3, 0.03), scene_cam("rotated")
    return words, cam, jax_sliced(words, cam, shadow=False)


def test_primary_sweep_rotated_matches_jax(rotated_frame):
    words, cam, want = rotated_frame
    assert_primary_close(torch_primary(words, cam), want)


def test_raytrace_sliced_rotated_unshadowed_matches_jax(rotated_frame):
    words, cam, want = rotated_frame
    assert_frame_close(torch_sliced(words, cam, shadow=False), want)
