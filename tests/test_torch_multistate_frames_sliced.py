"""``make_fused_loop`` with a multi-state rule through the sliced path
(``force_sliced``: ``render_frame_fast`` per iteration, K4 with its age
output, f16 history between frames), the port against the JAX package at
32³ / 64×32; scene, loop and contract of tests/test_torch_multistate_frames.py,
over 2 frames with ``reset_every=2`` (the second frame blends the first one's
history, then the state is restored): JAX runs op by op under
``jax.disable_jit()``, ~35 s a frame."""

from test_torch_multistate_frames import check_fused_loop_against_jax

from _torch_multistate_scene import one_torch_thread  # noqa: F401


def test_fused_loop_with_ages_through_the_sliced_path_matches_jax():
    check_fused_loop_against_jax("per_frame", frames=2)
