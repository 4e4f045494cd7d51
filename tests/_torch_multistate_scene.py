"""Shared scenes of the multi-state tests (tests/test_torch_multistate*.py):
numpy-seeded volumes of valid Generations ages, packed into age bit-planes
as both Engines pack them, and the visibility plane (age >= 1) the renderers
trace."""

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for a file's many small torch ops: the suite runs
    several workers, and a thread pool per worker oversubscribes the cores
    (restored after the file).  Each multi-state and reference-pipeline
    test file imports it."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_ages(n, total_states, seed, p_dead):
    """Dense uint8 [n, n, n] of valid ages 0..S-1."""
    rng = np.random.default_rng(seed)
    ages = rng.integers(1, total_states, (n, n, n)).astype(np.uint8)
    ages[rng.random((n, n, n)) < p_dead] = 0
    return ages


def pack_ages(ages, nbits):
    """uint32 [B, W, Z, Y] age planes."""
    from cellularautomatons3d_tpu_torch import pack_grid

    return np.stack([pack_grid((ages >> i) & 1) for i in range(nbits)])


def visibility(planes):
    """uint32 [W, Z, Y]: the OR of the age planes."""
    return np.bitwise_or.reduce(planes, axis=0)


def hit_ages(ages, idx):
    """The dense ages at the hit ids (x + y·n + z·n², the dense grid's flat
    order); 1 where nothing was hit."""
    return np.where(idx >= 0, ages.reshape(-1)[np.maximum(idx, 0)], 1).astype(np.int32)


S_SLICED = 10  # the sliced tests' rule: 10 states, 4 age planes


def sliced_scene(n, p_dead):
    """(dense ages, age planes, visibility plane) at ``n``³."""
    ages = random_ages(n, S_SLICED, 21, p_dead)
    planes = pack_ages(ages, 4)
    return ages, planes, visibility(planes)


def check_sliced_frame_with_ages(kw, cam_kw, max_flipped, n, p_dead, bricks):
    """The port's ``raytrace_sliced(ages=…)`` frame against JAX's over
    ``bricks`` of an ``n``³ grid, and against the binary frame of the same
    visibility plane: the ages dim the hit pixels of dying cells, and only
    those.  JAX's eager interpret mode costs ~25 s per kernel call and brick
    whatever the frame's size, so the callers keep the bricks few.  Returns
    (ages, planes, vis, cam, JAX's frame)."""
    import jax.numpy as jnp

    import cellularautomatons3d_tpu_torch as ct
    from _torch_sliced_scene import assert_frame_close, jax_sliced, scene_cam, torch_sliced

    ages, planes, vis = sliced_scene(n, p_dead)
    cam = scene_cam("front", **cam_kw)
    jkw = dict(kw)
    if "sample_idx" in jkw:
        jkw["sample_idx"] = jnp.int32(jkw["sample_idx"])
    want = jax_sliced(vis, cam, n, bricks, ages=jnp.asarray(planes),
                      total_states=S_SLICED, **jkw)
    got = torch_sliced(vis, cam, n, ages=ct.from_reference(planes, device="cpu"),
                       total_states=S_SLICED, **kw)
    assert_frame_close(got, want, max_flipped=max_flipped)
    binary = torch_sliced(vis, cam, n, **kw)
    np.testing.assert_array_equal(binary[2], got[2])
    dying = hit_ages(ages, got[2]) > 1
    assert dying.sum() > 500
    assert (got[0][dying] <= binary[0][dying]).all()
    assert (got[0][dying] < binary[0][dying]).any()
    np.testing.assert_array_equal(got[0][~dying], binary[0][~dying])
    return ages, planes, vis, cam, want
