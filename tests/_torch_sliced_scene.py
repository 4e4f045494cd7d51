"""Shared scenes and checks of the sliced-path tests (tests/test_torch_sliced*.py).

The JAX side is ``render_slab.raytrace_sliced`` at 64³ / 128×64 with
32-plane slabs and 32-cell x-bricks (2 × 2 = 4 bricks), so its per-brick
primary kernel, the min-t composite and the per-brick occlusion passes all
run; its Pallas kernels run in interpret mode under ``jax.disable_jit()``
(as tests/test_render_slab.py runs them: jitted interpret compiles of these
graphs crash XLA:CPU).  The port traces the whole volume at once.

Contract: ids equal (the port keeps the first hit in plane order, the
reference the first brick processed, which differ only on exact-t ties
between distinct cells; a mismatch fraction above 1e-4 fails, and at 8,192
pixels that is any mismatch), depth within atol 3e-5, rgb within rtol 3e-3
/ atol 3e-4 on every pixel of a hard-shadow frame.  Soft-shadow frames
allow the penumbra pixels of tests/_torch_lighting_scene.py.
"""

import numpy as np

N = 64
W, H = 128, 64
BRICKS = dict(slab_planes=32, x_chunk_cells=32)
ID_MISMATCH_LIMIT = 1e-4


def random_words(seed, p, n=N) -> np.ndarray:
    """Packed uint32 words of a random volume of density ``p``."""
    from cellularautomatons3d_tpu_torch import pack_grid

    rng = np.random.default_rng(seed)
    return pack_grid((rng.random((n, n, n)) < p).astype(np.uint8))


def view(name: str) -> np.ndarray:
    from cellularautomatons3d_tpu_torch.utils import mat4

    if name == "front":
        return mat4.initial_view_matrix()
    assert name == "rotated"
    return mat4.translate(
        mat4.rotate(mat4.initial_view_matrix(), (0, 1, 0), 1.1), (0, 0, 0.2)
    )


def scene_cam(view_name="front", width=W, height=H, **kw) -> np.ndarray:
    from cellularautomatons3d_tpu_torch.render.render_fast import pack_cam

    return pack_cam(
        view(view_name), width=width, height=height,
        light_pos=(0.721, 1.0, 1.0), light_magnitude=5.0, cell_size=0.85,
        roughness=0.29, base_reflectivity=(0.17, 0.17, 0.17),
        material_color=(0.0, 0.0, 0.0), **kw,
    )


def jax_sliced(words, cam, n=N, bricks=BRICKS, **kw):
    """JAX ``raytrace_sliced`` over 4 bricks (or ``bricks`` of an ``n``³
    grid): numpy (rgb, depth, idx)."""
    import jax
    import jax.numpy as jnp

    from cellularautomatons3d_tpu.render.render_slab import raytrace_sliced

    with jax.disable_jit():
        out = raytrace_sliced(
            jnp.asarray(words), jnp.asarray(cam), grid_size=n, width=W,
            height=H, interpret=True, **bricks, **kw,
        )
        return tuple(np.asarray(a) for a in out)


def torch_sliced(words, cam, n=N, **kw):
    """The port's ``raytrace_sliced`` (CPU): numpy (rgb, depth, idx)."""
    import cellularautomatons3d_tpu_torch as ct
    from cellularautomatons3d_tpu_torch.render.render_slab import raytrace_sliced

    out = raytrace_sliced(ct.from_reference(words), cam, grid_size=n, width=W,
                          height=H, **kw)
    return tuple(a.numpy() for a in out)


def torch_primary(words, cam):
    """The plain K4: numpy (t, idx)."""
    import cellularautomatons3d_tpu_torch as ct
    from cellularautomatons3d_tpu_torch.render.render_slab import primary_sweep

    out = primary_sweep(ct.from_reference(words), cam, grid_size=N, width=W,
                        height=H)
    return tuple(a.numpy() for a in out)


def assert_ids_close(idx, want_idx):
    bad = idx != want_idx
    assert bad.mean() <= ID_MISMATCH_LIMIT, f"{bad.sum()} ids differ"
    assert (want_idx >= 0).sum() > 500  # the scene is visible


def assert_primary_close(primary, want):
    """K4 (t, idx) against the reference frame's (depth, idx) on its hits."""
    t, idx = primary
    assert_ids_close(idx, want[2])
    hit = (idx == want[2]) & (idx >= 0)
    np.testing.assert_allclose(t[hit], want[1][hit], atol=3e-5, rtol=0)
    assert (t[idx < 0] == 0).all()


def assert_frame_close(got, want, max_flipped=0):
    """A sliced frame against the reference's: ids, depth, and rgb on all
    but ``max_flipped`` pixels (flipped occlusion flags)."""
    rgb, depth, idx = got
    assert_ids_close(idx, want[2])
    same = idx == want[2]
    np.testing.assert_allclose(depth[same], want[1][same], atol=3e-5, rtol=0)
    close = np.isclose(rgb, want[0], rtol=3e-3, atol=3e-4).all(axis=-1)
    flipped = ~close & same
    assert flipped.sum() <= max_flipped, (
        f"{flipped.sum()} pixels outside the rgb tolerance (max {max_flipped})"
    )
    assert (rgb[idx < 0] == 0).all()  # misses are black
