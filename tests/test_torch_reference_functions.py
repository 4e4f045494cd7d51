"""The reference pipeline's pure functions: the port's ``render.intersect``
additions, ``render.raymarch``, ``brdf.calculate_lighting_at_simple`` and
``renderer._texture_load`` against the JAX package's on the same numpy
inputs (32³ volumes).

Integer results (cell coordinates, ids, states, texel indices, march flags)
are held equal; float results that go through a sqrt or a divide are held
within a stated rtol, never bit for bit (XLA:CPU's may round otherwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellularautomatons3d_tpu.render import brdf as jb
from cellularautomatons3d_tpu.render import intersect as ji
from cellularautomatons3d_tpu.render import raymarch as jm
from cellularautomatons3d_tpu.render import renderer as jr
from cellularautomatons3d_tpu.render.camera import get_ray as jax_get_ray
from cellularautomatons3d_tpu.render.camera import pixel_uvs as jax_pixel_uvs

from _torch_multistate_scene import one_torch_thread  # noqa: F401  (autouse)
from _torch_reference_scene import H, N, W, random_words
from cellularautomatons3d_tpu_torch.render import brdf as tb
from cellularautomatons3d_tpu_torch.render import intersect as ti
from cellularautomatons3d_tpu_torch.render import raymarch as tm
from cellularautomatons3d_tpu_torch.render import renderer as tr
from cellularautomatons3d_tpu_torch.render.camera import pixel_uvs
from cellularautomatons3d_tpu_torch.utils import mat4

SPECIALS = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 2147483520.0, 2.5, -2.5, -0.5,
                     0.0, -0.0, 63.99, 64.0, 1e30], np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def points(seed, n, lo=-0.6, hi=0.6):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(np.float32)


def test_to_int32_saturates_as_xla():
    want = np.asarray(jnp.asarray(SPECIALS).astype(jnp.int32))
    np.testing.assert_array_equal(ti.to_int32(t(SPECIALS)).numpy(), want)


def test_sd_box_matches_jax():
    p = points(1, 4096, -1.0, 1.0)
    for b in (0.5, np.array([0.1, 0.2, 0.3], np.float32)):
        want = np.asarray(ji.sd_box(jnp.asarray(p), jnp.asarray(b)))
        got = ti.sd_box(t(p), b if np.isscalar(b) else t(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        assert (np.sign(got) == np.sign(want)).all()


def test_cell_from_sample_point_matches_jax():
    """Points inside and far outside the volume (to ±40 cube widths), and
    non-finite ones."""
    p = np.concatenate([points(2, 2048), points(3, 2048, -40.0, 40.0),
                        SPECIALS[:12].reshape(4, 3)])
    jc, jo, jidx = (np.asarray(a) for a in ji.cell_from_sample_point(jnp.asarray(p), N))
    tc, to, tidx = (a.numpy() for a in ti.cell_from_sample_point(t(p), N))
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_allclose(to, jo, rtol=1e-6, atol=0)
    assert (tc >= 0).all()


def test_get_cell_state_wraps_far_outside_the_volume():
    """Non-negative coordinates up to int32's end read ``(x // 32) % W``, bit
    ``x % 32``, ``y % n``, ``z % n``, as in JAX; and equal the dense grid's
    cell at the wrapped coordinates."""
    from cellularautomatons3d_tpu_torch import unpack_grid

    words = random_words(4, 0.3)
    rng = np.random.default_rng(5)
    coords = np.concatenate([
        rng.integers(0, N, (1024, 3)),
        rng.integers(0, 2**31 - 1, (2048, 3)),
        np.array([[2**31 - 1] * 3, [N, 2 * N + 3, N - 1], [0, 0, 0], [31, 32, 33]]),
    ]).astype(np.int32)
    want = np.asarray(ji.get_cell_state(jnp.asarray(words).reshape(-1), jnp.asarray(coords), N))
    got = ti.get_cell_state(t(words.view(np.int32)).reshape(-1), t(coords), N).numpy()
    np.testing.assert_array_equal(got, want)
    dense = unpack_grid(words)  # [Z, Y, X]
    c = coords % N
    np.testing.assert_array_equal(got, dense[c[:, 2], c[:, 1], c[:, 0]])
    assert 0.2 < got.mean() < 0.4


def test_nrand_n1rand_hash():
    """The sin-fract hash: float64 ``sin`` rounded once (the port's numpy
    reference, exact), in [0, 1), and equal to eager JAX on at least 98.5 %
    of the values: XLA's float32 ``sin`` is not correctly rounded on ~1.3 %
    of its inputs, so no test holds it bit for bit.  Measured: nrand 98.70 %
    on the window's uvs and 98.87 % on 100 000 random inputs, n1rand 98.93 %
    at both times."""
    uv = np.asarray(jax_pixel_uvs(W, H)).reshape(-1, 2)
    np.testing.assert_array_equal(pixel_uvs(W, H).reshape(-1, 2).numpy(), uv)
    rnd = np.random.default_rng(6).uniform(-1.0, 1.1, (100_000, 2)).astype(np.float32)
    for x in (uv, rnd):
        d = (x[:, 0] * np.float32(12.9898) + x[:, 1] * np.float32(78.233)).astype(np.float32)
        v = np.sin(d.astype(np.float64)).astype(np.float32) * np.float32(43758.5453)
        got = ti.nrand(t(x)).numpy()
        np.testing.assert_array_equal(got, v - np.floor(v))
        assert ((got >= 0) & (got < 1)).all()
        assert (got == np.asarray(ji.nrand(jnp.asarray(x)))).mean() >= 0.985
    for time in (0.1, 12.345):
        got = ti.n1rand(t(uv), np.float32(time)).numpy()
        want = np.asarray(ji.n1rand(jnp.asarray(uv), jnp.float32(time)))
        assert (got == want).mean() >= 0.985
        np.testing.assert_array_equal(got, ti.n1rand(t(uv), np.float32(time)).numpy())
        base = np.float32(0.07) * (np.float32(time) - np.floor(np.float32(time)))
        np.testing.assert_array_equal(got, ti.nrand(t(uv + base)).numpy())


def test_view_rays_within_ulps_of_jax():
    """The world rays, ``view_mat[:3, :3] @ get_ray(uv)`` per component and
    summed left to right, against JAX's jitted matmul (XLA:CPU contracts it
    into FMAs): measured within 2, 3 and 4 ulps of the ray's largest
    component on these three views."""
    uv = np.asarray(jax_pixel_uvs(W, H)).reshape(-1, 2)
    view0 = mat4.initial_view_matrix()
    views = [view0, mat4.rotate(mat4.translate(view0, (0.03, 0.01, -0.02)), (0, 1, 0), 0.05),
             mat4.rotate(view0, (1, 1, 0), 0.7)]

    def rays(view, x):
        return (view[:3, :3] @ jax_get_ray(x, jnp.array([W, H], jnp.float32))[..., None])[..., 0]

    for view in views:
        view = np.asarray(view, np.float32)
        want = np.asarray(jax.jit(rays)(jnp.asarray(view), jnp.asarray(uv)))
        got = tr._view_rays(view, t(uv), W, H).numpy()
        unit = np.spacing(np.abs(want).max(-1, keepdims=True))
        assert (np.abs(got - want) / unit).max() <= 8


def test_calculate_lighting_at_simple_matches_jax():
    p = points(8, 4096, -0.5, 0.5)
    coords, origin, _ = ti.cell_from_sample_point(t(p), N)
    cam = np.array([0.1, -0.05, 0.75], np.float32)
    light = np.array([0.721, 1.0, 1.0], np.float32)
    got = tb.calculate_lighting_at_simple(
        t(p), origin, coords, t(cam), t(light), np.float32(5.0), grid_size=N).numpy()
    want = np.asarray(jb.calculate_lighting_at_simple(
        jnp.asarray(p), jnp.asarray(origin.numpy()), jnp.asarray(coords.numpy()),
        jnp.asarray(cam), jnp.asarray(light), jnp.float32(5.0), grid_size=N))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.isfinite(got).all() and (got > 0).any()


@pytest.mark.parametrize("jit", [False, True])
def test_texture_load_on_nonfinite_and_out_of_range_uv(jit):
    """NaN, ±inf and out-of-range uv (a point on the previous camera's plane)
    read the texel JAX reads: saturating truncation, then the clamp."""
    img = np.random.default_rng(9).random((H, W, 2)).astype(np.float16)
    u = np.concatenate([SPECIALS, np.random.default_rng(10).uniform(-2, 3, 64)])
    u = u.astype(np.float32)
    uv = np.stack(np.meshgrid(u, u, indexing="ij"), -1).reshape(-1, 2)
    load = lambda i, x: jr._texture_load(i, x, W, H)  # noqa: E731
    want = np.asarray((jax.jit(load) if jit else load)(jnp.asarray(img), jnp.asarray(uv)))
    got = tr._texture_load(t(img), t(uv), W, H).numpy()
    np.testing.assert_array_equal(got, want)


def march_inputs(seed, n=4096):
    """Shadow-march operands: random starts inside the volume, ends at the
    volume's exit toward a light, a random offset and an active flag per
    ray."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(-0.49, 0.49, (n, 3)).astype(np.float32)
    light = np.array([0.721, 1.0, 1.0], np.float32)
    d = light - start
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tt = np.min(np.where(d > 0, (0.5 - start) / d, (-0.5 - start) / d), axis=-1)
    end = (start + d * tt[:, None]).astype(np.float32)
    rnd = rng.random(n).astype(np.float32)
    active = rng.random(n) < 0.9
    return start, end, rnd, active


@pytest.mark.parametrize("min_cell_step", [True, False])
def test_ray_march_shadow_matches_jax_on_identical_offsets(min_cell_step):
    """Given the same offsets only geometry can differ: the flags equal
    eager JAX's and the jitted JAX's."""
    words = random_words(11, 0.15)
    start, end, rnd, active = march_inputs(12)
    cells = ti.cell_from_sample_point(t(start), N)[0]
    kw = dict(grid_size=N, cell_size_mul=np.float32(0.85), shadow_samples=30,
              min_cell_step=min_cell_step)
    got = tm.ray_march_shadow(t(words.view(np.int32)).reshape(-1), t(start), t(end), cells,
                              t(rnd), active=t(active), **kw).numpy()
    jkw = dict(kw, cell_size_mul=jnp.float32(0.85))

    def jax_march(w, s, e, c, r, a):
        return jm.ray_march_shadow(w, s, e, c, r, active=a, **jkw)

    args = [jnp.asarray(a) for a in (words.reshape(-1), start, end, cells.numpy(), rnd, active)]
    for fn in (jax_march, jax.jit(jax_march)):
        np.testing.assert_array_equal(got, np.asarray(fn(*args)))
    occluded = got < 1
    assert 0.05 < occluded.mean() < 0.95 and not occluded[~active].any()
    assert set(np.unique(got)) <= {np.float32(tm.OCCLUSION_FACTOR), np.float32(1.0)}


def test_ray_march_depth_matches_eager_jax():
    """The first-hit march from the volume's near face: hit flags equal
    eager JAX's, hit points within rtol 1e-6."""
    words = random_words(13, 0.05)
    rng = np.random.default_rng(14)
    start = np.concatenate([rng.uniform(-0.5, 0.5, (2048, 2)),
                            np.full((2048, 1), 0.5)], 1).astype(np.float32)
    end = (start + rng.uniform(-0.3, 0.3, (2048, 3)) - [0, 0, 1]).astype(np.float32)
    uv = rng.random((2048, 2)).astype(np.float32)
    kw = dict(grid_size=N, depth_samples=35)
    got_p, got_f = tm.ray_march_depth(t(words.view(np.int32)).reshape(-1), t(start), t(end),
                                      t(uv), np.float32(0.1), cell_size_mul=0.85, **kw)
    want_p, want_f = jm.ray_march_depth(
        jnp.asarray(words.reshape(-1)), jnp.asarray(start), jnp.asarray(end),
        jnp.asarray(uv), jnp.float32(0.1), cell_size_mul=jnp.float32(0.85), **kw)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-6, atol=1e-7)
    assert 0.2 < got_f.numpy().mean() < 0.9
