"""The scene of tests/test_gi_temporal.py (N=32, 64×32, a 30 %-dense 10³
blob, light_radius 0.08), made with numpy for the JAX package and the
port's extended-lighting and occlusion tests (tests/test_torch_lighting*.py,
tests/test_torch_occlusion_multi.py)."""

import numpy as np

N = 32
W, H = 64, 32
LIGHTING = dict(indirect_lighting=True, soft_shadow_samples=4)
N_RANDOM = 4  # random occlusion rays beside a frame's 8 queries
P_LIGHT, P_CELLMUL = 14, 18


def scene_words() -> np.ndarray:
    """Packed uint32 [N/32, N, N] words of the blob scene."""
    from cellularautomatons3d_tpu_torch import pack_grid

    rng = np.random.default_rng(11)
    dense = np.zeros((N, N, N), np.uint8)
    dense[11:21, 11:21, 11:21] = rng.random((10, 10, 10)) < 0.3
    return pack_grid(dense)


def scene_cam() -> np.ndarray:
    """The kernels' f32 parameter vector of the scene's camera and light."""
    from cellularautomatons3d_tpu_torch.render.render_fast import pack_cam
    from cellularautomatons3d_tpu_torch.utils import mat4

    return pack_cam(
        mat4.initial_view_matrix(), width=W, height=H,
        light_pos=(0.721, 1.0, 1.0), light_magnitude=5.0,
        cell_size=0.85, roughness=0.29,
        base_reflectivity=(0.17, 0.17, 0.17),
        material_color=(0.0, 0.0, 0.0),
        light_radius=0.08, elapsed_time=0.37,
    )


def jax_trace_shaded(static_kw, sample_indices=(None,)):
    """JAX ``trace_shaded`` (Pallas kernels in interpret mode, one jit) on
    the scene: a list of numpy (rgb, depth, idx), one per sample index."""
    import jax.numpy as jnp

    from cellularautomatons3d_tpu.render.renderer import RenderStatic
    from cellularautomatons3d_tpu.render.renderer_fast import trace_shaded

    s = RenderStatic(width=W, height=H, grid_size=N, **static_kw)
    vol, cam = jnp.asarray(scene_words()), jnp.asarray(scene_cam())
    out = []
    for k in sample_indices:
        res = trace_shaded(s, vol, cam, None, 2, True,
                           None if k is None else jnp.int32(k))
        out.append(tuple(np.asarray(a) for a in res))
    return out


def torch_trace_shaded(static_kw, sample_idx=None):
    """The port's ``trace_shaded`` on the scene (CPU): numpy (rgb, depth,
    idx)."""
    import cellularautomatons3d_tpu_torch as ct
    from cellularautomatons3d_tpu_torch.render.renderer import RenderStatic
    from cellularautomatons3d_tpu_torch.render.renderer_fast import trace_shaded

    s = RenderStatic(width=W, height=H, grid_size=N, **static_kw)
    res = trace_shaded(s, ct.from_reference(scene_words()), scene_cam(), sample_idx)
    return tuple(a.numpy() for a in res)


# Port against JAX, trace_shaded: ids equal, depth within 3e-5 and rgb
# within rtol 3e-3 / atol 3e-4 (the K1 contract), except on pixels where
# an occlusion flag flipped.  Flags flip where a shadow ray grazes a cell
# and its inputs differ in the last bits: the port normalises with 1/sqrt
# where XLA:CPU's rsqrt differs by ≤ 2 ulp, and the jitter hash multiplies
# sin by 43758.5453.  The port's hash (sin rounded correctly) equals the
# JAX function run eagerly on ~99 % of values, but jitted XLA:CPU computes
# the hash differently on ~8 % of them, so inside the reference's jitted
# trace_shaded ~9 % of the jitter values differ from the port's.  On this
# scene 0-3 of the 90 hit pixels flip; the bound is 5 % of the hit pixels.
MAX_FLIPPED_FRACTION = 0.05


def assert_frame_close(got, want):
    rgb, depth, idx = got
    np.testing.assert_array_equal(idx, want[2])
    np.testing.assert_allclose(depth, want[1], atol=3e-5, rtol=0)
    hit = want[2] >= 0
    assert hit.sum() > 50
    close = np.isclose(rgb, want[0], rtol=3e-3, atol=3e-4).all(axis=-1)
    flipped = ~close
    assert flipped.sum() <= MAX_FLIPPED_FRACTION * hit.sum(), (
        f"{flipped.sum()} of {hit.sum()} hit pixels outside the rgb tolerance"
    )
    assert not (flipped & ~hit).any()  # misses are black in both


def random_rays(rng):
    """Shadow-ray queries from random starts (inside and outside the
    volume) to random targets; the excluded cell is the start cell, a
    random cell or out of range; a random half of the lanes is active.  In
    the last query half the rays have dz == 0, which never hit."""
    out = []
    for i in range(N_RANDOM):
        start = rng.uniform(-0.7, 0.7, (H, W, 3)).astype(np.float32)
        target = rng.uniform(-1.0, 1.0, (H, W, 3)).astype(np.float32)
        if i == N_RANDOM - 1:
            flat = rng.random((H, W)) < 0.5
            target[..., 2] = np.where(flat, start[..., 2], target[..., 2])
        cell = np.floor((start + 0.5) * N).astype(np.int32)
        excl = np.where(rng.random((H, W, 1)) < 0.5, cell,
                        rng.integers(-1, N + 1, (H, W, 3))).astype(np.int32)
        out.append((start, target, excl, rng.random((H, W)) < 0.5))
    return out


def jax_frame_queries():
    """A full-quality frame's occlusion queries (4 jittered samples, 4 GI
    slots, built from the JAX package's hit geometry) plus N_RANDOM random
    rays, and its 4 GI slot lookups plus 2 of random coords: a dict of numpy
    arrays (words, cam, depth, idx, geo, queries, slot_coords)."""
    import jax.numpy as jnp

    from cellularautomatons3d_tpu.ops.occupancy import coarse_occupancy as jax_coarse
    from cellularautomatons3d_tpu.render import intersect as jint
    from cellularautomatons3d_tpu.render import render_slab as jrs
    from cellularautomatons3d_tpu.render import renderer as jren
    from cellularautomatons3d_tpu.render.render_fast import raytrace_tiles as jax_raytrace

    words, cam = scene_words(), scene_cam()
    vol, jcam = jnp.asarray(words), jnp.asarray(cam)
    _, depth, idx = jax_raytrace(vol, jax_coarse(vol), jcam, grid_size=N,
                                 width=W, height=H, shadow=False, interpret=True)
    geo = [np.asarray(a) for a in jrs.hit_geometry(
        jcam, idx, depth, grid_size=N, width=W, height=H)]
    q, origin, coords, found, _ = geo
    light = cam[P_LIGHT : P_LIGHT + 3]
    queries = []
    for k in range(4):
        jit = np.asarray(jrs.soft_shadow_jitter(jcam, k, W, H))
        queries.append((q, (light + jit).astype(np.float32), coords, found))
    face = np.asarray(jren._face_index(jint.cube_face_normal(jnp.asarray(q), jnp.asarray(origin))))
    cell = np.float32(1.0 / N)
    slot_coords = []
    for i in range(4):
        off = jren._INDIRECT_LAYERS[:, i, :][face]
        n_origin = (coords + off).astype(np.float32) * cell + cell * np.float32(0.5) - np.float32(0.5)
        tn, tf = (np.asarray(a) for a in jint.ray_cube_intersect(
            jnp.asarray(q), jnp.asarray(off.astype(np.float32)), jnp.asarray(n_origin),
            cell * np.float32(cam[P_CELLMUL]) * np.float32(0.5)))
        ok = found & (tn <= tf) & (tf >= 0.0)
        with np.errstate(invalid="ignore"):  # inf * 0 on lanes that are not ok
            n_point = (q + off.astype(np.float32) * tn[..., None]).astype(np.float32)
        n_cl = np.maximum(coords + off, 0).astype(np.int32)
        queries.append((n_point, np.broadcast_to(light, q.shape).astype(np.float32), n_cl, ok))
        slot_coords.append((n_cl, ok))
    rng = np.random.default_rng(7)
    queries += random_rays(rng)
    for _ in range(2):
        slot_coords.append((rng.integers(-3, 2 * N, (H, W, 3)).astype(np.int32),
                            rng.random((H, W)) < 0.7))
    return dict(words=words, cam=cam, depth=np.asarray(depth), idx=np.asarray(idx),
                geo=geo, queries=queries, slot_coords=slot_coords)
