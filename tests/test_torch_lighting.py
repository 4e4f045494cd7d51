"""The port's extended-lighting modules against the JAX package: the cube
face normal, the BRDF, the soft-shadow jitter, the hit geometry, and the
plain versions of K2 (occlusion sweep) and K3 (cell state) against the JAX
package's ``shadow_occlusion_batch`` / ``cell_state_batch`` (Pallas kernels
in interpret mode) on the same numpy inputs.  Plus the Engine faults this
slice repaired: ``indirect_bounces`` reaches the renderer, and
``gi_temporal`` rotates its sample with the frame count.

Tolerances: K2 and K3 flags equal on every (query, pixel); cube normals
equal; BRDF within rtol 1e-5 / atol 1e-7 (the same IEEE operations in the
same order; XLA may fuse them differently); hit geometry equal but q within
atol 1e-6 (XLA:CPU's rsqrt and the ray matmul round differently); the
jitter hash equal on all but ≤ 2 % of values (sin rounding, see
_torch_lighting_scene.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cellularautomatons3d_tpu.render import brdf as jbrdf
from cellularautomatons3d_tpu.render import intersect as jint
from cellularautomatons3d_tpu.render import render_slab as jrs
from cellularautomatons3d_tpu.render import renderer as jren

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch import engine as tengine
from cellularautomatons3d_tpu_torch.ops.occupancy import coarse_occupancy
from cellularautomatons3d_tpu_torch.render import brdf, intersect, render_slab
from cellularautomatons3d_tpu_torch.render import renderer
from cellularautomatons3d_tpu_torch.render.render_fast import P_EMIS, P_EMISS, raytrace_tiles

from _torch_lighting_scene import (
    LIGHTING, MAX_FLIPPED_FRACTION, N_RANDOM, H, N, W, jax_frame_queries, scene_cam,
    scene_words,
)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def frame():
    """A full-quality frame's occlusion queries (4 jittered samples, 4 GI
    slots) plus random rays, and its GI slot lookups plus random coords,
    through the JAX kernels once."""
    f = jax_frame_queries()
    jcam = jnp.asarray(f["cam"])
    prepped = jrs.prep_slabs(jnp.asarray(f["words"]), [(0, N)], N)
    occ = jrs.shadow_occlusion_batch(
        jcam, [tuple(jnp.asarray(a) for a in qq) for qq in f["queries"]], prepped,
        grid_size=N, width=W, height=H, interpret=True)
    states = jrs.cell_state_batch(
        [(jnp.asarray(c), jnp.asarray(a)) for c, a in f["slot_coords"]], prepped,
        grid_size=N, width=W, height=H, interpret=True)
    return dict(f, occ=[np.asarray(o) for o in occ], states=[np.asarray(s) for s in states])


def _face_normal_exact(point, origin):
    """The cube face normal in numpy, whose sqrt and divide are IEEE: the
    dominant offset component (ties go to x, then y, then z) divided by its
    length, so ±1 there and 0 elsewhere, and NaN for a zero offset."""
    d = point - origin
    ad = np.abs(d)
    m = ad.max(axis=-1, keepdims=True)
    is_x = ad[:, 0:1] == m
    is_y = (ad[:, 1:2] == m) & ~is_x
    is_z = ~is_x & ~is_y
    n = np.concatenate([np.where(is_x, d[:, 0:1], np.float32(0)),
                        np.where(is_y, d[:, 1:2], np.float32(0)),
                        np.where(is_z, d[:, 2:3], np.float32(0))], axis=-1)
    with np.errstate(invalid="ignore"):
        return (n / np.sqrt((n * n).sum(axis=-1, keepdims=True))).astype(np.float32)


def test_cube_face_normal_matches_jax():
    """Ties between components exercise the x, then y, then z priority.
    The port equals an exact numpy reference bit for bit.  JAX is held to
    that reference with NaNs and signs equal and magnitudes within 1 ulp:
    XLA:CPU's sqrt or divide may round differently on another host CPU
    (ROADMAP queue 3)."""
    rng = np.random.default_rng(3)
    origin = rng.uniform(-0.5, 0.5, (4096, 3)).astype(np.float32)
    d = rng.choice(np.float32([-0.02, -0.01, 0.0, 0.01, 0.02]), (4096, 3))
    d[:2048] += rng.uniform(-0.015, 0.015, (2048, 3)).astype(np.float32)
    point = (origin + d).astype(np.float32)
    exact = _face_normal_exact(point, origin)
    assert np.isnan(exact).any() and (np.abs(exact) == 1.0).any()
    got = intersect.cube_face_normal(t(point), t(origin)).numpy()
    np.testing.assert_array_equal(got, exact)
    want = np.asarray(jint.cube_face_normal(jnp.asarray(point), jnp.asarray(origin)))
    nan = np.isnan(exact)
    np.testing.assert_array_equal(np.isnan(want), nan)
    np.testing.assert_array_equal(np.sign(want[~nan]), np.sign(exact[~nan]))
    np.testing.assert_array_max_ulp(want[~nan], exact[~nan], maxulp=1)


def _brdf_inputs(rng, m=4096):
    origin = (np.floor(rng.uniform(0, N, (m, 3))) + 0.5) / N - 0.5
    face = rng.integers(0, 3, m)
    off = rng.uniform(-0.45, 0.45, (m, 3)) / N
    off[np.arange(m), face] = np.where(rng.random(m) < 0.5, -0.5, 0.5) * 0.85 / N
    point = origin + off
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    coords = np.floor((origin + 0.5) * N).astype(np.int32)
    normal = np.zeros((m, 3), np.float32)
    normal[np.arange(m), face] = np.sign(off[np.arange(m), face])
    unit = lambda a: f32(a / np.linalg.norm(a, axis=-1, keepdims=True))  # noqa: E731
    return dict(
        point=f32(point), origin=f32(origin), coords=coords,
        eye=f32(rng.uniform(-1.5, 1.5, 3)), light=f32(rng.uniform(-1.5, 1.5, (m, 3))),
        radiance=f32(rng.uniform(0.0, 5.0, (m, 3))), normal=normal,
        l=unit(rng.normal(size=(m, 3))), v=unit(rng.normal(size=(m, 3))),
    )


@pytest.mark.parametrize("material", [(0.0, 0.0, 0.0), (0.8, 0.3, 0.1)])
def test_calculate_lighting_at_matches_jax(material):
    x = _brdf_inputs(np.random.default_rng(5))
    kw = dict(grid_size=N, roughness=np.float32(0.29),
              material_color=np.float32(material),
              base_reflectivity=np.float32([0.17, 0.17, 0.17]))
    want = np.asarray(jbrdf.calculate_lighting_at(
        jnp.asarray(x["point"]), jnp.asarray(x["origin"]), jnp.asarray(x["coords"]),
        jnp.asarray(x["eye"]), jnp.asarray(x["radiance"]), jnp.asarray(x["light"]),
        **{k: jnp.asarray(v) if k != "grid_size" else v for k, v in kw.items()}))
    got = brdf.calculate_lighting_at(
        t(x["point"]), t(x["origin"]), t(x["coords"]), t(x["eye"]),
        t(x["radiance"]), t(x["light"]), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert (want > 0).mean() > 0.3


@pytest.mark.parametrize(
    "name", ["trowbridge_reitz_ggx", "schlick_ggx", "fresnel_schlick", "surface_brdf"]
)
def test_brdf_terms_match_jax(name):
    x = _brdf_inputs(np.random.default_rng(6))
    rough, refl = np.float32(0.29), np.float32([0.17, 0.2, 0.5])
    h = x["l"] + x["v"]
    h = (h / np.linalg.norm(h, axis=-1, keepdims=True)).astype(np.float32)
    albedo = np.random.default_rng(1).random((len(h), 3)).astype(np.float32)
    args = {
        "trowbridge_reitz_ggx": (x["normal"], h, rough),
        "schlick_ggx": (x["normal"], x["v"], rough),
        "fresnel_schlick": (h, x["v"], refl),
        "surface_brdf": (x["l"], x["v"], x["normal"], rough, albedo, refl),
    }[name]
    want = np.asarray(getattr(jbrdf, name)(
        *[jnp.asarray(a) for a in args]))
    got = getattr(brdf, name)(
        *[t(a) if isinstance(a, np.ndarray) and a.ndim == 2 else a for a in args]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("k", range(4))
def test_soft_shadow_jitter_matches_jax(k):
    cam = scene_cam()
    want = np.asarray(jrs.soft_shadow_jitter(jnp.asarray(cam), k, W, H))
    got = render_slab.soft_shadow_jitter(cam, k, W, H).numpy()
    assert got.shape == (H, W, 3)
    assert np.abs(got).max() <= 0.08 and np.abs(want).max() <= 0.08
    assert (got != want).mean() <= 0.02


def test_soft_shadow_jitter_tensor_index_equals_static():
    """The temporally amortized mode's table form gives each static
    sample bit for bit."""
    cam = scene_cam()
    for k in range(4):
        static = render_slab.soft_shadow_jitter(cam, k, W, H)
        rotated = render_slab.soft_shadow_jitter(cam, torch.tensor(k), W, H, nk=4)
        assert torch.equal(static, rotated)
    with pytest.raises(ValueError, match="nk"):
        render_slab.soft_shadow_jitter(cam, torch.tensor(1), W, H)


def test_hit_geometry_matches_jax(frame):
    vol = ct.from_reference(frame["words"], device="cpu")
    _, depth, idx = raytrace_tiles(vol, coarse_occupancy(vol), frame["cam"],
                                   grid_size=N, width=W, height=H, shadow=False)
    np.testing.assert_array_equal(idx.numpy(), frame["idx"])
    got = [a.numpy() for a in render_slab.hit_geometry(
        frame["cam"], idx, depth, grid_size=N, width=W, height=H)]
    q, origin, coords, found, tf = frame["geo"]
    np.testing.assert_allclose(got[0], q, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[1], origin)
    np.testing.assert_array_equal(got[2], coords)
    np.testing.assert_array_equal(got[3], found)
    np.testing.assert_allclose(got[4], tf, atol=1e-6, rtol=0)


def test_k2_plain_matches_jax(frame):
    """K2's plain version on the JAX kernel's inputs: every flag equal, for
    the frame's 4 soft-shadow samples and 4 GI slots and for random rays."""
    prepped = render_slab.prep_volume(ct.from_reference(frame["words"], device="cpu"))
    got = render_slab.shadow_occlusion_batch(
        frame["cam"], [tuple(t(a) for a in qq) for qq in frame["queries"]],
        prepped, grid_size=N, width=W, height=H)
    assert len(got) == 8 + N_RANDOM
    for i, (g, want) in enumerate(zip(got, frame["occ"])):
        np.testing.assert_array_equal(g.numpy(), want, err_msg=f"query {i}")
    occluded = np.stack(frame["occ"])
    assert occluded[:8].sum() > 20 and occluded[8:].sum() > 100
    start, target, _, _ = frame["queries"][-1]
    assert not occluded[-1][target[..., 2] == start[..., 2]].any()


def test_k3_plain_matches_jax(frame):
    """Equal on every active lane.  An inactive lane is 0 in the port; the
    JAX kernel returns its cell's state there whenever an active lane of
    the same strip made it visit that z group (its group gate ORs over
    active lanes only).  Every caller masks inactive lanes."""
    prepped = render_slab.prep_volume(ct.from_reference(frame["words"], device="cpu"))
    got = render_slab.cell_state_batch(
        [(t(c), t(a)) for c, a in frame["slot_coords"]], prepped,
        grid_size=N, width=W, height=H)
    for g, want, (_, active) in zip(got, frame["states"], frame["slot_coords"]):
        g = g.numpy()
        np.testing.assert_array_equal(g[active], want[active])
        assert not g[~active].any()
    assert sum(s.sum() for s in frame["states"]) > 50


def test_k2_k3_wrappers_do_not_fall_back(frame):
    """The CUDA wrappers refuse CPU tensors; a non-CPU batch takes the
    kernel path, which raises here rather than running the plain version."""
    vol = ct.from_reference(frame["words"], device="cpu")
    prepped = render_slab.prep_volume(vol)
    start, target, excl, active = render_slab.stack_occlusion_queries(
        [tuple(t(a) for a in qq) for qq in frame["queries"][:2]], W, H)
    with pytest.raises(ValueError, match="CUDA tensor"):
        render_slab.shadow_sweep_cuda(vol, prepped.coarse, prepped.box, start, target, excl,
                                      active, grid_size=N, cell_half=0.01)
    with pytest.raises(ValueError, match="CUDA tensor"):
        render_slab.cell_state_cuda(vol, excl, active, grid_size=N)
    meta = render_slab.Prepped(*(t.to("meta") for t in prepped))
    with pytest.raises((ValueError, RuntimeError)):
        render_slab.shadow_occlusion_batch(
            frame["cam"], [tuple(t(a).to("meta") for a in frame["queries"][0])],
            meta, grid_size=N, width=W, height=H)
    assert render_slab.shadow_sweep_cuda.launches == 0
    assert render_slab.cell_state_cuda.launches == 0


def _engine(**kw):
    return ct.Engine(grid_size=N, width=W, height=H, device="cpu",
                     light_radius=0.08, **{**LIGHTING, **kw})


def test_engine_passes_indirect_bounces():
    """Fault: the Engine dropped ``indirect_bounces``, so a two-bounce
    configuration rendered one bounce."""
    one, two = _engine(), _engine(indirect_bounces=2)
    assert (one.render_static.indirect_bounces, two.render_static.indirect_bounces) == (1, 2)
    for eng in (one, two):
        eng.set_state_dense(ct.unpack_grid(scene_words()))
    f1, f2 = one.render(), two.render()
    # The second bounce adds light (non-negative) somewhere.
    assert torch.all(f2 >= f1 - 1e-6) and torch.any(f2 > f1 + 1e-4)


def test_engine_gi_temporal_rotates_sample(monkeypatch):
    """Fault: the Engine kept no frame count, so the temporal mode never
    rotated its soft-shadow sample and GI slot.  Each render passes its
    frame count; run_fused counts from 0 itself."""
    seen = []
    real = tengine.render_frame_fast

    def spy(s, packed, params, history, camera_static, sample_idx=None):
        seen.append(sample_idx)
        return real(s, packed, params, history, camera_static, sample_idx)

    monkeypatch.setattr(tengine, "render_frame_fast", spy)
    eng = _engine(gi_temporal=True)
    eng.set_state_dense(ct.unpack_grid(scene_words()))
    frames = [eng.render() for _ in range(4)]
    assert seen == [0, 1, 2, 3] and eng._render_count == 4
    assert all(bool(torch.isfinite(f).all()) for f in frames)
    seen.clear()
    _engine().render()
    assert seen == [None]
    # The rotation changes the lighting: samples 0 and 1 differ.
    from cellularautomatons3d_tpu_torch.render.renderer_fast import trace_shaded

    vol = ct.from_reference(scene_words(), device="cpu")
    a = trace_shaded(eng.render_static, vol, scene_cam(), 0)[0]
    b = trace_shaded(eng.render_static, vol, scene_cam(), 1)[0]
    assert not torch.equal(a, b)


def test_face_index_and_layers_match_jax():
    normals = np.float32([[-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0],
                          [0, 0, -1], [0, 0, 1], [np.nan, 0, 0]])
    want = np.asarray(jren._face_index(jnp.asarray(normals)))
    np.testing.assert_array_equal(renderer._face_index(t(normals)).numpy(), want)
    np.testing.assert_array_equal(renderer._INDIRECT_LAYERS, jren._INDIRECT_LAYERS)


# The lighting passes' modes against JAX's lighting_passes: (Lighting
# arguments, the frame fixture's occlusion queries and GI lookups they take).
PASSES = {
    "full_quality": (dict(soft_k=4, gi=True), range(8), range(4)),
    "soft": (dict(soft_k=4), range(4), ()),
    "gi": (dict(gi=True), range(4, 8), range(4)),
    **{f"gi_temporal_{k}": (dict(soft_k=4, jitter_k=k, gi=True, gi_slot=k), (k, 4 + k), (k,))
       for k in range(4)},
}


@pytest.mark.parametrize("name", list(PASSES))
def test_lighting_twins_match_jax_lighting_passes(frame, name, monkeypatch):
    """The two lighting kernels' twins against JAX's ``lighting_passes`` on
    the frame's hits, with the occlusion flags and neighbour states of the
    JAX kernels from the module's frame (JAX's ``shadow_occlusion_batch`` and
    ``cell_state_batch`` hand them back here, so no kernel runs again): the
    queries twin's operands against the queries JAX forms (cells and masks
    equal, points within 1e-6, the jittered targets on all but 2 % of
    values), and the shade twin's light on a white frame (the quotient plus
    the GI and the emissive light on hits) against JAX's quotient and GI on
    all but the grazing pixels of tests/_torch_lighting_scene.py."""
    kw_light, qi, si = PASSES[name]
    seen = {}

    def occlusion_batch(cam, queries, prepped, **kw):
        seen["queries"] = queries
        assert len(queries) == len(qi)
        return [jnp.asarray(frame["occ"][i]) for i in qi]

    def state_batch(queries, prepped, **kw):
        assert len(queries) == len(si)
        return [jnp.asarray(frame["states"][i]) for i in si]

    monkeypatch.setattr(jrs, "shadow_occlusion_batch", occlusion_batch)
    monkeypatch.setattr(jrs, "cell_state_batch", state_batch)
    light = render_slab.Lighting(**kw_light)
    q, origin, coords, found, _ = frame["geo"]
    occl, gi = jrs.lighting_passes(
        jnp.asarray(frame["cam"]), *(jnp.asarray(a) for a in (q, origin, coords, found)), None,
        grid_size=N, width=W, height=H, soft_k=light.soft_k, jitter_k=light.jitter_k,
        gi=light.gi, gi_slot=light.gi_slot)
    kw = dict(grid_size=N, width=W, height=H)
    idx, depth = t(frame["idx"]), t(frame["depth"])
    start, target, excl, active = (a.numpy() for a in render_slab.lighting_queries_stacked(
        frame["cam"], idx, depth, light, **kw))
    for i, query in enumerate(seen["queries"]):
        s_, tg, e, a = (np.asarray(x) for x in query)  # targets broadcast to [H, W, 3]
        np.testing.assert_array_equal(active[i], a, err_msg=f"query {i}")
        np.testing.assert_array_equal(excl[i], np.moveaxis(e, -1, 0), err_msg=f"query {i}")
        on = a[None].repeat(3, 0)
        np.testing.assert_allclose(start[i][on], np.moveaxis(s_, -1, 0)[on], atol=1e-6, rtol=0)
        assert (target[i] != np.moveaxis(tg, -1, 0)).mean() <= 0.02, f"query {i}"
    flags = t(np.stack([frame["occ"][i] for i in qi]).astype(np.int32))
    states = t(np.stack([frame["states"][i] for i in si]).astype(np.uint8)) if si else None
    got = render_slab.lighting_shade(frame["cam"], idx, depth, flags, states, light,
                                     rgb=torch.ones((H, W, 3)), **kw).numpy()
    want = np.ones((H, W, 3), np.float32)
    if occl is not None:
        want = want * np.asarray(occl)[..., None]
    if gi is not None:
        want = want + np.where(found[..., None], np.asarray(gi), 0.0)
    cam = frame["cam"]
    want = np.where(found[..., None], want + cam[P_EMIS : P_EMIS + 3] * cam[P_EMISS], want)
    hits = found.sum()
    far = ~np.isclose(got, want, rtol=3e-3, atol=3e-4).all(axis=-1)
    assert far.sum() <= MAX_FLIPPED_FRACTION * hits, f"{far.sum()} of {hits} hit pixels"
    assert not (far & ~found).any()
    assert hits > 50 and (got != 1.0).any()
