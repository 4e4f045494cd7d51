"""The lighting passes' two kernels from the CPU's side: the queries kernel
(``render_slab.lighting_queries_cuda``, ``csrc/lighting_queries.cu``) and the
shade kernel (``lighting_shade_cuda``, ``csrc/lighting_shade.cu``), through
their plain twins ``lighting_queries_stacked`` and ``lighting_shade``, on the
32³ / 64×32 scene of tests/_torch_lighting_scene.py.

* The twins against the torch chain they recast, bit for bit (NaN where it
  is NaN): the direct-shadow quotient (``lighting_queries``,
  ``shadow_occlusion_batch`` and the quotient), the
  one-bounce GI of ``indirect_bounce(bounces=1)`` and the frame's
  composition (K1's frame times the quotient plus the GI, the emissive
  light, the fused loop's EMA, light cube, overlay and gamma; the sliced
  frame's direct light, age fade and depth), for full quality, soft shadows
  alone, GI alone, ``gi_temporal`` at sample indices 0-3 (as ints and as
  tensors), the sliced path's hard shadow and full quality, and
  ``pyroclastic`` with ages on both paths.
* The queries twin against the JAX package's geometry run eagerly (its
  ``hit_geometry``, ``soft_shadow_jitter`` and GI slot geometry, no Pallas
  kernel) on the same hits: cells and masks equal, points within 1e-6, the
  jittered targets equal on all but 2 % of values (sin rounding, see
  tests/_torch_lighting_scene.py).  The twins against JAX's
  ``lighting_passes``, ``trace_shaded`` and ``raytrace_sliced`` frames are in
  tests/test_torch_lighting.py, test_torch_lighting_frames.py,
  test_torch_sliced.py and test_torch_multistate_sliced.py, beside the JAX
  frames those files compute once.
* The occlusion backends of the stacked queries (K2, K5 in chunks) agree.
* The wrappers refuse a CPU tensor, a wrong dtype or shape, more queries
  than K2 takes, a slot out of range, before the kernel library loads; the
  frame paths on the CPU run the twins and launch nothing.

tests/test_torch_cuda.py holds the kernels against the twins on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cellularautomatons3d_tpu.render import intersect as jint
from cellularautomatons3d_tpu.render import render_slab as jrs
from cellularautomatons3d_tpu.render import renderer as jren

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch import kernels
from cellularautomatons3d_tpu_torch.ops.ca_step import visibility_plane
from cellularautomatons3d_tpu_torch.ops.occupancy import coarse_occupancy
from cellularautomatons3d_tpu_torch.render import render_slab as rs
from cellularautomatons3d_tpu_torch.render.intersect import device_vec, ray_cube_intersect
from cellularautomatons3d_tpu_torch.render.render_fast import (
    P_ALPHA, P_EMIS, P_EMISS, P_GAMMA, P_LIGHT, P_LMAG, P_O, P_OVERLAY, pack_cam, raytrace)
from cellularautomatons3d_tpu_torch.utils import mat4

from _torch_lighting_scene import H, N, W, scene_words, twin_frame

L = rs.Lighting
CASES = {
    "full_quality": dict(soft_k=4, gi=True),
    "soft": dict(soft_k=4),
    "gi": dict(gi=True),
    **{f"gi_temporal_{k}": dict(soft_k=4, jitter_k=k, gi=True, gi_slot=k) for k in range(4)},
}
SLICED_CASES = {"hard": dict(soft_k=1), "full_quality": dict(soft_k=4, gi=True),
                "gi_temporal_2": dict(soft_k=4, jitter_k=2, gi=True, gi_slot=2)}


def cam_of(**kw):
    """The scene's camera with an emissive light and the depth overlay (the
    composition's every step matters), gamma 2.2."""
    base = dict(light_pos=(0.721, 1.0, 1.0), light_magnitude=5.0, cell_size=0.85,
                roughness=0.29, base_reflectivity=(0.17, 0.2, 0.3),
                material_color=(0.0, 0.0, 0.0), light_radius=0.08, elapsed_time=0.37,
                emissive_color=(0.02, 0.03, 0.04), emissive_strength=0.5, gamma=2.2,
                show_overlay=1.0)
    base = dict(width=W, height=H, **base)
    base.update(kw)
    return pack_cam(mat4.initial_view_matrix(), **base)


@pytest.fixture(scope="module")
def vol():
    return ct.from_reference(scene_words(), device="cpu")


@pytest.fixture(scope="module")
def pyroclastic():
    """A ``pyroclastic`` state (age planes) and its visibility plane."""
    eng = ct.Engine(**ct.PRESETS["pyroclastic"], random_initial_state=True, grid_size=N,
                    width=W, height=H, device="cpu")
    eng.step(12)
    return eng.state, visibility_plane(eng.state, eng.spec), eng.spec.total_states


def equal_nan(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def primary(vol, cam, light, *, sliced, ages=None, total_states=2, w=W, h=H):
    """A frame's primary hits as the lighting passes take them: (K1's rgb or
    None, t, idx, K4's age or None)."""
    kw = dict(grid_size=N, width=w, height=h)
    if sliced:
        t, idx, *age = rs.primary_sweep(vol, cam, ages, **kw)
        return None, t, idx, (age[0] if age else None)
    soft = light.soft_k is not None and light.soft_k > 1
    rgb, t, idx = raytrace(vol, coarse_occupancy(vol), cam, shadow=not soft, ages=ages,
                           total_states=total_states, **kw)
    return rgb, t, idx, None


def chain_frame(vol, cam, light, *, sliced, ages=None, total_states=2, hits=None, w=W, h=H):
    """The torch chain the twins recast: the direct-shadow quotient of
    ``lighting_queries`` and ``shadow_occlusion_batch``, the GI of ``indirect_bounce(bounces=1)`` and the
    frame's tail as renderer_fast's ``_extended_lighting`` and ``_shaded``
    (K1) or ``raytrace_sliced`` composed it, with the emissive light, on
    the frame's own hits or on ``hits`` (:func:`primary`'s).  Returns (rgb,
    depth, idx, the ray directions)."""
    kw = dict(grid_size=N, width=w, height=h)
    prepped = rs.prep_volume(vol)
    rgb, t, idx, age = hits or primary(vol, cam, light, sliced=sliced, ages=ages,
                                       total_states=total_states, w=w, h=h)
    q, origin, coords, found, d = rs._hit_geometry(cam, idx, t, N, w, h)
    occl = gi = None
    if light.soft_k is not None:
        queries, _, _ = rs.lighting_queries(cam, q, None, coords, found, soft_k=light.soft_k,
                                            jitter_k=light.jitter_k, **kw)
        occl = rs._soft_occlusion(rs.shadow_occlusion_batch(cam, queries, prepped, **kw),
                                  light.occ_div)
    if light.gi:
        gi = rs.indirect_bounce(vol, cam, q, origin, coords, found, prepped, bounces=1,
                                slot=light.gi_slot, **kw)
    if sliced:
        lpos = device_vec(cam[P_LIGHT : P_LIGHT + 3], "cpu")
        o = device_vec(cam[P_O : P_O + 3], "cpu")
        color = rs._shader(cam, N)(q, origin, coords, o, torch.full_like(q, float(cam[P_LMAG])),
                                   lpos)
        out = torch.clamp(color, min=0.0)
        if age is not None:
            num = (total_states - age).to(torch.float32)
            fade = torch.clamp(num / torch.full_like(num, float(total_states - 1)), 0.0, 1.0)
            occl = fade if occl is None else occl * fade
        if occl is not None:
            out = out * occl[..., None]
        if gi is not None:
            out = out + gi
        out = torch.where(found[..., None], out, 0.0)
        depth = torch.where(found, t, rs.hit_geometry(cam, idx, t, **kw)[4])
    else:
        out, depth = rgb, t
        if occl is not None:
            out = out * occl[..., None]
        if gi is not None:
            out = out + torch.where(found[..., None], gi, 0.0)
    emis = device_vec(cam[P_EMIS : P_EMIS + 3] * cam[P_EMISS], "cpu")
    out = torch.where(found[..., None], out + emis, out)
    return out, depth, idx, d


def chain_compose(cam, rgb, depth, idx, d, hist, w=W, h=H):
    """The fused loop's composition as renderer_fast's ``_ext_frame``
    composed it."""
    found = idx >= 0
    prev, prev_idx = hist
    same = (idx == prev_idx) & found
    mixed = torch.clamp(prev + (rgb - prev) * float(cam[P_ALPHA]), 0.0, 1.0)
    out = torch.where(same[..., None], mixed, rgb)
    lt_near, lt_far = ray_cube_intersect(device_vec(cam[P_O : P_O + 3], "cpu"), d,
                                         device_vec(cam[P_LIGHT : P_LIGHT + 3], "cpu"),
                                         float(np.float32(0.005)))
    black = (out == 0.0).all(dim=-1)
    out = torch.where(((lt_near <= lt_far) & (lt_far >= 0.0) & black)[..., None], 1.0, out)
    new_hist = out
    ux, _ = rs._pixel_uv(cam, w, h, "cpu")
    overlay = (ux < 0.5) & bool(cam[P_OVERLAY] == 1.0)
    overlay_rgb = torch.stack([depth, torch.zeros_like(depth), torch.zeros_like(depth)], dim=-1)
    out = torch.where(overlay[..., None], overlay_rgb, out)
    return torch.pow(out, float(np.float32(1.0) / cam[P_GAMMA])), new_hist


def history_for(idx):
    g = torch.Generator().manual_seed(5)
    h, w = idx.shape
    return (torch.rand((h, w, 3), generator=g),
            torch.where(torch.rand((h, w), generator=g) < 0.7, idx, -1))


def passes(vol, cam, light, *, sliced, ages=None, total_states=2, history=None, hits=None, w=W,
           h=H):
    """``render_slab.lighting_passes`` on the CPU: the twins, on the frame's
    own hits or on ``hits``."""
    kw = dict(grid_size=N, width=w, height=h)
    rgb, t, idx, age = hits or primary(vol, cam, light, sliced=sliced, ages=ages,
                                       total_states=total_states, w=w, h=h)
    return rs.lighting_passes(cam, idx, t, rs.prep_volume(vol), light, rgb=rgb, age=age,
                              total_states=total_states, history=history, **kw)


K1_CASES = [(name, False) for name in CASES] + [
    (name, True) for name in CASES if "jitter_k" in CASES[name]]


@pytest.mark.parametrize("name,tensor_index", K1_CASES,
                         ids=[f"{n}-{'tensor' if t else 'int'}" for n, t in K1_CASES])
def test_twins_equal_the_torch_chain_on_k1_frames(vol, name, tensor_index):
    """K1's frames: the twins' light and the fused loop's composition equal
    the chain's, bit for bit; a temporal index as a tensor too."""
    kw = dict(CASES[name])
    if tensor_index:
        kw["jitter_k"] = kw["gi_slot"] = torch.tensor(kw["jitter_k"])
    light, cam = L(**kw), cam_of()
    rgb, depth, idx, d = chain_frame(vol, cam, light, sliced=False)
    assert int((idx >= 0).sum()) > 50
    assert equal_nan(passes(vol, cam, light, sliced=False), rgb)
    hist = history_for(idx)
    pres, new_hist = passes(vol, cam, light, sliced=False, history=hist)
    want_pres, want_hist = chain_compose(cam, rgb, depth, idx, d, hist)
    assert equal_nan(pres, want_pres) and equal_nan(new_hist, want_hist)


@pytest.mark.parametrize("name", list(SLICED_CASES))
def test_twins_equal_the_torch_chain_on_sliced_frames(vol, name):
    light, cam = L(**SLICED_CASES[name]), cam_of()
    rgb, depth, idx, _ = chain_frame(vol, cam, light, sliced=True)
    got_rgb, got_depth = passes(vol, cam, light, sliced=True)
    assert equal_nan(got_rgb, rgb) and equal_nan(got_depth, depth)
    assert float(rgb.max()) > 0.0


@pytest.mark.parametrize("sliced", [False, True], ids=["k1", "sliced"])
def test_twins_equal_the_torch_chain_with_ages(pyroclastic, sliced):
    """``pyroclastic``: K1's faded frame, and the sliced frame's fade of its
    direct light by K4's ages, through the twins."""
    planes, vis, states = pyroclastic
    light, cam = L(soft_k=4, gi=True), cam_of()
    rgb, depth, idx, _ = chain_frame(vis, cam, light, sliced=sliced, ages=planes,
                                     total_states=states)
    got = passes(vis, cam, light, sliced=sliced, ages=planes, total_states=states)
    got = got if sliced else (got, depth)
    assert equal_nan(got[0], rgb) and equal_nan(got[1], depth)
    assert int((idx >= 0).sum()) > 20


# The edges of the kernels' compaction: (width, height, volume) -- every
# pixel a hit (a full 32³ volume of whole cells, whose front face fills
# the initial view), none (an empty volume), and a window that is no
# multiple of the kernels' tile or of 4 pixels (the scene).
EDGE_FRAMES = {"all_hit": (W, H, 1.0), "no_hit": (W, H, 0.0), "ragged": (101, 37, None)}


def edge_volume(scene, density):
    if density is None:
        return scene
    rng = np.random.default_rng(7)
    return ct.from_reference(ct.pack_grid((rng.random((N, N, N)) < density).astype(np.uint8)),
                             device="cpu")


@pytest.mark.parametrize("name", ["full_quality", "gi_temporal_1"])
@pytest.mark.parametrize("sliced", [False, True], ids=["k1", "sliced"])
@pytest.mark.parametrize("frame", list(EDGE_FRAMES))
def test_twins_equal_the_torch_chain_on_edge_frames(vol, frame, sliced, name):
    """The twins against the chain, bit for bit, where every pixel hits,
    where none does and on a ragged window: the light (K1's frame also
    composed; the sliced frame's depth)."""
    w, h, density = EDGE_FRAMES[frame]
    vol = edge_volume(vol, density)
    light = L(**CASES[name])
    cam = cam_of(width=w, height=h, **({"cell_size": 1.0} if frame == "all_hit" else {}))
    hits = primary(vol, cam, light, sliced=sliced, w=w, h=h)
    idx = hits[2]
    n_hit = int((idx >= 0).sum())
    assert {"all_hit": n_hit == w * h, "no_hit": n_hit == 0}.get(frame, 0 < n_hit < w * h)
    rgb, depth, _, d = chain_frame(vol, cam, light, sliced=sliced, hits=hits, w=w, h=h)
    got = passes(vol, cam, light, sliced=sliced, hits=hits, w=w, h=h)
    if sliced:
        assert equal_nan(got[0], rgb) and equal_nan(got[1], depth)
        return
    assert equal_nan(got, rgb)
    hist = history_for(idx)
    pres, new_hist = passes(vol, cam, light, sliced=False, history=hist, hits=hits, w=w, h=h)
    want_pres, want_hist = chain_compose(cam, rgb, depth, idx, d, hist, w=w, h=h)
    assert equal_nan(pres, want_pres) and equal_nan(new_hist, want_hist)


@pytest.mark.parametrize("name", ["full_quality", "gi_temporal_1", "gi_temporal_3"])
def test_queries_twin_matches_jax_geometry(vol, name):
    """The queries twin's operands against the JAX package's hit geometry,
    jitter and GI slot geometry (jnp, run eagerly) on the same hits."""
    light, cam = L(**CASES[name]), cam_of()
    _, depth, idx = raytrace(vol, coarse_occupancy(vol), cam, shadow=False, grid_size=N,
                             width=W, height=H)
    start, target, excl, active = (a.numpy() for a in rs.lighting_queries_stacked(
        cam, idx, depth, light, grid_size=N, width=W, height=H))
    jcam = jnp.asarray(cam)
    q, origin, coords, found, _ = (np.asarray(a) for a in jrs.hit_geometry(
        jcam, jnp.asarray(idx.numpy()), jnp.asarray(depth.numpy()), grid_size=N, width=W,
        height=H))
    light_pos = cam[P_LIGHT : P_LIGHT + 3]
    samples = [light.jitter_k] if light.jitter_k is not None else range(light.soft_k)
    want = [(q, (light_pos + np.asarray(jrs.soft_shadow_jitter(jcam, k, W, H))), coords, found)
            for k in samples]
    face = np.asarray(jren._face_index(jint.cube_face_normal(jnp.asarray(q),
                                                             jnp.asarray(origin))))
    cell = np.float32(1.0 / N)
    for s in [light.gi_slot] if light.gi_slot is not None else range(4):
        off = jren._INDIRECT_LAYERS[:, s, :][face]
        n_origin = ((coords + off).astype(np.float32) * cell + cell * np.float32(0.5)
                    - np.float32(0.5))
        tn, tf = (np.asarray(a) for a in jint.ray_cube_intersect(
            jnp.asarray(q), jnp.asarray(off.astype(np.float32)), jnp.asarray(n_origin),
            cell * np.float32(cam[18]) * np.float32(0.5)))
        with np.errstate(invalid="ignore"):  # inf * 0 off the slot's axes
            n_point = (q + off.astype(np.float32) * tn[..., None]).astype(np.float32)
        want.append((n_point, np.broadcast_to(light_pos, q.shape),
                     np.maximum(coords + off, 0), found & (tn <= tf) & (tf >= 0.0)))
    assert len(want) == light.nq
    for i, (s, tg, e, a) in enumerate(want):
        np.testing.assert_array_equal(active[i], a, err_msg=f"query {i}")
        np.testing.assert_array_equal(excl[i], np.moveaxis(e, -1, 0), err_msg=f"query {i}")
        on = a[None].repeat(3, 0)
        np.testing.assert_allclose(start[i][on], np.moveaxis(s, -1, 0)[on], atol=1e-6, rtol=0)
        assert (target[i] != np.moveaxis(tg, -1, 0)).mean() <= 0.02, f"query {i}"
    assert active.sum() > 100


# (CA3D_OCC_NQ, CA3D_OCC_NQ1_SWEEP): chunks of 7 and 1, the one to K2; chunks
# of 3, 3 and 2, all to K5.
BACKENDS = [("7", "1"), ("3", "0")]


@pytest.mark.parametrize("nq_env", BACKENDS, ids=["k5_and_k2", "k5"])
def test_occlusion_backends_agree_on_stacked_queries(vol, monkeypatch, nq_env):
    """The stacked queries' flags by K5 in chunks of CA3D_OCC_NQ (a chunk of
    one to K2 under CA3D_OCC_NQ1_SWEEP) equal K2's on the whole batch, and
    the list API's flags of the same queries."""
    light, cam = L(soft_k=4, gi=True), cam_of()
    _, depth, idx = raytrace(vol, coarse_occupancy(vol), cam, shadow=False, grid_size=N,
                             width=W, height=H)
    ops = rs.lighting_queries_stacked(cam, idx, depth, light, grid_size=N, width=W, height=H)
    prepped = rs.prep_volume(vol)
    k2 = rs.occlusion_flags(cam, ops, prepped, grid_size=N)
    monkeypatch.setenv("CA3D_OCC_SWEEP", "0")
    monkeypatch.setenv("CA3D_OCC_NQ", nq_env[0])
    monkeypatch.setenv("CA3D_OCC_NQ1_SWEEP", nq_env[1])
    got = rs.occlusion_flags(cam, ops, prepped, grid_size=N)
    assert got.dtype == torch.int32 and got.shape == (8, H, W)
    assert torch.equal(got, k2) and int(k2.sum()) > 20
    if nq_env == BACKENDS[0]:
        queries, _, _ = rs.lighting_queries(
            cam, *rs.hit_geometry(cam, idx, depth, grid_size=N, width=W, height=H)[:4],
            soft_k=4, gi=True, grid_size=N, width=W, height=H)
        batch = rs.shadow_occlusion_batch(cam, queries, prepped, grid_size=N, width=W,
                                          height=H)
        assert torch.equal(torch.stack(batch), k2 == 1)


def test_frame_paths_on_the_cpu_run_the_twins(vol):
    """trace_shaded on the CPU equals the twins step by step and launches
    neither kernel."""
    from cellularautomatons3d_tpu_torch.render.renderer import RenderStatic
    from cellularautomatons3d_tpu_torch.render.renderer_fast import trace_shaded

    cam = cam_of()
    before = (rs.lighting_queries_cuda.launches, rs.lighting_shade_cuda.launches)
    for static, light, sliced in (
        (dict(soft_shadow_samples=4, indirect_lighting=True), L(soft_k=4, gi=True), False),
        (dict(force_sliced=True), L(soft_k=1), True),
    ):
        s = RenderStatic(width=W, height=H, grid_size=N, **static)
        got = [a.numpy() for a in trace_shaded(s, vol, cam)]
        want = twin_frame(vol, cam, light, n=N, width=W, height=H, sliced=sliced)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert before == (rs.lighting_queries_cuda.launches, rs.lighting_shade_cuda.launches)


def test_lighting_modes_and_host_constants():
    """The modes' query counts, and the constants the kernels take as the
    twins round them on the host."""
    assert (L().nq, L(soft_k=1).nq, L(soft_k=4).nq, L(gi=True).nq) == (0, 1, 4, 4)
    full, temporal = L(soft_k=4, gi=True), L(soft_k=4, jitter_k=3, gi=True, gi_slot=1)
    assert (full.n_soft, full.n_slots, full.occ_div, full.jitter_mode) == (4, 4, 4, 1)
    assert (temporal.n_soft, temporal.n_slots, temporal.occ_div,
            temporal.jitter_mode) == (1, 1, 1, 2)
    assert L(soft_k=1).jitter_mode == 0 and L(soft_k=0).nq == 1
    cam = cam_of(roughness=0.37, elapsed_time=12.7)
    k = rs._light_consts(cam, 64, full)
    f = np.float32
    r = f(0.37)
    assert k.dtype == np.float32 and k.shape == (24,)
    assert k[0] == f(1 / 64) and k[1] == f(1 / 64) * f(0.5)
    assert k[2] == f(rs._cell_half(cam, 64))
    assert k[3] == f(0.07) * (f(12.7) - np.floor(f(12.7))) and k[4] == f(2) * f(0.08)
    assert (k[5], k[6]) == (r * r, r * r - f(1))
    kd = ((r + f(1)) * (r + f(1))) / f(8)
    assert (k[7], k[8]) == (kd, f(1) - kd)
    np.testing.assert_array_equal(k[9:12], f([0.17, 0.2, 0.3]))
    np.testing.assert_array_equal(k[12:15], f(1) - f([0.17, 0.2, 0.3]))
    np.testing.assert_array_equal(k[18:21], f([0.02, 0.03, 0.04]) * f(0.5))
    assert tuple(k[21:]) == (64.0, 4.0, f(1) / f(2.2))


class OnCard:
    """A CPU tensor that reports itself on the card: what the wrappers
    check of an operand before they load the kernel library."""

    device = torch.device("cuda", 0)
    is_cuda = True

    def __init__(self, t):
        self.t, self.dtype, self.shape = t, t.dtype, t.shape

    def is_contiguous(self):
        return self.t.is_contiguous()

    def data_ptr(self):
        return self.t.data_ptr()

    def numel(self):
        return self.t.numel()


@pytest.fixture
def no_library(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(kernels, "library", refuse)


def test_wrappers_refuse_bad_operands(vol, no_library):
    cam, light = cam_of(), L(soft_k=4, gi=True)
    kw = dict(grid_size=N, width=W, height=H)
    _, depth, idx = raytrace(vol, coarse_occupancy(vol), cam, shadow=False, **kw)
    flags = torch.zeros((8, H, W), dtype=torch.int32)
    states = torch.zeros((4, H, W), dtype=torch.uint8)
    rgb = torch.zeros((H, W, 3))
    card = lambda *a: [OnCard(x) for x in a]  # noqa: E731
    ci, ct_ = card(idx, depth)
    for fn, args in ((rs.lighting_queries_cuda, (cam, idx, depth, light)),
                     (rs.lighting_shade_cuda, (cam, idx, depth, flags, states, light))):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(*args, **kw)
    with pytest.raises(ValueError, match="float32"):
        rs.lighting_queries_cuda(cam, ci, OnCard(depth.double()), light, **kw)
    with pytest.raises(ValueError, match="shape"):
        rs.lighting_queries_cuda(cam, OnCard(idx[:-1]), OnCard(depth[:-1]), light, **kw)
    with pytest.raises(ValueError, match="65535 queries"):
        rs.lighting_queries_cuda(cam, ci, ct_, L(soft_k=65536), **kw)
    with pytest.raises(ValueError, match="gi_slot"):
        rs.lighting_queries_cuda(cam, ci, ct_, L(gi=True, gi_slot=4), **kw)
    with pytest.raises(ValueError, match="one-element integer tensor"):
        rs.lighting_queries_cuda(cam, ci, ct_, L(gi=True, gi_slot=torch.tensor(1.0)), **kw)
    with pytest.raises(ValueError, match="grid_size"):
        rs.lighting_queries_cuda(cam, ci, ct_, light, grid_size=48, width=W, height=H)
    shade = lambda *a, **k: rs.lighting_shade_cuda(cam, ci, ct_, *a, **k, **kw)  # noqa: E731
    with pytest.raises(ValueError, match="flags"):
        shade(*card(flags[:5], states), light, rgb=OnCard(rgb))
    with pytest.raises(ValueError, match="states"):
        shade(*card(flags, states.int()), light, rgb=OnCard(rgb))
    with pytest.raises(ValueError, match="flags must be None"):
        shade(OnCard(flags), None, L(), rgb=OnCard(rgb))
    with pytest.raises(ValueError, match="rgb"):
        shade(*card(flags, states), light, rgb=OnCard(rgb[..., :2]))
    with pytest.raises(ValueError, match="no age"):
        shade(*card(flags, states), light, rgb=OnCard(rgb), age=OnCard(idx))
    with pytest.raises(ValueError, match="no history"):
        shade(*card(flags, states), light, history=card(rgb, idx))
    with pytest.raises(ValueError, match="history ids"):
        shade(*card(flags, states), light, rgb=OnCard(rgb), history=card(rgb, depth))
    with pytest.raises(ValueError, match="65535 queries"):
        shade(OnCard(torch.zeros((65536, 1, 1), dtype=torch.int32)), None, L(soft_k=65536),
              rgb=OnCard(rgb))
    assert (rs.lighting_queries_cuda.launches, rs.lighting_shade_cuda.launches) == (0, 0)
