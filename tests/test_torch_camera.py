"""The moving camera: the port's ``render_frame_fast(camera_static=False)``
and ``reproject_history`` against the JAX package's moving-camera branch
(renderer_fast.py:265-293 there; K1 in interpret mode), and the Engine's
moved frames against the JAX Engine's.

Contract: hit ids equal, depth within atol 3e-5; the reprojected source
pixel, the valid mask and rgb (rtol 3e-3 / atol 3e-4) agree on at least
1 − 1e-4 of the pixels.  The JAX side is fed the port's history
(``interop.to_reference``), so only its moving-camera programs compile.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import cellularautomatons3d_tpu as jca
from cellularautomatons3d_tpu.render import renderer as jren
from cellularautomatons3d_tpu.render import renderer_fast as jrf

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.render import renderer, renderer_fast
from cellularautomatons3d_tpu_torch.utils import mat4

N, W, H = 32, 128, 64
ROW0, SHARD_H = 16, 32
MISMATCH_LIMIT = 1e-4
CFG = dict(grid_size=N, width=W, height=H)


def volume():
    """A block of random cells (40 %) in the volume's centre, numpy-seeded."""
    rng = np.random.default_rng(11)
    dense = np.zeros((N, N, N), np.uint8)
    dense[8:24, 8:24, 8:24] = rng.random((16, 16, 16)) < 0.4
    return ct.pack_grid(dense)


VIEW_A = mat4.initial_view_matrix()
# The reference test's pan (tests/test_renderer_fast.py): rotate about y and
# nudge sideways, so most of the block stays on screen.
VIEW_B = mat4.translate(mat4.rotate(VIEW_A, (0, 1, 0), 0.05), (0.03, 0, 0))


def live(view, prev_view):
    cfg = ct.EngineConfig(**CFG)
    f32 = np.float32
    proj = mat4.initial_projection_matrix(W, H)
    return dict(
        view_mat=np.asarray(view, f32), prev_view_mat=np.asarray(prev_view, f32),
        prev_proj_view=mat4.multiply(proj, mat4.inverse(prev_view)).astype(f32),
        elapsed_time=f32(0.1), cell_size=f32(cfg.cell_size),
        temporal_alpha=f32(cfg.temporal_alpha), gamma=f32(cfg.gamma),
        roughness=f32(cfg.roughness),
        base_reflectivity=np.asarray(cfg.base_reflectivity, f32),
        material_color=np.asarray(cfg.material_color, f32),
        light_pos=np.asarray(cfg.light.position, f32),
        light_magnitude=f32(cfg.light.magnitude), show_depth_overlay=f32(0.0),
    )


def torch_params(view, prev_view):
    return renderer.RenderParams(**live(view, prev_view))


def jax_params(view, prev_view):
    return jren.RenderParams(**{k: jnp.asarray(v) for k, v in live(view, prev_view).items()})


def jax_reprojection(params, depth, idx, hist_idx, h, fh, row0):
    """The JAX package's moving-camera branch up to the valid mask, op for
    op (renderer_fast.py:250-290 there): (source pixel, -1 where out of
    bounds; valid mask)."""
    xs = (jnp.arange(W, dtype=jnp.float32) + 0.5) / W
    ys = 1.0 - (jnp.arange(h, dtype=jnp.float32) + jnp.float32(row0) + 0.5) / fh
    u_, v_ = jnp.meshgrid(xs, ys)
    uv = jnp.stack([u_, v_], axis=-1)
    ray_cam = jrf.get_ray(uv, jnp.array([W, fh], jnp.float32))
    view_ray = (params.view_mat[:3, :3] @ ray_cam[..., None])[..., 0]
    hit_point = params.view_mat[:3, 3] + view_ray * jnp.asarray(depth)[..., None]
    uv_r = jren._get_reprojected_uv(params.prev_proj_view, hit_point)
    in_bounds = ((uv_r[..., 0] >= 0.0) & (uv_r[..., 0] <= 1.0)
                 & (uv_r[..., 1] >= 0.0) & (uv_r[..., 1] <= 1.0))
    px = jnp.clip((uv_r[..., 0] * W).astype(jnp.int32), 0, W - 1)
    py_g = (uv_r[..., 1] * fh).astype(jnp.int32) - row0
    in_bounds = in_bounds & (py_g >= 0) & (py_g < h)
    flat = jnp.clip(py_g, 0, h - 1) * W + px
    prev_idx = jnp.take(jnp.asarray(hist_idx).reshape(-1), flat.reshape(-1)).reshape(h, W)
    valid = in_bounds & (jnp.asarray(idx) >= 0) & (prev_idx == jnp.asarray(idx))
    return np.asarray(jnp.where(in_bounds, flat, -1)), np.asarray(valid)


def white_history(hist):
    """The reference test's poisoned history: pure white on every hit."""
    hit = hist.hit_idx >= 0
    color = torch.where(hit[..., None], torch.ones_like(hist.color), 0.0)
    return renderer_fast.FastHistory(color=color, hit_idx=hist.hit_idx)


@pytest.fixture(scope="module")
def jax_engine():
    return jca.Engine(jca.EngineConfig(**CFG))


def moved_frames(s_t, s_j, hist, h, fh, row0):
    """The port's and JAX's moved frame B over ``hist`` (the port's form):
    (port outputs, JAX outputs, port (source, valid), JAX (source, valid)),
    outputs as numpy (presentation, depth, history color, history ids)."""
    packed = volume()
    kw = dict(row0=row0, full_height=fh) if fh != h else {}
    pres, depth, new = renderer_fast.render_frame_fast(
        s_t, ct.from_reference(packed, device="cpu"), torch_params(VIEW_B, VIEW_A), hist,
        False, **kw)
    got = [a.numpy() for a in (pres, depth, new.color.float(), new.hit_idx)]
    pj = jax_params(VIEW_B, VIEW_A)
    hist_j = jrf.FastHistory(*map(jnp.asarray, ct.to_reference(hist)))
    jrow0 = jnp.float32(row0) if fh != h else None
    pres_j, depth_j, new_j = jrf.render_frame_fast(
        s_j, jnp.asarray(packed), pj, hist_j, False, None, 2, jrow0,
        fh if fh != h else None, None)
    want = [np.asarray(a) for a in (pres_j, depth_j, new_j.color.astype(jnp.float32),
                                    new_j.hit_idx)]
    # Each side's reprojection of its own frame: the port's hit ids equal
    # JAX's (asserted below), its depth is within the contract.
    params_t = torch_params(VIEW_B, VIEW_A)
    rgb, d, idx = renderer_fast.trace_shaded(
        s_t, ct.from_reference(packed, device="cpu"), renderer_fast._cam_vec(params_t, W, fh, row0))
    _, src, valid = renderer_fast.reproject_history(hist, rgb, d, idx, params_t, W, h, fh, row0)
    src_j, valid_j = jax_reprojection(pj, want[1], want[3], hist_j.hit_idx, h, fh, row0)
    return got, want, (src.numpy(), valid.numpy()), (src_j, valid_j)


def assert_contract(got, want, ours, theirs):
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[1], want[1], atol=3e-5)
    npx = got[3].size
    for name, a, b in (("source pixel", ours[0], theirs[0]), ("valid", ours[1], theirs[1])):
        frac = float((a != b).mean())
        assert frac <= MISMATCH_LIMIT, f"{name} differs on {int((a != b).sum())} of {npx} px"
    for name, a, b in (("presentation", got[0], want[0]), ("history", got[2], want[2])):
        bad = ~np.isclose(a, b, rtol=3e-3, atol=3e-4).all(axis=-1)
        assert bad.mean() <= MISMATCH_LIMIT, (
            f"{name}: {int(bad.sum())} of {npx} px outside rtol 3e-3 / atol 3e-4")


@pytest.fixture(scope="module")
def pan(jax_engine):
    """Frame A from the static camera, poisoned white, and the moved frame
    B over it, full window (the JAX Engine's RenderStatic, so the JAX
    Engine test below reuses the compiled program)."""
    s_t = renderer.RenderStatic(width=W, height=H, grid_size=N)
    packed = ct.from_reference(volume(), device="cpu")
    _, _, hist_a = renderer_fast.render_frame_fast(
        s_t, packed, torch_params(VIEW_A, VIEW_A),
        renderer_fast.init_fast_history(W, H, "cpu"))
    hist = white_history(hist_a)
    _, _, fresh = renderer_fast.render_frame_fast(
        s_t, packed, torch_params(VIEW_B, VIEW_A),
        renderer_fast.init_fast_history(W, H, "cpu"), False)
    return hist, fresh, moved_frames(s_t, jax_engine.render_static, hist, H, H, 0)


def test_pan_matches_jax(pan):
    _, _, (got, want, ours, theirs) = pan
    assert (got[3] >= 0).sum() > 500
    assert ours[1].sum() > 0
    assert_contract(got, want, ours, theirs)


def test_pan_keeps_history_via_reprojection(pan):
    """tests/test_renderer_fast.py::test_panning_camera_keeps_history_via_
    reprojection on the port: over the white history most hit pixels are
    pulled towards white, over an empty one none is."""
    _, fresh, (got, _, _, _) = pan
    raw = fresh.color.float().numpy()
    hit = fresh.hit_idx.numpy() >= 0
    pulled = (got[2][hit] > raw[hit] + 0.1).mean()
    assert pulled > 0.5, f"only {pulled:.2%} of hit pixels kept history"


def test_row_shard_matches_jax(pan):
    """Rows [16, 48) of the 64-row window as a shard: global UVs and
    frustum, history reprojected within the shard's rows."""
    hist, _, _ = pan
    shard = renderer_fast.FastHistory(hist.color[ROW0:ROW0 + SHARD_H].contiguous(),
                                      hist.hit_idx[ROW0:ROW0 + SHARD_H].contiguous())
    s_t = renderer.RenderStatic(width=W, height=SHARD_H, grid_size=N)
    s_j = jren.RenderStatic(width=W, height=SHARD_H, grid_size=N)
    got, want, ours, theirs = moved_frames(s_t, s_j, shard, SHARD_H, H, ROW0)
    assert ours[1].sum() > 0
    # Some pixels reproject outside the shard's rows and are rejected.
    src_rows = ours[0][ours[0] >= 0] // W
    assert src_rows.min() >= 0 and src_rows.max() < SHARD_H
    assert_contract(got, want, ours, theirs)
    # The shard's rows are the full window's rows: same ids and depth.
    _, _, (full, _, _, _) = pan
    np.testing.assert_array_equal(got[3], full[3][ROW0:ROW0 + SHARD_H])
    np.testing.assert_array_equal(got[1], full[1][ROW0:ROW0 + SHARD_H])


def test_reprojected_uv_matches_jax():
    """_get_reprojected_uv on random points against the reference.  XLA:CPU
    contracts the reference's 4×4 product into a chain of FMAs; the port
    rounds each product and sum (the same on the card and the CPU), so the
    two differ in the last bits, not bit for bit: inside the frustum within
    2 ulps of 0.5 (the scale of ``clip · 0.5 + 0.5``), and the port as close
    to the float64 product as that."""
    rng = np.random.default_rng(3)
    p = rng.uniform(-0.6, 0.6, (4096, 3)).astype(np.float32)
    view = mat4.translate(mat4.rotate(VIEW_A, (0, 1, 0), 0.3), (0.1, -0.05, 0.2))
    ppv = mat4.multiply(mat4.initial_projection_matrix(W, H), mat4.inverse(view))
    got = renderer._get_reprojected_uv(ppv, torch.from_numpy(p)).numpy()
    want = np.asarray(jren._get_reprojected_uv(jnp.asarray(ppv), jnp.asarray(p)))
    inside = ((want >= 0.0) & (want <= 1.0)).all(axis=-1)
    assert inside.sum() > 3000
    ulp = np.spacing(np.float32(0.5))
    assert np.abs(got - want)[inside].max() <= 2 * ulp
    v = np.concatenate([p, np.ones((len(p), 1), np.float32)], 1).astype(np.float64) @ \
        ppv.astype(np.float64).T
    exact = np.stack([v[:, 0] / v[:, 3] * 0.5 + 0.5, -v[:, 1] / v[:, 3] * 0.5 + 0.5], -1)
    assert np.abs(got - exact)[inside].max() <= 2 * ulp
    # Outside the frustum too the two agree to the bits that w's size leaves.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_reproject_history_identity_and_nan():
    """With the previous camera equal to this one every hit reprojects onto
    its own pixel and keeps its history; a hit point on the camera's plane
    (depth 0: w = 0, uv 0/0) or a NaN / infinite depth gives NaN uv, which is
    never in bounds, whatever the integer conversion makes of it."""
    view = np.asarray(VIEW_A, np.float32)
    params = torch_params(view, view)
    h, w = 4, 8
    rgb = torch.full((h, w, 3), 0.5)
    idx = torch.arange(h * w, dtype=torch.int32).reshape(h, w)
    hist = renderer_fast.FastHistory(torch.ones((h, w, 3), dtype=torch.float16), idx.clone())
    out, src, valid = renderer_fast.reproject_history(
        hist, rgb, torch.full((h, w), 1.0), idx, params, w, h)
    assert torch.equal(src, idx.long()) and bool(valid.all())
    assert torch.allclose(out, torch.full((h, w, 3), 0.95))
    for depth in (0.0, float("inf"), float("nan")):
        out, src, valid = renderer_fast.reproject_history(
            hist, rgb, torch.full((h, w), depth), idx, params, w, h)
        assert bool((src == -1).all()) and not bool(valid.any()), depth
        assert torch.equal(out, rgb)


def test_moved_frame_over_empty_history_is_the_static_frame():
    """With no history (every id -1) a moved camera blends nothing, so
    its frame is the static frame bit for bit (the Engine's first frame)."""
    eng = ct.Engine(**CFG, device="cpu").step(6)
    static = ct.Engine(**CFG, device="cpu").step(6)
    static.camera.prev_view_mat = static.camera.view_mat.copy()
    assert not np.array_equal(eng.camera.view_mat, eng.camera.prev_view_mat)
    assert torch.equal(eng.render(), static.render())
    assert torch.equal(eng.history.color, static.history.color)


def test_engine_passes_camera_static(monkeypatch):
    """The Engine calls render_frame_fast with camera_static exactly when
    the view matrix equals the previous frame's (engine.py:298-317 of the
    JAX package)."""
    seen = []
    real = renderer_fast.render_frame_fast

    def spy(s, packed, params, history, camera_static, *a, **kw):
        seen.append(camera_static)
        return real(s, packed, params, history, camera_static, *a, **kw)

    from cellularautomatons3d_tpu_torch import engine as engine_mod
    monkeypatch.setattr(engine_mod, "render_frame_fast", spy)
    eng = ct.Engine(**CFG, device="cpu").step(4)
    eng.render()                       # prev view = identity: moved
    eng.render()                       # static
    eng.camera.mouse_look(12.0, -5.0)
    eng.render()                       # moved
    eng.camera.translate((0, 0, 0), 0.1)
    eng.render()                       # a zero move is static
    assert seen == [False, True, False, True]


def test_engine_moved_ticks_match_jax_engine(pan, jax_engine):
    """Both Engines tick with the same camera moves between frames: every
    frame moved (the JAX Engine's moving-camera program, already compiled
    by the pan fixture), the CA stepped on the reference's cadence."""
    teng = ct.Engine(ct.EngineConfig(**CFG), device="cpu")
    jeng = jax_engine
    for eng in (teng, jeng):
        eng.step(8)
    for i in range(4):
        for eng in (teng, jeng):
            eng.camera.translate((1, 0, -1), 0.02)
            eng.camera.mouse_look(6.0 * (i + 1), -3.0)
        got, want = teng.tick(), np.asarray(jeng.tick())
        ids, ids_j = teng.history.hit_idx.numpy(), np.asarray(jeng.history.hit_idx)
        np.testing.assert_array_equal(ids, ids_j)
        bad = ~np.isclose(got.numpy(), want, rtol=3e-3, atol=3e-4).all(axis=-1)
        assert bad.mean() <= MISMATCH_LIMIT, f"frame {i}: {int(bad.sum())} px differ"
    np.testing.assert_array_equal(ct.to_reference(teng.state), np.asarray(jeng.state))
    assert teng.simulation_step == jeng.simulation_step > 8
