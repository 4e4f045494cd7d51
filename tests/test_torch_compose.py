"""The frame's composition: the port's ``renderer_fast.compose_frame`` (the
plain twin of ``csrc/compose.cu``) against the JAX package's
``render_frame_fast`` after its ``trace_shaded`` (renderer_fast.py:250-315
there), on the same traced frame.

JAX's ``trace_shaded`` is replaced by one that returns the test's frame, and
``render_frame_fast`` runs op by op under ``jax.disable_jit()``: no Pallas
kernel runs, so every branch of the composition is cheap to reach -- the
static EMA, the moved camera's reprojection, the depth overlay, gamma 2 (the
``sqrt`` form) and 1, a black pixel on the light cube, and a row shard of a
taller window (``row0 > 0``).  Contract: presentation and history colour
within rtol 3e-3 / atol 3e-4 (the history is f16 on both sides), on every
pixel.  The frame tests (``tests/test_torch_camera.py``,
``tests/test_torch_multistate_frames.py``, ``tests/test_torch_lighting*.py``)
hold the whole ``render_frame_fast`` to JAX's; the wrappers of the kernel
refuse what the kernel does not take before the library loads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellularautomatons3d_tpu.render import renderer as jren
from cellularautomatons3d_tpu.render import renderer_fast as jrf

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch import kernels
from cellularautomatons3d_tpu_torch.render import renderer_fast
from cellularautomatons3d_tpu_torch.render.renderer_fast import (
    FastHistory, compose_frame, compose_frame_cuda)
from cellularautomatons3d_tpu_torch.render.renderer import RenderParams
from cellularautomatons3d_tpu_torch.utils import mat4

from _torch_compose_scene import light_on_pixel

W, H = 128, 64
ID = 77  # every hit is this cell: a moved pixel keeps its history wherever it lands
RGB_RTOL, RGB_ATOL = 3e-3, 3e-4
VIEW_A = mat4.initial_view_matrix()
VIEW_B = mat4.translate(mat4.rotate(VIEW_A, (0, 1, 0), 0.05), (0.03, 0, 0))


def params(view=VIEW_A, prev_view=VIEW_A, h=H, **over):
    cfg = ct.EngineConfig(grid_size=32, width=W, height=h)
    f32 = np.float32
    proj = mat4.initial_projection_matrix(W, h)
    live = dict(
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
    live.update({k: np.asarray(v, f32) for k, v in over.items()})
    return live


def frame(h, seed):
    """A traced frame and a history: hits (id ``ID``) on a central block,
    black pixels around it, a history of the same cell on most hits."""
    rng = np.random.default_rng(seed)
    idx = np.full((h, W), -1, np.int32)
    idx[h // 4 : 3 * h // 4, W // 4 : 3 * W // 4] = ID
    hit = idx >= 0
    rgb = np.where(hit[..., None], rng.random((h, W, 3)) * 1.2, 0.0).astype(np.float32)
    depth = np.where(hit, 1.2 + rng.random((h, W)) * 0.4, 0.0).astype(np.float32)
    hist_idx = np.where(hit & (rng.random((h, W)) < 0.8), ID, -1).astype(np.int32)
    hist_color = (rng.random((h, W, 3)) * 1.1).astype(np.float16)
    return rgb, depth, idx, hist_color, hist_idx


def run_both(live, ops, h, camera_static, fh=None, row0=0, monkeypatch=None):
    """(port, JAX): numpy (presentation, history colour as f32)."""
    rgb, depth, idx, hist_color, hist_idx = ops
    t = [torch.from_numpy(a) for a in ops]
    got = compose_frame(FastHistory(t[3], t[4]), t[0], t[1], t[2],
                        RenderParams(**live), W, h, fh, row0, camera_static)

    def traced(*args, **kw):
        return jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(idx)

    monkeypatch.setattr(jrf, "trace_shaded", traced)
    s = jren.RenderStatic(width=W, height=h, grid_size=32)
    pj = jren.RenderParams(**{k: jnp.asarray(v) for k, v in live.items()})
    with jax.disable_jit():
        pres, _, new = jrf.render_frame_fast(
            s, jnp.zeros((1, 32, 32), jnp.uint32), pj,
            jrf.FastHistory(jnp.asarray(hist_color), jnp.asarray(hist_idx)), camera_static,
            None, 2, None if fh is None else jnp.float32(row0), fh, None)
    want = (np.asarray(pres), np.asarray(new.color).astype(np.float32))
    return (got[0].numpy(), got[1].float().numpy()), want


def assert_close(got, want, what):
    for name, a, b in zip(("presentation", "history"), got, want):
        bad = ~np.isclose(a, b, rtol=RGB_RTOL, atol=RGB_ATOL)
        assert not bad.any(), f"{what}: {name} differs on {int(bad.any(-1).sum())} px"


CASES = {
    "static": (dict(), True),
    "overlay": (dict(show_depth_overlay=1.0), True),
    "gamma2": (dict(gamma=2.0), True),
    "gamma1_overlay": (dict(gamma=1.0, show_depth_overlay=1.0), True),
    "moved": (dict(), False),
    "moved_overlay_gamma2": (dict(show_depth_overlay=1.0, gamma=2.0), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compose_matches_jax(monkeypatch, case):
    over, static = CASES[case]
    live = params(VIEW_B if not static else VIEW_A, VIEW_A, **over)
    got, want = run_both(live, frame(H, 3), H, static, monkeypatch=monkeypatch)
    assert_close(got, want, case)
    if over.get("show_depth_overlay"):  # the left half shows (depth, 0, 0)
        assert np.all(got[0][:, : W // 2, 1:] == 0) and np.any(got[0][:, : W // 2, 0] > 0)


@pytest.mark.parametrize("static", [True, False])
def test_compose_light_cube_on_a_black_pixel(monkeypatch, static):
    """A light on the ray of a black pixel: both paint it white, in the
    presentation and the history."""
    px, py = 9, 7  # outside the hit block: black, no history blends
    live = params(VIEW_A, VIEW_A if static else VIEW_B,
                  light_pos=light_on_pixel(VIEW_A, px, py, W, H))
    got, want = run_both(live, frame(H, 4), H, static, monkeypatch=monkeypatch)
    assert_close(got, want, "light cube")
    assert np.all(got[0][py, px] == 1.0) and np.all(got[1][py, px] == 1.0)
    assert np.all(want[0][py, px] == 1.0)
    assert int((got[1] == 1.0).all(-1).sum()) < 10  # a small cube


@pytest.mark.parametrize("static", [True, False])
def test_compose_row_shard(monkeypatch, static):
    """Rows 16..48 of a 96-row window (a mesh shard): the shard's uvs, rays
    and, moved, its own rows of history; the light cube on a pixel of the
    shard."""
    h, fh, row0 = 32, 96, 16
    px, py = 100, 3
    live = params(VIEW_A if static else VIEW_B, VIEW_A, h=fh, show_depth_overlay=1.0,
                  light_pos=light_on_pixel(VIEW_A if static else VIEW_B, px, py, W, fh, row0))
    got, want = run_both(live, frame(h, 5), h, static, fh=fh, row0=row0,
                         monkeypatch=monkeypatch)
    assert_close(got, want, "row shard")
    assert np.all(got[1][py, px] == 1.0)


def test_compose_twin_moved_keeps_history():
    """The moved twin blends where ``reproject_history`` finds the same cell:
    its history equals that blend (plus the light cube) as f16."""
    live = params(VIEW_B, VIEW_A)
    rgb, depth, idx, hc, hi = (torch.from_numpy(a) for a in frame(H, 6))
    p = RenderParams(**live)
    hist = FastHistory(hc, hi)
    out, _, valid = renderer_fast.reproject_history(hist, rgb, depth, idx, p, W, H)
    _, color = compose_frame(hist, rgb, depth, idx, p, W, H, camera_static=False)
    assert int(valid.sum()) > 100
    assert torch.equal(color[valid], out[valid].to(torch.float16))


class OnCard:
    """A CPU tensor that reports itself on the card: what ``kernels.require``
    reads of an operand."""

    device = torch.device("cuda", 0)

    def __init__(self, t):
        self.t, self.dtype, self.shape = t, t.dtype, t.shape

    def is_contiguous(self):
        return self.t.is_contiguous()

    def data_ptr(self):
        return self.t.data_ptr()

    def element_size(self):
        return self.t.element_size()


@pytest.fixture
def no_library(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(kernels, "library", refuse)


@pytest.mark.parametrize("bad", ["cpu", "dtype", "shape", "rows"])
def test_compose_frame_cuda_rejects(no_library, bad):
    rgb, depth, idx, hc, hi = (torch.from_numpy(a) for a in frame(H, 7))
    ops = dict(rgb=OnCard(rgb), depth=OnCard(depth), idx=OnCard(idx))
    hist = FastHistory(OnCard(hc), OnCard(hi))
    kw = {}
    if bad == "cpu":
        ops["rgb"] = rgb
    elif bad == "dtype":
        ops["depth"] = OnCard(depth.double())
    elif bad == "shape":
        hist = FastHistory(OnCard(hc[:-1].contiguous()), OnCard(hi))
    else:
        kw = dict(full_height=H + 8, row0=16)
    with pytest.raises(ValueError):
        compose_frame_cuda(hist, ops["rgb"], ops["depth"], ops["idx"],
                           RenderParams(**params()), W, H, **kw)


def test_cpu_frames_compose_through_the_twin(monkeypatch):
    """render_frame_fast on the CPU composes with the twin, static and moved;
    the kernel's wrapper is never reached."""
    calls = []
    twin = renderer_fast.compose_frame

    def spy(*args, **kw):
        calls.append(args[-1])
        return twin(*args, **kw)

    def refuse(*args, **kw):
        raise AssertionError("the kernel's wrapper was called on the CPU")

    monkeypatch.setattr(renderer_fast, "compose_frame", spy)
    monkeypatch.setattr(renderer_fast, "compose_frame_cuda", refuse)
    eng = ct.Engine(device="cpu", grid_size=32, width=64, height=32)
    eng.step(12)
    before = compose_frame_cuda.launches
    eng.render()  # the first frame: the camera moved from the identity
    eng.render()
    eng.camera.translate((1, 0, -1), 0.05)
    frame_, _, new = renderer_fast.render_frame_fast(
        eng.render_static, eng.state, eng.render_params(), eng.history, camera_static=False)
    assert calls == [False, True, False] and compose_frame_cuda.launches == before
    assert frame_.dtype == torch.float32 and new.color.dtype == torch.float16
