"""The port's sliced path (grids above 256³) against the JAX package and
the DDA oracle, on the CPU.

* The plain K4 (``render_slab.primary_sweep``) and ``raytrace_sliced``
  with hard shadows against JAX's ``raytrace_sliced`` over 4 bricks (see
  _torch_sliced_scene.py for the contract).
* K4 at 320³ (two coarse x-groups, the last one partial) against the
  per-pixel DDA oracle of tests/test_render_slab.py: ids equal.
* ``coarse_occupancy`` at 320 and 544 (XG = 2 and 3, partial last groups),
  bit-exact against JAX.
* The Engine at 320³ on the CPU: ``render()`` and ``run_fused`` go through
  the sliced branch; every grid from 288 to 1024 builds its renderer.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cellularautomatons3d_tpu.ops.occupancy import coarse_occupancy as jax_coarse

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch import engine as tengine
from cellularautomatons3d_tpu_torch.ops.occupancy import coarse_occupancy
from cellularautomatons3d_tpu_torch.render import render_fast, render_slab, renderer_fast
from cellularautomatons3d_tpu_torch.utils import mat4

from _torch_sliced_scene import (
    assert_frame_close,
    assert_primary_close,
    jax_sliced,
    random_words,
    scene_cam,
    torch_primary,
    torch_sliced,
)

COT_HALF_FOV = 1.3032254


@pytest.fixture(scope="module")
def hard_frame():
    words, cam = random_words(9, 0.02), scene_cam("front")
    return words, cam, jax_sliced(words, cam, shadow=True)


def test_primary_sweep_matches_jax(hard_frame):
    words, cam, want = hard_frame
    assert_primary_close(torch_primary(words, cam), want)


def test_raytrace_sliced_hard_shadow_matches_jax(hard_frame):
    words, cam, want = hard_frame
    got = torch_sliced(words, cam, shadow=True)
    assert_frame_close(got, want)
    # Some hits are in shadow, so the K2 hard-shadow query mattered.
    unshadowed = torch_sliced(words, cam, shadow=False)
    assert (got[0] < unshadowed[0]).any()


@pytest.mark.parametrize("n", [320, 544])
def test_coarse_occupancy_multigroup_matches_jax(n):
    rng = np.random.default_rng(n)
    words = np.zeros((n // 32, n, n), np.uint32)
    # Sparse bits everywhere, plus the last x-word (the partial last group).
    idx = tuple(rng.integers(0, s, 4000) for s in words.shape)
    words[idx] = rng.integers(1, 2**32, 4000, dtype=np.uint64).astype(np.uint32)
    words[-1, 5, 7] = np.uint32(1 << 31)
    got = coarse_occupancy(ct.from_reference(words)).numpy().view(np.uint32)
    want = np.asarray(jax_coarse(jnp.asarray(words)))
    assert got.shape == want.shape == (n // 8, -(-n // 256) * (n // 8))
    np.testing.assert_array_equal(got, want)


def _oracle_ids(dense, view, n, w_img, h_img):
    """Per-pixel DDA oracle (tests/test_render_slab.py, in float64)."""
    o = view[:3, 3].astype(np.float64)
    rot = view[:3, :3]
    half, cell_half = 0.5, 0.85 / n * 0.5
    o_idx = np.full((h_img, w_img), -1, np.int64)
    occupied_z = np.nonzero(dense.any(axis=(1, 2)))[0]
    for py in range(h_img):
        for px in range(w_img):
            ux = (px + 0.5) / w_img
            uy = 1.0 - (py + 0.5) / h_img
            r = np.array([(ux - 0.5) * (w_img / h_img), uy - 0.5, -0.5 * COT_HALF_FOV])
            r /= np.linalg.norm(r)
            d = rot @ r
            with np.errstate(divide="ignore", invalid="ignore"):
                t1 = (-half - o) / d
                t2 = (half - o) / d
            tn, tf = np.minimum(t1, t2).max(), np.maximum(t1, t2).min()
            if not (tn <= tf and tf >= 0):
                continue
            t_start = max(tn, 0.0)
            ks = occupied_z if d[2] > 0 else occupied_z[::-1]
            for k in ks:  # only occupied planes can produce a hit
                with np.errstate(divide="ignore", invalid="ignore"):
                    ta = (k / n - half - o[2]) / d[2]
                    tb = ((k + 1) / n - half - o[2]) / d[2]
                lo, hi = max(min(ta, tb), t_start), min(max(ta, tb), tf)
                if not lo < hi:
                    continue
                tm = 0.5 * (lo + hi)
                cx = int(np.clip(np.floor((o[0] + tm * d[0] + half) * n), 0, n - 1))
                cy = int(np.clip(np.floor((o[1] + tm * d[1] + half) * n), 0, n - 1))
                if not dense[k, cy, cx]:
                    continue
                cc = (np.array([cx, cy, k]) + 0.5) / n - half
                with np.errstate(divide="ignore", invalid="ignore"):
                    a = (cc - cell_half - o) / d
                    b = (cc + cell_half - o) / d
                tnn, tff = np.minimum(a, b).max(), np.maximum(a, b).min()
                if tnn <= tff and tff >= t_start:
                    o_idx[py, px] = cx + cy * n + k * n * n
                    break
    return o_idx


def test_primary_sweep_320_matches_oracle():
    """The scene of tests/test_render_slab.py's multigroup test: cells
    straddling the x-group boundary (x = 256) and a high-x cell in the
    partial last group."""
    n, w_img, h_img = 320, 64, 32
    rng = np.random.default_rng(17)
    dense = np.zeros((n, n, n), np.uint8)
    pts = rng.integers(100, 220, (40, 3))
    dense[pts[:, 0], pts[:, 1], pts[:, 2]] = 1
    dense[160, 160, 252:260] = 1
    dense[160, 124:132, 160] = 1
    dense[42, 200, 300] = 1
    dense[150:170, 150:170, 150:170] = 1
    view = mat4.initial_view_matrix()
    cam = scene_cam("front", w_img, h_img)
    t, idx = render_slab.primary_sweep(ct.from_reference(ct.pack_grid(dense)), cam,
                                       grid_size=n, width=w_img, height=h_img)
    want = _oracle_ids(dense, view, n, w_img, h_img)
    np.testing.assert_array_equal(idx.numpy(), want)
    assert (want >= 0).sum() > 0
    assert bool((t[idx < 0] == 0).all())


def test_engine_320_renders_through_sliced_path(monkeypatch):
    calls = []
    real = renderer_fast.raytrace_sliced

    def spy(*args, **kwargs):
        calls.append(kwargs["grid_size"])
        return real(*args, **kwargs)

    monkeypatch.setattr(renderer_fast, "raytrace_sliced", spy)
    eng = ct.Engine(grid_size=320, width=64, height=32, device="cpu")
    eng.step(100)
    frames = [eng.render(), eng.run_fused(2)]
    assert calls == [320] * 3
    for f in frames:
        assert tuple(f.shape) == (32, 64, 3)
        assert bool(torch.isfinite(f).all()) and float(f.max()) > 0.0
    # History is f16 between frames of the sliced path, as in the reference.
    assert eng.history.color.dtype == torch.float16
    assert int((eng.history.hit_idx >= 0).sum()) > 50


def test_every_sliced_grid_builds_its_renderer():
    """Engine(grid_size=n) for n in 257..1024 (snapped to multiples of
    32) gets a renderer and a fused loop; a 288³ Engine builds and steps."""
    for n in range(288, 1025, 32):
        cfg = ct.EngineConfig(grid_size=n, width=64, height=32)
        s = tengine._render_static(cfg)
        assert s.grid_size == n and renderer_fast._sliced(s)
        renderer_fast.make_fused_loop(s, ct.AutomatonSpec.from_config(cfg), 1)
    eng = ct.Engine(grid_size=288, width=32, height=16, device="cpu")
    assert eng.step(1).state_dense().sum() == 7


def test_k1_refuses_sliced_grids_and_k4_refuses_larger():
    cam = scene_cam("front", 32, 16)
    vol = torch.zeros((10, 320, 320), dtype=torch.int32)
    with pytest.raises(ValueError, match="raytrace_sliced"):
        render_fast.raytrace(vol, None, cam, grid_size=320, width=32, height=16)
    with pytest.raises(ValueError, match="1056 > 1024"):
        render_slab.primary_sweep(vol, cam, grid_size=1056, width=32, height=16)


def test_k4_wrapper_refuses_cpu_tensors_and_does_not_fall_back():
    vol = ct.from_reference(random_words(1, 0.01))
    cam = scene_cam("front", 32, 16)
    before = render_slab.primary_sweep_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        render_slab.primary_sweep_cuda(vol, coarse_occupancy(vol), cam, grid_size=64,
                                       width=32, height=16)
    # A non-CPU volume takes the kernel path, which raises here.
    meta = render_slab.prep_volume(vol.to("meta"), coarse_occupancy(vol).to("meta"))
    with pytest.raises((ValueError, RuntimeError)):
        render_slab.primary_hits(cam, meta, grid_size=64, width=32, height=16)
    assert render_slab.primary_sweep_cuda.launches == before
