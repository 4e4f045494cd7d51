"""The patch prepass (K6) and K1's column-mask gate
(``raytrace_tiles(use_prepass=True)``): the plain K6 masks against the JAX
package's ``_prepass_mask`` (interpret mode) and the prepass frame against
JAX's prepass frame.

The frames compared with JAX's are a 1920×64 row band of a 1920×1080
window (the shard row offset ``P_ROW0``, as the mesh render uses it), the
window the prepass's covering argument is made for.  At the 128×64 window
the port's prepass frame is held to its frame without the prepass, without
JAX: there K1's mask gate descends every column (``mask_gate_forced``).

Tolerances: masks differ on at most 2 % of the patches (the port
normalises with 1/sqrt, XLA:CPU's rsqrt differs by ≤ 2 ulp; 0 seen);
frames: ids differ on at most ``ID_MISMATCH_LIMIT`` of the pixels (the same
rsqrt, 1-5 of 122,880 seen) and, where they agree, rgb within rtol 3e-3 /
atol 3e-4 (the K1 contract) and depth within atol 3e-5 plus rtol 3e-5: the
rsqrt's ≤ 2 ulp reach the depth of grazing hits amplified (16 pixels of the
oblique view at t ≈ 1.41 differ by up to 3.06e-5, 2.2e-5 relative).  The
port's prepass frame equals its plain frame exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cellularautomatons3d_tpu.ops.occupancy import coarse_occupancy as jax_coarse
from cellularautomatons3d_tpu.render import render_fast as jrf

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.ops.occupancy import coarse_occupancy
from cellularautomatons3d_tpu_torch.render import render_fast as trf
from cellularautomatons3d_tpu_torch.utils import mat4

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's many small torch ops: the suite
    runs several workers, and a thread pool per worker oversubscribes the
    cores (restored after the file)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ID_MISMATCH_LIMIT = 1e-4  # chip_smoke.ID_MISMATCH_LIMIT
BAND = dict(width=1920, height=64, row0=480)  # rows 480-543 of a 1080p window
SMALL = dict(width=128, height=64, row0=0)
VIEWS = {
    "initial": mat4.initial_view_matrix(),
    "oblique": mat4.translate(mat4.rotate(mat4.initial_view_matrix(), (0, 1, 0), 1.1), (0, 0, 0.2)),
    "reversed": mat4.translate(
        mat4.rotate(mat4.initial_view_matrix(), (0, 1, 0), np.pi), (0, 0, 1.6)),
}


def scene(n, seed=5, density=0.05):
    dense = (np.random.default_rng(seed).random((n, n, n)) < density).astype(np.uint8)
    return ct.pack_grid(dense)


def cam_for(view, window, **kw):
    win_h = 1080 if window is BAND else window["height"]
    return trf.pack_cam(VIEWS[view], window["width"], win_h, (0.721, 1.0, 1.0), 5.0,
                        0.85, 0.29, (0.17,) * 3, (0.0,) * 3, row0=window["row0"], **kw)


@pytest.mark.parametrize("view", ["initial", "oblique"])
@pytest.mark.parametrize("n", [32, 64])
def test_prepass_masks_match_jax(n, view):
    """Per patch, at the 1080p band and at the small window."""
    words = scene(n, density=0.02)
    for window in (BAND, SMALL):
        w, h = window["width"], window["height"]
        cam = cam_for(view, window)
        blk = jrf._prepass_mask(jax_coarse(jnp.asarray(words)), jnp.asarray(cam), n, w, h, True)
        want = np.asarray(jrf._from_blocks(blk, w, h))[::trf.PATCH, ::trf.PATCH]
        got = trf.prepass_mask(coarse_occupancy(ct.from_reference(words, device="cpu")), cam,
                               grid_size=n, width=w, height=h).numpy()
        assert got.shape == want.shape == (-(-h // 8), -(-w // 8))
        assert (got != want).mean() <= 0.02
        assert (want != 0).any() and (want != -1).any()


def _run_jax(words, cam, n, history=None):
    w, h = BAND["width"], BAND["height"]
    vol = jnp.asarray(words)
    kw = dict(grid_size=n, width=w, height=h, shadow=True, interpret=True, use_prepass=True)
    if history is None:
        return [np.asarray(a) for a in jrf.raytrace_tiles(
            vol, jax_coarse(vol), jnp.asarray(cam), **kw)]
    color, hidx = history
    blk = tuple(jrf._to_blocks(jnp.asarray(color[..., c]), w, h) for c in range(3))
    blk += (jrf._to_blocks(jnp.asarray(hidx), w, h, fill=-1),)
    outs = jrf.raytrace_tiles(vol, jax_coarse(vol), jnp.asarray(cam), None, blk, **kw)
    img = [np.asarray(jrf._from_blocks(o, w, h)) for o in outs]
    return [np.stack(img[0:3], axis=-1), img[3], img[4], np.stack(img[5:8], axis=-1)]


def _run_torch(words, cam, n, history=None, use_prepass=True):
    vol = ct.from_reference(words, device="cpu")
    hist = None if history is None else tuple(torch.from_numpy(a) for a in history)
    return [a.numpy() for a in trf.raytrace_tiles(
        vol, coarse_occupancy(vol), cam, hist, grid_size=n, width=BAND["width"],
        height=BAND["height"], shadow=True, use_prepass=use_prepass)]


def _assert_close(got, want):
    ok = got[2] == want[2]
    assert (~ok).mean() <= ID_MISMATCH_LIMIT
    np.testing.assert_allclose(got[1][ok], want[1][ok], atol=3e-5, rtol=3e-5)
    for i in [0] + ([3] if len(got) == 4 else []):
        np.testing.assert_allclose(got[i][ok], want[i][ok], rtol=3e-3, atol=3e-4)


@pytest.mark.parametrize("compose", [False, True], ids=["noncompose", "compose"])
def test_prepass_frame_matches_jax(compose):
    """32³ from three views, one JAX compile per mode.  The port's prepass
    frame also equals its frame without the prepass at this window."""
    n = 32
    words = scene(n)
    for view in VIEWS:
        cam = cam_for(view, BAND, emissive_color=(0.02, 0.03, 0.04), emissive_strength=0.5)
        history = None
        if compose:
            rgb0, _, idx0 = _run_torch(words, cam, n, use_prepass=False)
            rng = np.random.default_rng(1)
            history = (np.clip(rgb0 * 1.7 + 0.05, 0.0, 1.0).astype(np.float32),
                       np.where(rng.random(idx0.shape) < 0.3, idx0 + 1, idx0).astype(np.int32))
        want = _run_jax(words, cam, n, history)
        got = _run_torch(words, cam, n, history)
        assert (want[2] >= 0).mean() > 0.2
        _assert_close(got, want)
        plain = _run_torch(words, cam, n, history, use_prepass=False)
        for a, b in zip(got, plain):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("compose", [False, True], ids=["noncompose", "compose"])
def test_prepass_frame_exact_at_small_window(compose, monkeypatch):
    """At 128×64 a patch's rays spread ~17× as far as at 1080p, beyond what
    the masks cover: with the mask gate as it is at 1080p the prepass frame
    loses hits (the fault), with the gate forced open it is the frame
    without the prepass, from the three views."""
    n, w, h = 32, SMALL["width"], SMALL["height"]
    vol = ct.from_reference(scene(n), device="cpu")
    coarse = coarse_occupancy(vol)
    kw = dict(grid_size=n, width=w, height=h)
    lost = 0
    for view in VIEWS:
        cam = cam_for(view, SMALL, emissive_color=(0.02, 0.03, 0.04), emissive_strength=0.5)
        assert trf.mask_gate_forced(cam) and not trf.mask_gate_forced(cam_for(view, BAND))
        history = None
        if compose:
            rgb, _, idx = trf.raytrace_tiles(vol, coarse, cam, **kw)
            history = (torch.clamp(rgb * 1.7 + 0.05, 0.0, 1.0), torch.where(idx % 3 == 0, idx + 1, idx))
        want = trf.raytrace_tiles(vol, coarse, cam, history, **kw)
        got = trf.raytrace_tiles(vol, coarse, cam, history, use_prepass=True, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert int((want[2] >= 0).sum()) > 0.2 * w * h
        with monkeypatch.context() as m:
            m.setattr(trf, "mask_gate_forced", lambda cam: False)
            gated = trf.raytrace_tiles(vol, coarse, cam, history, use_prepass=True, **kw)
        lost += int(((gated[2] < 0) & (want[2] >= 0)).sum())
    assert lost > 0


def test_full_mask_equals_no_mask():
    """A mask of all ones descends every non-empty column, as the mip
    does for an occupied one: the same frame.  A mask of zeros loses hits
    (on the 1080p band, where the gate is not forced open)."""
    n, w, h = 32, BAND["width"], BAND["height"]
    vol = ct.from_reference(scene(n), device="cpu")
    cam = cam_for("oblique", BAND)
    kw = dict(grid_size=n, width=w, height=h)
    full = torch.full((h // 8, w // 8), -1, dtype=torch.int32)
    got = trf.raytrace(vol, None, cam, colmask=full, **kw)
    want = trf.raytrace(vol, None, cam, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    none = trf.raytrace(vol, None, cam, colmask=torch.zeros_like(full), **kw)
    assert int((want[2] >= 0).sum()) > 0 and int((none[2] >= 0).sum()) < int((want[2] >= 0).sum())


def test_prepass_wrappers_do_not_fall_back():
    """The K6 and masked K1 wrappers refuse CPU tensors; a non-CPU frame
    with the prepass takes the kernel path, which raises here."""
    n = 32
    vol = ct.from_reference(scene(n), device="cpu")
    coarse = coarse_occupancy(vol)
    cam = cam_for("initial", SMALL)
    kw = dict(grid_size=n, width=128, height=64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        trf.prepass_cuda(coarse, cam, **kw)
    with pytest.raises(ValueError, match="CUDA tensor"):
        trf.raytrace_cuda(vol, coarse, cam, colmask=torch.zeros((8, 16), dtype=torch.int32), **kw)
    with pytest.raises((ValueError, RuntimeError)):
        trf.raytrace_tiles(vol.to("meta"), coarse.to("meta"), cam, use_prepass=True, **kw)
    assert trf.prepass_cuda.launches == 0 and trf.raytrace_cuda.launches == 0
