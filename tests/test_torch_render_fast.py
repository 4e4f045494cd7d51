"""The port's K1 (plain torch twin of ``csrc/render_fast.cu``) against the
JAX package's Pallas kernel in interpret mode, and against the DDA oracle.

Contract (the compiled-vs-interpret one of tests/test_tpu_kernel.py):
hit ids equal, depth within atol 3e-5, rgb within rtol 3e-3 / atol 3e-4.
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

from test_render_fast import oracle_dda

N = 32
W, H = 128, 64
CAM_ARGS = dict(
    width=W, height=H, light_pos=(0.721, 1.0, 1.0), light_magnitude=5.0,
    cell_size=0.85, roughness=0.29, base_reflectivity=(0.17, 0.17, 0.17),
    material_color=(0.0, 0.0, 0.0),
)


def scene(seed=5, density=0.05):
    rng = np.random.default_rng(seed)
    dense = (rng.random((N, N, N)) < density).astype(np.uint8)
    return dense, ct.pack_grid(dense)


def cam_for(view=None, **kw):
    view = mat4.initial_view_matrix() if view is None else view
    return trf.pack_cam(view, **{**CAM_ARGS, **kw})


def run_jax(packed, cam, shadow, history=None):
    vol = jnp.asarray(packed)
    kw = dict(grid_size=N, width=W, height=H, shadow=shadow, interpret=True)
    if history is None:
        rgb, depth, idx = jrf.raytrace_tiles(vol, jax_coarse(vol), jnp.asarray(cam), **kw)
        return np.asarray(rgb), np.asarray(depth), np.asarray(idx)
    color, hidx = history
    blk = tuple(jrf._to_blocks(jnp.asarray(color[..., c]), W, H) for c in range(3))
    blk += (jrf._to_blocks(jnp.asarray(hidx), W, H, fill=-1),)
    outs = jrf.raytrace_tiles(
        vol, jax_coarse(vol), jnp.asarray(cam), None, blk, **kw
    )
    img = [np.asarray(jrf._from_blocks(o, W, H)) for o in outs]
    pres = np.stack(img[0:3], axis=-1)
    hist = np.stack(img[5:8], axis=-1)
    return pres, img[3], img[4], hist


def run_torch(packed, cam, shadow, history=None):
    vol = ct.from_reference(packed, device="cpu")
    hist = None
    if history is not None:
        hist = (torch.from_numpy(history[0]), torch.from_numpy(history[1]))
    outs = trf.raytrace_tiles(
        vol, coarse_occupancy(vol), cam, hist,
        grid_size=N, width=W, height=H, shadow=shadow,
    )
    return tuple(o.numpy() for o in outs)


def assert_contract(got, want):
    rgb, depth, idx = got[:3]
    np.testing.assert_array_equal(idx, want[2])
    np.testing.assert_allclose(depth, want[1], atol=3e-5)
    np.testing.assert_allclose(rgb, want[0], rtol=3e-3, atol=3e-4)


@pytest.mark.parametrize("shadow", [True, False])
def test_plain_k1_matches_jax(shadow):
    _, packed = scene()
    cam = cam_for()
    want = run_jax(packed, cam, shadow)
    got = run_torch(packed, cam, shadow)
    assert (want[2] >= 0).mean() > 0.2  # the scene is actually hit
    assert_contract(got, want)


def test_plain_k1_compose_matches_jax():
    """Compose mode against a non-trivial history: some pixels keep their
    id (EMA blends), some change (fresh colour), misses stay black."""
    _, packed = scene(seed=9)
    cam = cam_for(emissive_color=(0.02, 0.03, 0.04), emissive_strength=0.5)
    rgb0, _, idx0 = run_torch(packed, cam_for(), True)
    rng = np.random.default_rng(1)
    hidx = np.where(rng.random(idx0.shape) < 0.3, idx0 + 1, idx0).astype(np.int32)
    hcolor = np.clip(rgb0 * 1.7 + 0.05, 0.0, 1.0).astype(np.float32)
    want = run_jax(packed, cam, True, (hcolor, hidx))
    got = run_torch(packed, cam, True, (hcolor, hidx))
    same = (want[2] == hidx) & (want[2] >= 0)
    assert same.any() and (~same & (want[2] >= 0)).any()
    assert_contract(got, want)
    np.testing.assert_allclose(got[3], want[3], rtol=3e-3, atol=3e-4)


@pytest.mark.parametrize("name", ["initial", "oblique", "reversed"])
def test_plain_k1_primary_ids_match_oracle(name):
    """The startup view and an oblique one look down −z (dz < 0, the −z
    pass); the reversed camera sits past the far face looking back along
    +z (the +z pass), at a solid block as in test_render_fast's
    negative-dz case.  (On this random scene the f64 oracle differs from
    the f32 kernels -- the JAX one included -- at one grazing pixel.)"""
    dense, packed = scene(seed=3, density=0.03)
    view = mat4.initial_view_matrix()
    if name == "oblique":
        view = mat4.translate(mat4.rotate(view, (0, 1, 0), 1.1), (0, 0, 0.2))
    elif name == "reversed":
        view = mat4.translate(mat4.rotate(view, (0, 1, 0), np.pi), (0, 0, 1.6))
        dense = np.zeros_like(dense)
        dense[12:20, 12:20, 12:20] = 1
        packed = ct.pack_grid(dense)
    cam = cam_for(view)
    _, depth, idx = run_torch(packed, cam, False)
    o_depth, o_idx = oracle_dda(dense, view, h=H, w=W)
    np.testing.assert_array_equal(idx, o_idx)
    np.testing.assert_allclose(depth, o_depth, atol=2e-5)
    assert (idx >= 0).any()


def test_dispatch_never_falls_back():
    """A non-CPU volume goes to the CUDA wrapper, which raises here rather
    than running the plain version; the CUDA wrapper refuses CPU tensors."""
    _, packed = scene()
    vol = ct.from_reference(packed, device="cpu")
    meta = vol.to("meta")
    with pytest.raises((ValueError, RuntimeError)):
        trf.raytrace_tiles(meta, coarse_occupancy(vol).to("meta"), cam_for(),
                           grid_size=N, width=W, height=H)
    with pytest.raises(ValueError, match="CUDA tensor"):
        trf.raytrace_cuda(vol, coarse_occupancy(vol), cam_for(),
                          grid_size=N, width=W, height=H)
    assert trf.raytrace_cuda.launches == 0


@pytest.mark.parametrize("compose", [False, True], ids=["noncompose", "compose"])
def test_no_sweep_is_the_empty_volume_frame(compose):
    """``no_sweep`` (the timing split's floor) skips both sweeps: the plain
    K1 then gives the frame of an empty volume, ids, depth, rgb and
    history, for a scene that hits."""
    _, packed = scene()
    vol = ct.from_reference(packed, device="cpu")
    empty = torch.zeros_like(vol)
    cam = cam_for(emissive_color=(0.02, 0.03, 0.04), emissive_strength=0.5)
    kw = dict(grid_size=N, width=W, height=H, shadow=True)
    history = None
    if compose:
        rgb, _, idx = trf.raytrace(vol, None, cam, **kw)
        history = (torch.clamp(rgb * 1.7 + 0.05, 0.0, 1.0), idx)
    got = trf.raytrace(vol, None, cam, history, no_sweep=True, **kw)
    want = trf.raytrace(empty, None, cam, history, **kw)
    assert len(got) == (4 if compose else 3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int((trf.raytrace(vol, None, cam, **kw)[2] >= 0).sum()) > 0
    assert bool((got[2] == -1).all()) and float(got[1].max()) > 0.0
