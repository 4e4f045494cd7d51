"""K1's opt-in traversal options in the port against the JAX package.

The reference has three options inside its frame kernel, each off by
default and each exact: the plane-mip prefilter (``CA3D_MIP1=1``, with
``ops.occupancy.plane_occupancy``), the slice-gated descent
(``CA3D_SLICEGATE=1``) and the sticky any-ray-alive gate
(``CA3D_ALIVE_GATE=1``, the module flag ``render_fast._ALIVE_GATE``).  Here:
``plane_occupancy`` bit for bit against JAX's; the port's mip1 twin equal to
the default frame, and able to see a wrong mip; the port's frames under each
variable against JAX's Pallas kernel (interpret mode) under the same one;
and the CPU Engine's fused frames unchanged by either variable.

Contract of the frames (tests/test_tpu_kernel.py:52-56): hit ids equal,
depth within atol 3e-5, rgb within rtol 3e-3 / atol 3e-4.  JAX reads the
variables when it traces, so every JAX frame here is traced afresh
(``jax.clear_caches()``), and the caches are cleared again after the module.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellularautomatons3d_tpu.ops.occupancy import coarse_occupancy as jax_coarse
from cellularautomatons3d_tpu.ops.occupancy import plane_occupancy as jax_plane
from cellularautomatons3d_tpu.render import render_fast as jrf

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.ops.occupancy import coarse_occupancy, plane_occupancy
from cellularautomatons3d_tpu_torch.render import render_fast as trf

from _torch_multistate_scene import pack_ages, random_ages, visibility
from test_torch_render_fast import H, N, W, assert_contract, cam_for, scene

from _torch_multistate_scene import one_torch_thread  # noqa: F401

S = 8  # total states of the scene with ages: 3 age planes
VARIABLES = ("CA3D_MIP1", "CA3D_SLICEGATE")


@contextlib.contextmanager
def env(**values):
    """Set environment variables for a block, then restore them."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(autouse=True, scope="module")
def fresh_jax_traces():
    """No trace made under an option outlives this module."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def no_option_set(monkeypatch):
    for name in (*VARIABLES, "CA3D_ALIVE_GATE"):
        monkeypatch.delenv(name, raising=False)


# ------------------------------------------------------- plane_occupancy ---


def _volume(n, density, seed):
    if density == 0.0:
        dense = np.zeros((n, n, n), np.uint8)
    elif density == 1.0:
        dense = np.ones((n, n, n), np.uint8)
    else:
        dense = (np.random.default_rng(seed).random((n, n, n)) < density).astype(np.uint8)
    return ct.pack_grid(dense)


@pytest.mark.parametrize("density", [0.0, 1.0, 0.01, 0.1, 0.5])
@pytest.mark.parametrize("n", [32, 64, 320])
def test_plane_occupancy_matches_jax(n, density):
    """Bit for bit, [n, XG·n/8]; 320³ has two x-groups, the last partial."""
    packed = _volume(n, density, seed=n)
    want = np.asarray(jax_plane(jnp.asarray(packed))).view(np.int32)
    got = plane_occupancy(ct.from_reference(packed, device="cpu"))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert tuple(got.shape) == (n, -(-n // 256) * (n // 8))
    np.testing.assert_array_equal(got.numpy(), want)
    if 0.0 < density < 1.0:
        assert (want != 0).any() and (want != -1).any()


def test_plane_occupancy_one_cell():
    """One live cell sets one bit: plane z, word (x >> 8)·Yc + y >> 3, bit
    (x >> 3) & 31 (the last, partial x-group of a 320³ grid)."""
    n, (x, y, z) = 320, (301, 77, 5)
    dense = np.zeros((n, n, n), np.uint8)
    dense[z, y, x] = 1
    got = plane_occupancy(ct.from_reference(ct.pack_grid(dense), device="cpu"))
    want = np.zeros((n, 2 * n // 8), np.int64)
    want[z, (x >> 8) * (n // 8) + (y >> 3)] = 1 << ((x >> 3) & 31)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------- the mip1 twin ---


def _one_block():
    dense = np.zeros((N, N, N), np.uint8)
    dense[12:20, 16:24, 8:16] = 1
    return dense, ct.pack_grid(dense)


@pytest.mark.parametrize("compose", [False, True], ids=["noncompose", "compose"])
@pytest.mark.parametrize("scene_name", ["random", "one_block"])
def test_mip1_twin_equals_default(scene_name, compose):
    """The plain K1 gated by the plane mip is the default frame, bit for bit."""
    _, packed = scene() if scene_name == "random" else _one_block()
    vol = ct.from_reference(packed, device="cpu")
    cam = cam_for(emissive_color=(0.02, 0.03, 0.04), emissive_strength=0.5)
    kw = dict(grid_size=N, width=W, height=H, shadow=True)
    history = None
    if compose:
        rgb, _, idx = trf.raytrace(vol, None, cam, **kw)
        history = (torch.clamp(rgb * 1.7 + 0.05, 0.0, 1.0), idx)
    want = trf.raytrace(vol, None, cam, history, **kw)
    got = trf.raytrace(vol, None, cam, history, mip1=plane_occupancy(vol), **kw)
    assert int((want[2] >= 0).sum()) > 100
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_mip1_twin_sees_a_missing_bit():
    """The twin tests each probe's own block: clear one occupied block's
    bit in the plane mip and the hits in it go (the frame is no longer the
    default's), so a wrong ``plane_occupancy`` shows in a frame."""
    _, packed = _one_block()
    vol = ct.from_reference(packed, device="cpu")
    kw = dict(grid_size=N, width=W, height=H, shadow=False)
    _, _, idx = trf.raytrace(vol, None, cam_for(), **kw)
    hit_z = int(idx[idx >= 0][0]) // (N * N)
    plane = plane_occupancy(vol)
    broken = plane.clone()
    broken[hit_z] = 0
    _, _, got = trf.raytrace(vol, None, cam_for(), mip1=broken, **kw)
    lost = (idx >= 0) & (got != idx)
    assert int(lost.sum()) > 0
    assert bool((idx[lost] // (N * N) == hit_z).all())
    with pytest.raises(ValueError, match="plane mip"):
        trf.raytrace(vol, None, cam_for(), mip1=plane[:, :2].contiguous(), **kw)


# ------------------------------------------------- frames against JAX ---


def _history(packed, vol_t, ages=None):
    rgb0, _, idx0 = trf.raytrace(vol_t, None, cam_for(), ages=ages, total_states=S,
                                 grid_size=N, width=W, height=H)
    rng = np.random.default_rng(1)
    idx0 = idx0.numpy()
    hidx = np.where(rng.random(idx0.shape) < 0.3, idx0 + 1, idx0).astype(np.int32)
    hcolor = np.clip(rgb0.numpy() * 1.7 + 0.05, 0.0, 1.0).astype(np.float32)
    return hcolor, hidx


def _jax_frame(packed, cam, history, planes=None):
    """JAX's composed frame (interpret mode), traced afresh so that it reads
    the environment and ``_ALIVE_GATE`` as they are now."""
    jax.clear_caches()
    vol = jnp.asarray(packed)
    ages, kw = None, dict(grid_size=N, width=W, height=H, shadow=True, interpret=True)
    if planes is not None:
        ages, kw["total_states"] = jnp.asarray(planes), S
    color, hidx = history
    blk = tuple(jrf._to_blocks(jnp.asarray(color[..., c]), W, H) for c in range(3))
    blk += (jrf._to_blocks(jnp.asarray(hidx), W, H, fill=-1),)
    built, make_kernel = [], jrf._make_kernel

    def spy(*args, **kwargs):
        built.append((kwargs["use_mip1"], kwargs["use_slicegate"]))
        return make_kernel(*args, **kwargs)

    jrf._make_kernel = spy
    try:
        outs = jrf.raytrace_tiles(vol, jax_coarse(vol), jnp.asarray(cam), ages, blk, **kw)
    finally:
        jrf._make_kernel = make_kernel
    # The kernel was built now, with the options the port reads from the
    # variables as they are.
    assert built == [trf.descent_options()]
    img = [np.asarray(jrf._from_blocks(o, W, H)) for o in outs]
    return np.stack(img[0:3], axis=-1), img[3], img[4], np.stack(img[5:8], axis=-1)


def _torch_frame(vol, cam, history, ages=None):
    hist = (torch.from_numpy(history[0]), torch.from_numpy(history[1]))
    kw = dict(ages=ages, total_states=S) if ages is not None else {}
    outs = trf.raytrace_tiles(vol, coarse_occupancy(vol), cam, hist, grid_size=N, width=W,
                              height=H, shadow=True, **kw)
    return tuple(o.numpy() for o in outs)


def _frames_under(variable, with_ages=False):
    """(the port's frame and JAX's under ``variable``, the port's default
    frame) of one composed scene with shadows."""
    cam = cam_for(emissive_color=(0.02, 0.03, 0.04), emissive_strength=0.5)
    if with_ages:
        planes = pack_ages(random_ages(N, S, 5, 0.95), 3)
        packed = visibility(planes)
        ages = ct.from_reference(planes, device="cpu")
    else:
        _, packed = scene(seed=9)
        planes = ages = None
    vol = ct.from_reference(packed, device="cpu")
    history = _history(packed, vol, ages)
    default = _torch_frame(vol, cam, history, ages)
    with env(**{variable: "1"}):
        want = _jax_frame(packed, cam, history, planes)
        got = _torch_frame(vol, cam, history, ages)
    return got, want, default, history


@pytest.fixture(scope="module")
def mip1_frames():
    return _frames_under("CA3D_MIP1")


@pytest.fixture(scope="module")
def mip1_frames_with_ages():
    return _frames_under("CA3D_MIP1", with_ages=True)


@pytest.fixture(scope="module")
def slicegate_frames():
    return _frames_under("CA3D_SLICEGATE")


@pytest.fixture(scope="module")
def alive_gate_frames():
    """JAX with ``_ALIVE_GATE`` on (the flag CA3D_ALIVE_GATE=1 sets at
    import) against the port's default frame, which needs no form of it."""
    saved = jrf._ALIVE_GATE
    jrf._ALIVE_GATE = True
    try:
        cam = cam_for(emissive_color=(0.02, 0.03, 0.04), emissive_strength=0.5)
        _, packed = scene(seed=9)
        vol = ct.from_reference(packed, device="cpu")
        history = _history(packed, vol)
        want = _jax_frame(packed, cam, history)
    finally:
        jrf._ALIVE_GATE = saved
    return _torch_frame(vol, cam, history), want, history


def _check(got, want, history):
    assert (want[2] >= 0).mean() > 0.2  # the scene is actually hit
    same = (want[2] == history[1]) & (want[2] >= 0)
    assert same.any() and (~same & (want[2] >= 0)).any()
    assert_contract(got, want)
    np.testing.assert_allclose(got[3], want[3], rtol=3e-3, atol=3e-4)


@pytest.mark.parametrize("against", ["jax", "default"])
def test_mip1_frame_matches_jax(mip1_frames, against):
    got, want, default, history = mip1_frames
    if against == "jax":
        _check(got, want, history)
    else:
        for a, b in zip(got, default):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("against", ["jax", "default"])
def test_mip1_frame_with_ages_matches_jax(mip1_frames_with_ages, against):
    got, want, default, history = mip1_frames_with_ages
    if against == "jax":
        _check(got, want, history)
    else:
        for a, b in zip(got, default):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("against", ["jax", "default"])
def test_slicegate_frame_matches_jax(slicegate_frames, against):
    got, want, default, history = slicegate_frames
    if against == "jax":
        _check(got, want, history)
    else:
        for a, b in zip(got, default):
            np.testing.assert_array_equal(a, b)


def test_default_frame_matches_jax_alive_gate(alive_gate_frames):
    got, want, history = alive_gate_frames
    _check(got, want, history)


# --------------------------------------------- reading the variables ---


@pytest.mark.parametrize("mip1,slicegate,want", [
    ("0", "0", (False, False)), ("1", "0", (True, False)),
    ("0", "1", (False, True)), ("1", "1", (False, True)),
])
def test_descent_options_follow_the_environment(monkeypatch, mip1, slicegate, want):
    """Read at each call; slicegate switches mip1 off (render_fast.py:1441-1443);
    an argument given wins over its variable."""
    monkeypatch.setenv("CA3D_MIP1", mip1)
    monkeypatch.setenv("CA3D_SLICEGATE", slicegate)
    assert trf.descent_options() == want
    assert trf.descent_options(mip1=False, slicegate=False) == (False, False)
    assert trf.descent_options(mip1=True, slicegate=False) == (True, False)
    assert trf.descent_options(slicegate=False) == (mip1 == "1", False)


def test_raytrace_tiles_computes_the_plane_mip_only_under_mip1(monkeypatch):
    """The frame under CA3D_MIP1 hands the plain K1 the volume's plane mip;
    without it, or under CA3D_SLICEGATE, none."""
    seen = []
    real = trf.raytrace

    def spy(*args, mip1=None, **kw):
        seen.append(mip1)
        return real(*args, mip1=mip1, **kw)

    monkeypatch.setattr(trf, "raytrace", spy)
    _, packed = _one_block()
    vol = ct.from_reference(packed, device="cpu")
    kw = dict(grid_size=N, width=W, height=H)
    for variables in ({}, {"CA3D_MIP1": "1"}, {"CA3D_SLICEGATE": "1", "CA3D_MIP1": "1"}):
        with env(**variables):
            trf.raytrace_tiles(vol, coarse_occupancy(vol), cam_for(), **kw)
    assert seen[0] is None and seen[2] is None
    assert torch.equal(seen[1], plane_occupancy(vol))


def test_cuda_options_refuse_bad_combinations():
    """Argument checks come before any launch, and a CPU volume is refused."""
    _, packed = _one_block()
    vol = ct.from_reference(packed, device="cpu")
    coarse, plane = coarse_occupancy(vol), plane_occupancy(vol)
    kw = dict(grid_size=N, width=W, height=H)
    counts = (trf.raytrace_cuda.launches, trf.raytrace_cuda.mip1_launches,
              trf.raytrace_cuda.slicegate_launches, trf.raytrace_cuda.noskip_launches)
    bad = [dict(mip1=plane, slicegate=True), dict(slicegate=True, column_skip=False),
           dict(column_skip=False, prepass=True), dict(mip1=plane, no_sweep=True),
           dict(slicegate=True, colmask=torch.zeros((8, 16), dtype=torch.int32))]
    for options in bad:
        with pytest.raises(ValueError):
            trf.raytrace_cuda(vol, coarse, cam_for(), **options, **kw)
    for options in (dict(mip1=plane), dict(slicegate=True), dict(column_skip=False),
                    dict(mip1=plane, prepass=True)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            trf.raytrace_cuda(vol, coarse, cam_for(), **options, **kw)
    assert counts == (trf.raytrace_cuda.launches, trf.raytrace_cuda.mip1_launches,
                      trf.raytrace_cuda.slicegate_launches, trf.raytrace_cuda.noskip_launches)


# ------------------------------------------------------ the CPU Engine ---


ENGINES = {
    "binary": dict(grid_size=32, width=128, height=64),
    "pyroclastic": dict(**ct.PRESETS["pyroclastic"], random_initial_state=True, grid_size=32,
                        width=128, height=64),
}


def _fused(config):
    eng = ct.Engine(device="cpu", **config)
    eng.step(12)
    frame = eng.run_fused(4, reset_every=2)
    return frame, eng.history.color, eng.history.hit_idx, torch.from_numpy(eng.state_dense())


@pytest.mark.parametrize("variable", VARIABLES)
@pytest.mark.parametrize("config", list(ENGINES))
def test_engine_fused_frames_unchanged_by_the_variable(config, variable):
    """``Engine(device="cpu").run_fused(4, reset_every=2)``: the same frame,
    history and state under the variable as without it (read per call)."""
    want = _fused(ENGINES[config])
    with env(**{variable: "1"}):
        got = _fused(ENGINES[config])
    assert int((want[2] >= 0).sum()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
