"""The plane mip in the occupancy rebuild, from the CPU's side: the plain
twins of the rebuild's one launch (``ops.occupancy.coarse_occupancy`` and
``plane_occupancy``, the twins of ``coarse_occupancy_plane_cuda``,
``csrc/coarse_occupancy.cu``'s ``PLANE`` instantiations) against the JAX
package's ``coarse_occupancy`` and ``plane_occupancy`` on seeded numpy
volumes at 32³, 64³, 256³ and 288³ (a partial last x-group) and on the
box-edge volumes of ``tests/_torch_box_scene.py`` at 256³; the dispatcher
``occupancy_rebuild`` on the CPU; the wrappers' refusals, before the kernel
library loads; and mip1 frames built through the rebuild, equal to the frame
``raytrace_tiles`` builds its own plane mip for.  No Pallas call: both JAX
mips are XLA.  ``tests/test_torch_cuda.py`` holds the kernel against the
twins on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu.ops import occupancy as jax_occupancy
from cellularautomatons3d_tpu_torch import kernels
from cellularautomatons3d_tpu_torch.ops import occupancy
from cellularautomatons3d_tpu_torch.ops.occupancy import (
    coarse_occupancy, occupancy_rebuild, occupied_box, plane_occupancy, plane_shape)
from cellularautomatons3d_tpu_torch.render import render_fast, renderer_fast
from cellularautomatons3d_tpu_torch.tools import common

from _torch_box_scene import BOX_CASES, box_edge_volume
from test_torch_occupancy_box import SIZES, VOLUMES, OnCard, volume

# JAX's two mips, each one XLA program a shape (integer ops only: exact).
jax_coarse = jax.jit(jax_occupancy.coarse_occupancy)
jax_plane = jax.jit(jax_occupancy.plane_occupancy)

CUDA_WRAPPERS = ("coarse_occupancy_cuda", "coarse_occupancy_box_cuda",
                 "coarse_occupancy_plane_cuda", "plane_occupancy_cuda")


@pytest.fixture
def no_library(monkeypatch):
    """Fail the test if anything loads the kernel library."""
    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(kernels, "library", refuse)


@pytest.fixture
def no_kernels(monkeypatch):
    """Fail the test if a CPU tensor reaches a kernel's wrapper."""
    for name in CUDA_WRAPPERS:
        monkeypatch.setattr(occupancy, name, None)


def check_rebuild(words, n):
    """Both twins against JAX's mips, and every form of the dispatcher on
    the CPU against the twins."""
    vol = ct.from_reference(words, device="cpu")
    coarse, plane = coarse_occupancy(vol), plane_occupancy(vol)
    np.testing.assert_array_equal(ct.to_reference(coarse), np.asarray(jax_coarse(jnp.asarray(words))))
    np.testing.assert_array_equal(ct.to_reference(plane), np.asarray(jax_plane(jnp.asarray(words))))
    assert plane.dtype == torch.int32 and tuple(plane.shape) == plane_shape(n)
    box = occupied_box(coarse, n)
    for with_box in (False, True):
        for with_plane in (False, True):
            got = occupancy_rebuild(vol, box=with_box, plane=with_plane)
            assert torch.equal(got.coarse, coarse)
            assert (got.box is None) if not with_box else torch.equal(got.box, box)
            assert (got.plane is None) if not with_plane else torch.equal(got.plane, plane)
    assert torch.equal(occupancy.occupancy_mip(vol), coarse)
    return coarse, plane


@pytest.mark.parametrize("case", VOLUMES)
@pytest.mark.parametrize("n", SIZES)
def test_rebuild_twins_match_jax(no_kernels, n, case):
    coarse, plane = check_rebuild(volume(n, case, 2 * n + len(case)), n)
    live = case != "empty"
    assert bool((plane != 0).any()) == live and bool((coarse != 0).any()) == live
    if case == "one_cell":
        assert int((plane != 0).sum()) == 1 and int((coarse != 0).sum()) == 1


@pytest.mark.parametrize("case", BOX_CASES)
def test_rebuild_twins_match_jax_on_box_edges(no_kernels, case):
    words, region = box_edge_volume(256, case, 11)
    _, plane = check_rebuild(words, 256)
    if region is not None:  # the plane mip's rows span the region's planes
        rows = torch.nonzero((plane != 0).any(1)).flatten()
        assert (int(rows[0]), int(rows[-1])) == (region[0][2], region[1][2] - 1)


def test_each_coarse_word_is_the_or_of_its_plane_words():
    """What lets one launch write both mips: an 8³ word is the OR of the 8
    plane-mip words of its z-row."""
    for n in (64, 288):
        vol = ct.from_reference(volume(n, "dense", n), device="cpu")
        plane = plane_occupancy(vol).to(torch.int64) & 0xFFFFFFFF
        folded = plane.reshape(n // 8, 8, -1)
        word = folded[:, 0]
        for k in range(1, 8):
            word = word | folded[:, k]
        word = torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)
        assert torch.equal(word, coarse_occupancy(vol))


@pytest.mark.parametrize("box", [False, True])
@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA tensor"),
    ("shape", "shape"),
    ("misaligned", "16-byte aligned"),
])
def test_plane_wrappers_reject(no_library, case, match, box):
    t = torch.zeros((2, 64, 64), dtype=torch.int32)
    bad = {"cpu": t, "shape": OnCard(torch.zeros((3, 64, 64), dtype=torch.int32)),
           "misaligned": OnCard(t, offset=4)}[case]
    counts = [getattr(occupancy, name).launches for name in CUDA_WRAPPERS]
    with pytest.raises(ValueError, match=match):
        occupancy.coarse_occupancy_plane_cuda(bad, with_box=box)
    with pytest.raises(ValueError, match=match):
        occupancy.plane_occupancy_cuda(bad)
    if case != "cpu":  # the dispatcher takes the kernel for the card
        with pytest.raises(ValueError, match=match):
            occupancy_rebuild(bad, box=box, plane=True)
    assert counts == [getattr(occupancy, name).launches for name in CUDA_WRAPPERS]
    assert not occupancy._SCRATCH


def test_rebuild_refuses_a_tensor_off_the_cpu_without_falling_back(no_library):
    """A tensor on neither the CPU nor the card goes to the kernel's wrapper,
    which refuses it; no plain twin runs in its place."""
    meta = torch.zeros((2, 64, 64), dtype=torch.int32, device="meta")
    for kw in (dict(), dict(box=True), dict(plane=True), dict(box=True, plane=True)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            occupancy_rebuild(meta, **kw)


N, W, H = 32, 64, 32


def test_mip1_frame_through_the_rebuild_equals_the_frame_building_its_own(monkeypatch):
    """raytrace_tiles under CA3D_MIP1 given the rebuild's plane mip renders
    the frame it renders when it builds the plane mip itself (the CPU's
    path before the rebuild carried it), and builds none when given one."""
    monkeypatch.setenv("CA3D_MIP1", "1")
    vol = common.scene(N, 40, torch.device("cpu"))
    cam = common.cam(W, H)
    kw = dict(grid_size=N, width=W, height=H)
    occ = occupancy_rebuild(vol, plane=True)
    own = render_fast.raytrace_tiles(vol, occ.coarse, cam, **kw)
    hist = (own[0].contiguous(), own[2].contiguous())
    own_c = render_fast.raytrace_tiles(vol, occ.coarse, cam, hist, **kw)
    real = render_fast.plane_occupancy
    monkeypatch.setattr(render_fast, "plane_occupancy", None)  # not called
    got = render_fast.raytrace_tiles(vol, occ.coarse, cam, plane=occ.plane, **kw)
    got_c = render_fast.raytrace_tiles(vol, occ.coarse, cam, hist, plane=occ.plane, **kw)
    assert int((own[2] >= 0).sum()) > 0
    for a, b in zip((*got, *got_c), (*own, *own_c)):
        assert torch.equal(a, b)
    default = render_fast.raytrace(vol, occ.coarse, cam, **kw)
    for a, b in zip(got, default):
        assert torch.equal(a, b)
    assert torch.equal(occ.plane, real(vol))


@pytest.mark.parametrize("config", ["headline", "lighting", "multistate"])
def test_engine_mip1_frames_take_the_plane_mip_from_the_rebuild(monkeypatch, config):
    """The CPU Engine under CA3D_MIP1 (render() and the fused loop): every
    frame asks the rebuild for the plane mip once, with the box where the
    extended lighting clips to it, and hands it to K1's twin; the frames
    equal those without the variable."""
    cfg = {"headline": {}, "lighting": dict(soft_shadow_samples=2, indirect_lighting=True,
                                            light_radius=0.08),
           "multistate": dict(ct.PRESETS["pyroclastic"], random_initial_state=True)}[config]
    seen, planes = [], []
    real_rebuild, real_raytrace = renderer_fast.occupancy_rebuild, render_fast.raytrace

    def rebuild(packed, box=False, plane=False):
        seen.append((box, plane))
        return real_rebuild(packed, box=box, plane=plane)

    def raytrace(vol, *args, mip1=None, **kw):
        planes.append(mip1 is not None and torch.equal(mip1, plane_occupancy(vol)))
        return real_raytrace(vol, *args, mip1=mip1, **kw)

    monkeypatch.setattr(renderer_fast, "occupancy_rebuild", rebuild)
    monkeypatch.setattr(render_fast, "raytrace", raytrace)
    out = []
    for on in (False, True):
        monkeypatch.setenv("CA3D_MIP1", "1" if on else "0")
        seen.clear()
        planes.clear()
        eng = ct.Engine(grid_size=N, width=W, height=H, device="cpu", **cfg)
        eng.step(10)
        frames = [eng.render(), eng.run_fused(2, reset_every=2)]
        extended = config == "lighting"
        assert seen == [(extended, on)] * 3
        assert len(planes) == 3 and all(p == on for p in planes)
        out.append([*frames, eng.history.hit_idx])
    for a, b in zip(*out):
        assert torch.equal(a, b)
