"""The occupancy rebuild with its box from the CPU's side: the plain twin of
the mip kernel's one launch (``ops.occupancy.coarse_occupancy_box``, the
twin of ``coarse_occupancy_box_cuda``, ``csrc/coarse_occupancy.cu``) against
the JAX package's ``coarse_occupancy`` and its occupied z-range rule
(``render/render_fast.py`` ``raytrace_tiles``, evaluated with ``jnp`` on
JAX's mip), on seeded numpy volumes at 32³, 64³, 256³ and 288³ (a partial last
x-group) and on the box-edge volumes of ``tests/_torch_box_scene.py`` at 256³;
``render_slab.prep_volume`` on the CPU; and the wrappers' refusals, before
the kernel library loads.  No Pallas call: ``coarse_occupancy`` is XLA in
the JAX package.  ``tests/test_torch_cuda.py`` holds the kernel against the
twin on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu.ops.occupancy import coarse_occupancy as jax_coarse
from cellularautomatons3d_tpu_torch import kernels
from cellularautomatons3d_tpu_torch.ops import occupancy
from cellularautomatons3d_tpu_torch.ops.occupancy import (
    BOX_WORDS, coarse_occupancy_box, coarse_occupancy_box_cuda, coarse_shape,
    occupancy_mip_box, occupied_box)
from cellularautomatons3d_tpu_torch.render import render_slab
from cellularautomatons3d_tpu_torch.tools import common

from _torch_box_scene import BOX_CASES, box_edge_volume

SIZES = [32, 64, 256, 288]
VOLUMES = ["empty", "full", "one_cell", "sparse", "dense"]


def volume(n, case, seed):
    """Packed words (numpy uint32 [n/32, n, n]) of an n³ volume: none live,
    all live, one random live cell, about 0.05 % or 5 % of cells live."""
    rng = np.random.default_rng(seed)
    shape = (n // 32, n, n)
    if case == "empty":
        return np.zeros(shape, np.uint32)
    if case == "full":
        return np.full(shape, 0xFFFFFFFF, np.uint32)
    words = np.zeros(shape, np.uint32).reshape(-1)
    k = {"one_cell": 1, "sparse": max(1, n**3 // 2000), "dense": n**3 // 20}[case]
    np.bitwise_or.at(words, rng.integers(0, words.size, k),
                     np.uint32(1) << rng.integers(0, 32, k).astype(np.uint32))
    return words.reshape(shape)


def reference_z_range(mip, n):
    """The JAX package's occupied z-range of a mip (render_fast.py,
    raytrace_tiles): [zmin, zmax] of the coarse rows holding a block, the
    inverted range (n/8, -1) for an empty mip."""
    row_any = jnp.any(mip != 0, axis=1)
    nc = n // 8
    idxs = jnp.arange(nc, dtype=jnp.int32)
    any_any = jnp.any(row_any)
    zmin = jnp.where(any_any, jnp.min(jnp.where(row_any, idxs, nc)), nc)
    zmax = jnp.where(any_any, jnp.max(jnp.where(row_any, idxs, -1)), -1)
    return int(zmin), int(zmax)


def check_against_jax(words, n):
    """The twin's (mip, box) of ``words`` against JAX's mip and z-range."""
    want_mip = jax_coarse(jnp.asarray(words))
    mip, box = coarse_occupancy_box(ct.from_reference(words, device="cpu"))
    np.testing.assert_array_equal(ct.to_reference(mip), np.asarray(want_mip))
    assert box.dtype == torch.int32 and tuple(box.shape) == (BOX_WORDS,)
    assert torch.equal(box, occupied_box(mip, n))
    zmin, zmax = reference_z_range(want_mip, n)
    if zmax < 0:
        assert box.tolist() == [1] + [0] * (BOX_WORDS - 1)
        assert zmin == n // 8
    else:
        assert int(box[0]) == 0
        assert (int(box[2]), int(box[3])) == (zmin, zmax)
    return box


@pytest.mark.parametrize("case", VOLUMES)
@pytest.mark.parametrize("n", SIZES)
def test_mip_and_box_twin_match_jax(n, case):
    box = check_against_jax(volume(n, case, n + len(case)), n)
    assert int(box[0]) == (case == "empty")
    if case in ("empty", "full", "one_cell"):
        assert int(box[1]) == (case == "full")


@pytest.mark.parametrize("case", BOX_CASES)
def test_mip_and_box_twin_match_jax_on_box_edges(case):
    words, region = box_edge_volume(256, case, 5)
    box = check_against_jax(words, 256)
    assert (int(box[0]), int(box[1])) == (case == "empty", case == "full")
    if region is not None:  # the box's z columns hold the region's planes
        assert (int(box[2]), int(box[3])) == (region[0][2] // 8, (region[1][2] - 1) // 8)


@pytest.mark.parametrize("n", [64, 288])
def test_prep_volume_carries_the_twins_box(n):
    """prep_volume on the CPU: the mip and its box from the twin, and for a
    mip the caller brings, the box of that mip; the dispatcher takes the
    twin for a CPU tensor and loads no kernel."""
    vol = ct.from_reference(volume(n, "sparse", 3), device="cpu")
    mip, box = coarse_occupancy_box(vol)
    prepped = render_slab.prep_volume(vol)
    assert prepped.vol is vol
    assert torch.equal(prepped.coarse, mip) and torch.equal(prepped.box, box)
    assert int(box[0]) == 0 and int(box[2]) <= int(box[3])
    given = render_slab.prep_volume(vol, mip)
    assert given.coarse is mip and torch.equal(given.box, box)
    before = coarse_occupancy_box_cuda.launches
    got = occupancy_mip_box(vol)
    assert torch.equal(got[0], mip) and torch.equal(got[1], box)
    assert coarse_occupancy_box_cuda.launches == before


class OnCard:
    """A CPU tensor that reports itself on a card, ``offset`` bytes past its
    address: what ``kernels.require`` reads of an operand."""

    def __init__(self, t, offset=0, device=torch.device("cuda", 0)):
        self.t, self.offset, self.device = t, offset, device
        self.dtype, self.shape = t.dtype, t.shape

    def is_contiguous(self):
        return self.t.is_contiguous()

    def data_ptr(self):
        return self.t.data_ptr() + self.offset


@pytest.fixture
def no_library(monkeypatch):
    """Fail the test if anything loads the kernel library."""
    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(kernels, "library", refuse)


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA tensor"),
    ("shape", "shape"),
    ("misaligned", "16-byte aligned"),
])
def test_mip_box_wrapper_rejects(no_library, case, match):
    t = torch.zeros((2, 64, 64), dtype=torch.int32)
    bad = {"cpu": t, "shape": OnCard(torch.zeros((3, 64, 64), dtype=torch.int32)),
           "misaligned": OnCard(t, offset=4)}[case]
    with pytest.raises(ValueError, match=match):
        coarse_occupancy_box_cuda(bad)
    if case != "cpu":  # the dispatcher takes the kernel for the card
        with pytest.raises(ValueError, match=match):
            occupancy_mip_box(bad)
    assert not occupancy._SCRATCH


N, W, H = 64, 32, 16


def _sweep_call(kernel, box):
    """One call of a sweep wrapper whose operands are all valid but ``box``."""
    vol = OnCard(torch.zeros((N // 32, N, N), dtype=torch.int32))
    coarse = OnCard(torch.zeros(coarse_shape(N), dtype=torch.int32))
    start = OnCard(torch.zeros((1, 3, H, W)))
    excl = OnCard(torch.zeros((1, 3, H, W), dtype=torch.int32))
    active = OnCard(torch.ones((1, H, W), dtype=torch.bool))
    if kernel == "k4":
        return render_slab.primary_sweep_cuda(vol, coarse, box, common.cam(W, H), grid_size=N,
                                              width=W, height=H)
    if kernel == "k2":
        return render_slab.shadow_sweep_cuda(vol, coarse, box, start, start, excl, active,
                                             grid_size=N, cell_half=0.01)
    return render_slab.shadow_sweep_multi_cuda(vol, coarse, box, [start], [start], [excl],
                                               [active], grid_size=N, cell_half=0.01)


@pytest.mark.parametrize("case,match", [
    ("dtype", "torch.int32"),
    ("shape", "shape"),
    ("cpu", "CUDA tensor"),
    ("device", "volume's device"),
])
@pytest.mark.parametrize("kernel", ["k4", "k2", "k5"])
def test_sweep_wrappers_reject_a_bad_box(no_library, kernel, case, match):
    box = torch.zeros(BOX_WORDS, dtype=torch.int32)
    bad = {"dtype": OnCard(box.to(torch.int64)),
           "shape": OnCard(torch.zeros(BOX_WORDS + 1, dtype=torch.int32)),
           "cpu": box,
           "device": OnCard(box, device=torch.device("cuda", 1))}[case]
    wrappers = (render_slab.primary_sweep_cuda, render_slab.shadow_sweep_cuda,
                render_slab.shadow_sweep_multi_cuda)
    launches = [f.launches for f in wrappers]
    with pytest.raises(ValueError, match=match):
        _sweep_call(kernel, bad)
    assert [f.launches for f in wrappers] == launches
