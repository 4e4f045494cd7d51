"""The card's formulation of the patch prepass (K6), on the CPU through its
plain twins, without JAX: the dilate-on-read bit
(``ops.occupancy.dilated_bits``, ``csrc/prepass.cuh`` ``dilated_bit``)
against ``dilate_occupancy`` applied twice, and the per-column masks
(``render_fast.prepass_columns``, ``csrc/prepass.cuh`` ``patch_mask``)
against the plain ``prepass`` on the dilated mip.  Both are exact: the
same float operations in the same order, and bit logic.
"""

import numpy as np
import pytest
import torch

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.ops.occupancy import (
    coarse_occupancy, dilate_occupancy, dilated_bits,
)
from cellularautomatons3d_tpu_torch.render import render_fast as trf
from cellularautomatons3d_tpu_torch.utils import mat4

VIEWS = {
    "initial": mat4.initial_view_matrix(),
    "oblique": mat4.translate(mat4.rotate(mat4.initial_view_matrix(), (0, 1, 0), 1.1), (0, 0, 0.2)),
    "reversed": mat4.translate(
        mat4.rotate(mat4.initial_view_matrix(), (0, 1, 0), np.pi), (0, 0, 1.6)),
}
WINDOWS = {
    "band": dict(width=1920, height=64, win_h=1080, row0=480),  # rows 480-543 of 1080p
    "small": dict(width=128, height=64, win_h=64, row0=0),
    "odd": dict(width=203, height=61, win_h=61, row0=0),  # not a multiple of 8
}
MIPS = ["random", "x_edges", "y_edges", "empty", "full"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's small torch ops: the suite runs
    several workers (restored after the file)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mip(nbk, case, seed=0):
    """An undilated mip [nbk, nbk] with bits only below nbk, as
    ``coarse_occupancy`` gives: random blocks, blocks at x = 0 and
    x = nbk − 1 only, blocks in rows 0 and nbk − 1 only (the y wrap),
    none, all."""
    rng = np.random.default_rng(seed + nbk)
    bits = np.zeros((nbk, nbk, nbk), bool)  # [z, y, x]
    if case == "random":
        bits = rng.random(bits.shape) < 0.05
    elif case == "x_edges":
        bits[..., [0, nbk - 1]] = rng.random((nbk, nbk, 2)) < 0.3
    elif case == "y_edges":
        bits[:, [0, nbk - 1], :] = rng.random((nbk, 2, nbk)) < 0.3
    elif case == "full":
        bits[:] = True
    words = (bits.astype(np.int64) << np.arange(nbk)).sum(-1)
    return torch.from_numpy(np.where(words >= 2**31, words - 2**32, words).astype(np.int32))


@pytest.mark.parametrize("case", MIPS)
@pytest.mark.parametrize("n", [32, 64, 96, 160, 256])
def test_dilated_bits_match_dilate_twice(n, case):
    """Every bit (c, by, bx < 32) of the twice-dilated mip, read from the
    undilated one."""
    nbk = n // 8
    coarse = mip(nbk, case)
    pre = dilate_occupancy(dilate_occupancy(coarse, dilate_z=False, dilate_y=True),
                           dilate_z=False, dilate_y=False)
    c, by, bx = torch.meshgrid(torch.arange(nbk), torch.arange(nbk), torch.arange(32),
                               indexing="ij")
    want = ((pre.to(torch.int64)[c, by] >> bx) & 1) == 1
    got = dilated_bits(coarse, c, by, bx)
    assert torch.equal(got, want)
    assert bool(want.any()) == (case != "empty")


def scene_mip(n):
    """The mip of a sparse random volume at n ≤ 64; above, a random mip
    (packing an n³ volume costs seconds on the CPU)."""
    if n > 64:
        return mip(n // 8, "random", seed=3)
    dense = (np.random.default_rng(5).random((n, n, n)) < 0.002).astype(np.uint8)
    return coarse_occupancy(ct.from_reference(ct.pack_grid(dense), device="cpu"))


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("view", list(VIEWS))
@pytest.mark.parametrize("n", [64, 256])
def test_prepass_columns_match_plain(n, view, window):
    """The per-column masks from the undilated mip equal the plain prepass
    on the twice-dilated mip, bit for bit."""
    win = WINDOWS[window]
    cam = trf.pack_cam(VIEWS[view], win["width"], win["win_h"], (0.721, 1.0, 1.0), 5.0,
                       0.85, 0.29, (0.17,) * 3, (0.0,) * 3, row0=win["row0"])
    kw = dict(grid_size=n, width=win["width"], height=win["height"])
    coarse = scene_mip(n)
    pre = dilate_occupancy(dilate_occupancy(coarse, dilate_z=False), dilate_z=False,
                           dilate_y=False)
    want = trf.prepass(pre, cam, **kw)
    got = trf.prepass_columns(coarse, cam, **kw)
    assert got.shape == want.shape == (-(-win["height"] // 8), -(-win["width"] // 8))
    assert torch.equal(got, want)
    assert len(torch.unique(want[(want != 0) & (want != -1)])) >= 5


def test_prepass_frame_wrapper_does_not_fall_back():
    """K1's in-kernel prepass refuses CPU tensors (the CPU frame takes the
    plain masks in ``raytrace_tiles``) and refuses a given mask or
    ``no_sweep`` beside it; nothing is launched."""
    n = 32
    dense = (np.random.default_rng(5).random((n, n, n)) < 0.05).astype(np.uint8)
    vol = ct.from_reference(ct.pack_grid(dense), device="cpu")
    coarse = coarse_occupancy(vol)
    cam = trf.pack_cam(VIEWS["initial"], 128, 64, (0.721, 1.0, 1.0), 5.0, 0.85, 0.29,
                       (0.17,) * 3, (0.0,) * 3)
    kw = dict(grid_size=n, width=128, height=64)
    launches = (trf.raytrace_cuda.launches, trf.raytrace_cuda.prepass_launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        trf.raytrace_cuda(vol, coarse, cam, prepass=True, **kw)
    for extra in (dict(colmask=torch.zeros((8, 16), dtype=torch.int32)), dict(no_sweep=True)):
        with pytest.raises(ValueError, match="prepass"):
            trf.raytrace_cuda(vol, coarse, cam, prepass=True, **extra, **kw)
    assert (trf.raytrace_cuda.launches, trf.raytrace_cuda.prepass_launches) == launches
