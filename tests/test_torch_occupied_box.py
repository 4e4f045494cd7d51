"""The port's ``occupied_box`` (the plain twin of ``csrc/occupied_box.cu``)
against a numpy reference computed from the occupied blocks themselves, at
n = 64 and 256 (one coarse x-group), 320 (two, the last one partial) and
512 (two full groups): an empty volume, one block at a corner, at a face
and at the centre, blocks touching each face (that side open), a full
volume and random blocks.  No JAX: the box has no counterpart there."""

import numpy as np
import pytest
import torch

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.ops.occupancy import (
    BOX_WORDS,
    coarse_occupancy,
    coarse_shape,
    occupied_box,
    occupied_box_cuda,
)

SIZES = [64, 256, 320, 512]
FACES = ["-x", "+x", "-y", "+y", "-z", "+z"]
CASES = ["empty", "corner", "face", "centre", *(f"touch{f}" for f in FACES), "full", "random"]


def blocks_of(case, nb, rng):
    """Occupied 8³ blocks, bool [z, y, x]."""
    occ = np.zeros((nb, nb, nb), bool)
    c = nb // 2
    if case == "corner":
        occ[nb - 1, 0, nb - 1] = True
    elif case == "face":
        occ[c, c, 0] = True  # on the -x face only
    elif case == "centre":
        occ[c, c - 1, c] = True
    elif case.startswith("touch"):
        occ[c - 2:c + 1, c - 1:c + 2, c - 3:c] = True
        axis = {"x": 2, "y": 1, "z": 0}[case[-1]]
        at = [c - 1, c, c - 2]
        at[axis] = 0 if case[-2] == "-" else nb - 1
        occ[tuple(at)] = True
    elif case == "full":
        occ[:] = rng.random(occ.shape) < 0.05
        occ[0, 0, 0] = occ[-1, -1, -1] = True  # every face reached
    elif case == "random":
        lo, hi = sorted(rng.integers(1, nb - 1, 2))
        occ[lo:hi + 1, lo:hi + 1, lo:hi + 1] = rng.random((hi - lo + 1,) * 3) < 0.1
        occ[lo, hi, lo] = occ[hi, lo, hi] = True
    return occ


def mip_of(occ, n):
    """Pack blocks into the mip layout: bit x & 31 of word [z, (x >> 5)·nb + y]."""
    nb = occ.shape[0]
    zc, cols = coarse_shape(n)
    xg = cols // nb
    words = np.zeros((nb, xg, nb), np.uint64)
    z, y, x = np.nonzero(occ)
    np.bitwise_or.at(words, (z, x >> 5, y), np.uint64(1) << (x & 31).astype(np.uint64))
    return torch.from_numpy(words.astype(np.uint32).view(np.int32).reshape(zc, cols))


def reference_box(occ, n):
    """The box words as csrc/sweep.cuh's OccBox defines them."""
    nb = occ.shape[0]
    if not occ.any():
        return np.array([1] + [0] * (BOX_WORDS - 1), np.int32)
    z = np.nonzero(occ.any(axis=(1, 2)))[0]
    y = np.nonzero(occ.any(axis=(0, 2)))[0]
    x = np.nonzero(occ.any(axis=(0, 1)))[0]
    inv_n, inf = np.float32(1.0 / n), np.float32(np.inf)  # 1/n rounded once

    def grow(b, up):
        if b == (nb - 1 if up else 0):
            return inf if up else -inf
        cell = b * 8 + 9 if up else b * 8 - 1  # one cell beyond the block
        return np.float32(np.float32(cell) * inv_n) - np.float32(0.5)

    full = x[0] == 0 and y[0] == 0 and z[0] == 0 and min(x[-1], y[-1], z[-1]) == nb - 1
    ext = np.array([grow(x[0], False), grow(x[-1], True), grow(y[0], False),
                    grow(y[-1], True)], np.float32)
    return np.concatenate([np.array([0, full, z[0], z[-1]], np.int32), ext.view(np.int32)])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n", SIZES)
def test_occupied_box_matches_reference(n, case):
    occ = blocks_of(case, n // 8, np.random.default_rng(n + len(case)))
    box = occupied_box(mip_of(occ, n), n)
    assert box.dtype == torch.int32 and tuple(box.shape) == (BOX_WORDS,)
    want = reference_box(occ, n)
    np.testing.assert_array_equal(box.numpy(), want)
    empty, full = int(box[0]), int(box[1])
    assert empty == (case == "empty") and full == (case == "full")
    if case.startswith("touch"):  # the touched side, and only it, is open
        ext = box[4:].numpy().view(np.float32)
        side = {"-x": 0, "+x": 1, "-y": 2, "+y": 3}.get(case[5:])
        assert [i for i in range(4) if np.isinf(ext[i])] == ([] if side is None else [side])
        if case == "touch-z":
            assert int(box[2]) == 0
        if case == "touch+z":
            assert int(box[3]) == n // 8 - 1


@pytest.mark.parametrize("n", [64, 320])
def test_occupied_box_of_a_volume_bounds_its_cells(n):
    """From packed words through coarse_occupancy: every live cell's extent
    lies inside the grown box, and the box lies within one block and one
    cell of the live cells."""
    rng = np.random.default_rng(n)
    dense = np.zeros((n, n, n), np.uint8)  # [z, y, x]
    lo, hi = n // 4 + 3, 3 * n // 4 - 5
    dense[tuple(rng.integers(lo, hi, (3, 40)))] = 1
    box = occupied_box(coarse_occupancy(ct.from_reference(ct.pack_grid(dense))), n)
    x0, x1, y0, y1 = box[4:].numpy().view(np.float32)
    zs, ys, xs = np.nonzero(dense)
    assert int(box[0]) == 0 and int(box[1]) == 0
    assert int(box[2]) == zs.min() // 8 and int(box[3]) == zs.max() // 8
    for cells, a, b in ((xs, x0, x1), (ys, y0, y1)):
        cmin, cmax = cells.min() / n - 0.5, (cells.max() + 1) / n - 0.5
        assert a < cmin - 0.5 / n and b > cmax + 0.5 / n
        assert a > cmin - 9.5 / n and b < cmax + 9.5 / n


def test_occupied_box_cuda_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        occupied_box_cuda(torch.zeros(coarse_shape(64), dtype=torch.int32), 64)
