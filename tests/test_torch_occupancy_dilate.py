"""The port's ``dilate_occupancy`` against the JAX package's, bit for bit,
for every flag combination: at 32³ and 256³ (one x-group) and 320³ (two
x-groups, the last one partial, so the x carry crosses a group boundary)."""

import numpy as np
import jax.numpy as jnp
import pytest

from cellularautomatons3d_tpu.ops.occupancy import coarse_occupancy as jax_coarse
from cellularautomatons3d_tpu.ops.occupancy import dilate_occupancy as jax_dilate

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.ops.occupancy import coarse_occupancy, dilate_occupancy


def _words(n):
    """Sparse random bits, plus blocks on the x-group edges (x-blocks 31
    and 32) and on the y and z edges."""
    rng = np.random.default_rng(n)
    words = np.zeros((n // 32, n, n), np.uint32)
    idx = tuple(rng.integers(0, s, 600) for s in words.shape)
    words[idx] = rng.integers(1, 2**32, 600, dtype=np.uint64).astype(np.uint32)
    words[min(7, n // 32 - 1), 5, 0] |= np.uint32(1 << 31)  # x = 255 (block 31)
    words[-1, n - 1, n - 1] |= np.uint32(1)  # the last word, z and y edges
    return words


@pytest.mark.parametrize("dilate_y", [True, False])
@pytest.mark.parametrize("dilate_z", [True, False])
@pytest.mark.parametrize("n", [32, 256, 320])
def test_dilate_occupancy_matches_jax(n, dilate_z, dilate_y):
    words = _words(n)
    yc = n // 8 if n > 256 else None
    want = np.asarray(jax_dilate(jax_coarse(jnp.asarray(words)), dilate_z=dilate_z,
                                 yc=yc, dilate_y=dilate_y))
    coarse = coarse_occupancy(ct.from_reference(words, device="cpu"))
    got = dilate_occupancy(coarse, dilate_z=dilate_z, yc=yc, dilate_y=dilate_y)
    assert got.dtype == coarse.dtype and got.shape == coarse.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # Dilation only adds occupancy, and adds some.
    c = coarse.numpy().view(np.uint32)
    g = got.numpy().view(np.uint32)
    assert np.all(g & c == c) and (g != c).any()
