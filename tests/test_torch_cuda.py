"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda`` and skipped without a CUDA device.  These tests import no
JAX, so they run where only torch is installed; tests/conftest.py imports
JAX, so on such a machine skip it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

``chip_smoke.py`` holds the same comparisons at the main path's full size.
"""

import numpy as np
import pytest
import torch

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.ops import ca_step
from cellularautomatons3d_tpu_torch.ops.occupancy import coarse_occupancy
from cellularautomatons3d_tpu_torch.render import render_fast as rf
from cellularautomatons3d_tpu_torch.utils import mat4

pytestmark = pytest.mark.cuda

N = 64
W, H = 128, 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def random_volume(device, seed, p):
    rng = np.random.default_rng(seed)
    dense = (rng.random((N, N, N)) < p).astype(np.uint8)
    return ct.from_reference(ct.pack_grid(dense), device)


@pytest.mark.parametrize("boundary", ct.BoundaryMode.ALL)
@pytest.mark.parametrize("neighbourhood", list(ct.NEIGHBOURHOOD_MAP))
def test_ca_kernel_matches_plain(cuda, neighbourhood, boundary):
    spec = ct.AutomatonSpec.from_rule_strings(
        N, neighbourhood=neighbourhood, born="1,3", survive="0-6",
        boundary=boundary,
    )
    a = random_volume(cuda, 1, 0.2)
    b = a.clone()
    for _ in range(5):
        a = ca_step.fires_plane_cuda(a, spec)
        b = ca_step.fires_plane(b, spec)
        assert torch.equal(a, b)


@pytest.mark.parametrize("compose", [False, True])
@pytest.mark.parametrize("shadow", [True, False])
def test_k1_kernel_matches_plain(cuda, shadow, compose):
    vol = random_volume(cuda, 5, 0.05)
    coarse = coarse_occupancy(vol)
    cam = rf.pack_cam(
        mat4.initial_view_matrix(), W, H, (0.721, 1.0, 1.0), 5.0, 0.85, 0.29,
        (0.17,) * 3, (0.0,) * 3, emissive_color=(0.02, 0.03, 0.04),
        emissive_strength=0.5,
    )
    kw = dict(grid_size=N, width=W, height=H, shadow=shadow)
    hist = None
    if compose:
        rgb, _, idx = rf.raytrace(vol, coarse, cam, **kw)
        hist = (torch.clamp(rgb * 1.5, 0, 1).contiguous(), idx.contiguous())
    got = rf.raytrace_cuda(vol, coarse, cam, hist, **kw)
    want = rf.raytrace(vol, coarse, cam, hist, **kw)
    assert torch.equal(got[2], want[2])
    torch.testing.assert_close(got[1], want[1], atol=3e-5, rtol=0)
    torch.testing.assert_close(got[0], want[0], atol=3e-4, rtol=3e-3)
    if compose:
        torch.testing.assert_close(got[3], want[3], atol=3e-4, rtol=3e-3)
