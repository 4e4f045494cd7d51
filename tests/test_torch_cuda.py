"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda`` and skipped without a CUDA device.  These tests import no
JAX, so they run where only torch is installed; tests/conftest.py imports
JAX, so on such a machine skip it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

``chip_smoke.py`` holds the same comparisons at the main paths' full sizes.
"""

import numpy as np
import pytest
import torch

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.ops import ca_step
from cellularautomatons3d_tpu_torch.ops.occupancy import coarse_occupancy
from cellularautomatons3d_tpu_torch.render import render_fast as rf
from cellularautomatons3d_tpu_torch.utils import mat4

from _torch_box_scene import BOX_CASES, box_edge_volume
from _torch_query_scene import cell_queries, cell_states_oracle, occlusion_queries

pytestmark = pytest.mark.cuda

N = 64
W, H = 128, 64
LIGHTING_320 = dict(soft_shadow_samples=4, indirect_lighting=True, light_radius=0.08)


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


def _lighting_operands(device):
    """A full-quality frame's 8 occlusion queries (4 jittered samples, 4 GI
    slots) and its 4 GI slot lookups at 64³, built as the port builds
    them, plus random rays and coordinates."""
    from cellularautomatons3d_tpu_torch.render import render_slab as rs

    vol = random_volume(device, 5, 0.05)
    coarse = coarse_occupancy(vol)
    cam = rf.pack_cam(
        mat4.initial_view_matrix(), W, H, (0.721, 1.0, 1.0), 5.0, 0.85, 0.29,
        (0.17,) * 3, (0.0,) * 3, light_radius=0.08, elapsed_time=0.37,
    )
    _, depth, idx = rf.raytrace_cuda(vol, coarse, cam, grid_size=N, width=W,
                                     height=H, shadow=False)
    q, origin, coords, found, _ = rs.hit_geometry(cam, idx, depth, grid_size=N,
                                                  width=W, height=H)
    queries, slots, _ = rs.lighting_queries(
        cam, q, origin, coords, found, grid_size=N, width=W, height=H,
        soft_k=4, gi=True)
    k2_ops = rs.stack_occlusion_queries(queries, W, H)
    k3_ops = rs.stack_cell_queries([(s[0], s[3]) for s in slots], W, H)
    assert k2_ops[0].shape[0] == 8 and k3_ops[0].shape[0] == 4
    g = torch.Generator(device).manual_seed(3)
    rnd = lambda *s: torch.rand(*s, device=device, generator=g)  # noqa: E731
    start = torch.cat([k2_ops[0], rnd(2, 3, H, W) * 1.4 - 0.7])
    target = torch.cat([k2_ops[1], rnd(2, 3, H, W) * 2.0 - 1.0])
    flat = rnd(H, W) < 0.5  # rays with dz == 0, which never hit
    target[-1, 2] = torch.where(flat, start[-1, 2], target[-1, 2])
    excl = torch.cat([k2_ops[2], torch.floor((start[8:] + 0.5) * N).to(torch.int32)])
    active = torch.cat([k2_ops[3], rnd(2, H, W) < 0.5])
    coords3 = torch.cat([k3_ops[0], (rnd(2, 3, H, W) * (2 * N + 3) - 3).to(torch.int32)])
    active3 = torch.cat([k3_ops[1], rnd(2, H, W) < 0.7])
    cell_half = float(np.float32(1.0 / N) * np.float32(0.85) * np.float32(0.5))
    return vol, coarse, (start, target, excl, active), (coords3, active3), cell_half


def test_k2_kernel_matches_plain(cuda):
    from cellularautomatons3d_tpu_torch.render import render_slab as rs

    vol, coarse, ops, _, cell_half = _lighting_operands(cuda)
    got = rs.shadow_sweep_cuda(vol, coarse, *ops, grid_size=N, cell_half=cell_half)
    want = rs.shadow_sweep(vol, *ops, grid_size=N, cell_half=cell_half)
    assert torch.equal(got, want)
    assert int(want[:8].sum()) > 0 and int(want[8:].sum()) > 0
    start, target = ops[0][-1, 2], ops[1][-1, 2]
    assert not want[-1][target == start].any()


def test_k3_kernel_matches_plain(cuda):
    from cellularautomatons3d_tpu_torch.render import render_slab as rs

    vol, _, _, (coords, active), _ = _lighting_operands(cuda)
    got = rs.cell_state_cuda(vol, coords.movedim(1, -1), active, grid_size=N)
    want = rs.cell_state(vol, coords, active, grid_size=N)
    assert torch.equal(got, want)
    assert int(want.sum()) > 0


VIEWS = {
    "front": mat4.initial_view_matrix(),
    "reversed": mat4.translate(
        mat4.rotate(mat4.initial_view_matrix(), (0, 1, 0), np.pi), (0, 0, 1.6)),
    "oblique": mat4.translate(
        mat4.rotate(mat4.initial_view_matrix(), (0, 1, 0), 1.1), (0, 0, 0.2)),
}


def sparse_volume(device, n, p, seed):
    """Packed words of an n³ volume with about p·n³ random live cells, made
    without a dense host array."""
    rng = np.random.default_rng(seed)
    words = np.zeros((n // 32) * n * n, np.uint32)
    k = int(p * n**3)
    np.bitwise_or.at(words, rng.integers(0, words.size, k),
                     np.uint32(1) << rng.integers(0, 32, k).astype(np.uint32))
    return ct.from_reference(words.reshape(n // 32, n, n), device)


@pytest.mark.parametrize("density", [0.01, 0.0005])
@pytest.mark.parametrize("view", list(VIEWS))
@pytest.mark.parametrize("n", [320, 512])
def test_k4_kernel_matches_plain(cuda, n, view, density):
    """K4 over the whole volume at 320³ (two coarse x-groups, the last one
    partial) and 512³ (two full groups): ids equal, t within 3e-5."""
    from cellularautomatons3d_tpu_torch.render import render_slab as rs

    vol = sparse_volume(cuda, n, density, n)
    coarse = coarse_occupancy(vol)
    w, h = 256, 128
    cam = rf.pack_cam(VIEWS[view], w, h, (0.721, 1.0, 1.0), 5.0, 0.85, 0.29,
                      (0.17,) * 3, (0.0,) * 3)
    kw = dict(grid_size=n, width=w, height=h)
    t_k, i_k = rs.primary_sweep_cuda(vol, coarse, cam, **kw)
    t_p, i_p = rs.primary_sweep(vol, cam, **kw)
    assert torch.equal(i_k, i_p)
    torch.testing.assert_close(t_k, t_p, atol=3e-5, rtol=0)
    assert int((i_p >= 0).sum()) > 0


def test_k2_kernel_matches_plain_512(cuda):
    """K2 at 512³ on random rays: starts inside and outside the volume,
    excluded cells at the start, random or out of range, and rays with
    dz == 0 in the last query."""
    from cellularautomatons3d_tpu_torch.render import render_slab as rs

    n, w, h, nq = 512, 256, 128, 3
    vol = sparse_volume(cuda, n, 0.002, 7)
    coarse = coarse_occupancy(vol)
    g = torch.Generator(cuda).manual_seed(5)
    rnd = lambda *s: torch.rand(*s, device=cuda, generator=g)  # noqa: E731
    start = rnd(nq, 3, h, w) * 1.4 - 0.7
    target = rnd(nq, 3, h, w) * 2.0 - 1.0
    flat = rnd(h, w) < 0.5
    target[-1, 2] = torch.where(flat, start[-1, 2], target[-1, 2])
    cell = torch.floor((start + 0.5) * n).to(torch.int32)
    other = (rnd(nq, 3, h, w) * (n + 2) - 1).to(torch.int32)
    excl = torch.where(rnd(nq, 1, h, w) < 0.5, cell, other).contiguous()
    active = rnd(nq, h, w) < 0.7
    cell_half = float(np.float32(1.0 / n) * np.float32(0.85) * np.float32(0.5))
    kw = dict(grid_size=n, cell_half=cell_half)
    got = rs.shadow_sweep_cuda(vol, coarse, start, target, excl, active, **kw)
    want = rs.shadow_sweep(vol, start, target, excl, active, **kw)
    assert torch.equal(got, want)
    assert int(want.sum()) > 0
    assert not want[-1][target[-1, 2] == start[-1, 2]].any()


@pytest.mark.parametrize("view", list(VIEWS))
def test_k4_k2_band_kernels_match_plain(cuda, view):
    """K4 and the hard-shadow K2 on a row band of a 1080p window (row0 > 0,
    as a mesh frame's row shard renders it) at 512³: ids equal, t within
    3e-5, occlusion flags equal."""
    from cellularautomatons3d_tpu_torch.render import render_slab as rs

    n, w, h = 512, BAND["width"], BAND["height"]
    vol = sparse_volume(cuda, n, 0.01, 11)
    coarse = coarse_occupancy(vol)
    cam = _band_cam(view)
    kw = dict(grid_size=n, width=w, height=h)
    t_k, i_k = rs.primary_sweep_cuda(vol, coarse, cam, **kw)
    t_p, i_p = rs.primary_sweep(vol, cam, **kw)
    assert torch.equal(i_k, i_p)
    torch.testing.assert_close(t_k, t_p, atol=3e-5, rtol=0)
    assert int((i_p >= 0).sum()) > 0
    q, origin, coords, found, _ = rs.hit_geometry(cam, i_k, t_k, **kw)
    queries, _, _ = rs.lighting_queries(cam, q, origin, coords, found, soft_k=1, **kw)
    ops = rs.stack_occlusion_queries(queries, w, h)
    k2 = dict(grid_size=n, cell_half=rs._cell_half(cam, n))
    want = rs.shadow_sweep(vol, *ops, **k2)
    assert torch.equal(rs.shadow_sweep_cuda(vol, coarse, *ops, **k2), want)
    assert int(want.sum()) > 0


def test_occupied_box_kernel_matches_plain(cuda):
    """The box kernel (csrc/occupied_box.cu) against its plain twin on
    empty, full and random mips and on mips with one block set, at every
    x-group count (XG 1 to 4, 320³ and 480³ with a partial last group)."""
    from cellularautomatons3d_tpu_torch.ops.occupancy import (
        coarse_shape, occupied_box, occupied_box_cuda)

    g = torch.Generator(cuda).manual_seed(3)
    for n in (32, 64, 256, 320, 480, 512, 1024):
        shape = coarse_shape(n)
        mips = [torch.zeros(shape, dtype=torch.int32, device=cuda),
                valid_mip_bits(n, cuda)]
        for _ in range(24):
            one = torch.zeros(shape, dtype=torch.int32, device=cuda)
            z, row = (int(v) for v in torch.randint(0, 2**20, (2,), generator=g, device=cuda))
            bit = int(torch.randint(0, 32, (1,), generator=g, device=cuda))
            one[z % shape[0], row % shape[1]] = (1 << bit) - (1 << 32 if bit == 31 else 0)
            mips.append(one & valid_mip_bits(n, cuda))
        for p in (0.5, 0.01):
            words = torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32, device=cuda,
                                  generator=g)
            keep = torch.rand(shape, device=cuda, generator=g) < p
            mips.append(torch.where(keep, words, 0) & valid_mip_bits(n, cuda))
        for mip in mips:
            assert torch.equal(occupied_box_cuda(mip, n), occupied_box(mip, n)), n


def valid_mip_bits(n, device):
    """A mask of the mip bits that name a block of an n³ grid (the last
    x-group of a grid that is not a multiple of 256 is partial)."""
    from cellularautomatons3d_tpu_torch.ops.occupancy import coarse_shape

    nb = n // 8
    zc, cols = coarse_shape(n)
    mask = torch.full((zc, cols // nb, nb), -1, dtype=torch.int32, device=device)
    if nb % 32:
        mask[:, -1] = (1 << (nb % 32)) - 1
    return mask.reshape(zc, cols)


@pytest.mark.parametrize("view", list(VIEWS))
@pytest.mark.parametrize("case", BOX_CASES)
@pytest.mark.parametrize("n", [64, 320, 512])
def test_k4_box_edges_match_plain(cuda, n, case, view):
    """K4 on volumes whose occupied box is empty, touches faces, sits off
    the block grid or is the whole volume, from three views: the launch's
    box equals the plain box, ids equal, t within 3e-5."""
    from cellularautomatons3d_tpu_torch.ops.occupancy import occupied_box, occupied_box_cuda
    from cellularautomatons3d_tpu_torch.render import render_slab as rs

    vol = ct.from_reference(box_edge_volume(n, case, n)[0], cuda)
    coarse = coarse_occupancy(vol)
    box = occupied_box_cuda(coarse, n)
    assert torch.equal(box, occupied_box(coarse, n))
    assert (int(box[0]), int(box[1])) == (case == "empty", case == "full")
    w, h = 256, 128
    cam = rf.pack_cam(VIEWS[view], w, h, (0.721, 1.0, 1.0), 5.0, 0.85, 0.29,
                      (0.17,) * 3, (0.0,) * 3)
    kw = dict(grid_size=n, width=w, height=h)
    boxes = occupied_box_cuda.launches
    t_k, i_k = rs.primary_sweep_cuda(vol, coarse, cam, **kw)
    assert occupied_box_cuda.launches == boxes + 1  # as K4's entry point reports
    t_p, i_p = rs.primary_sweep(vol, cam, **kw)
    assert torch.equal(i_k, i_p)
    torch.testing.assert_close(t_k, t_p, atol=3e-5, rtol=0)
    assert (int((i_p >= 0).sum()) > 0) == (case != "empty")


@pytest.mark.parametrize("case", BOX_CASES)
@pytest.mark.parametrize("n", [64, 320, 512])
def test_k2_box_edges_match_plain(cuda, n, case):
    """K2 on the same volumes: random starts inside and outside the box and
    the volume, half the rays aimed through the occupied region, exclusions
    as in K5's tests; flags equal the plain K2's, some rays that start
    outside the box are occluded, and with every lane inactive all flags
    are 0."""
    from cellularautomatons3d_tpu_torch.ops.occupancy import occupied_box_cuda
    from cellularautomatons3d_tpu_torch.render import render_slab as rs

    words, region = box_edge_volume(n, case, n + 1)
    vol = ct.from_reference(words, cuda)
    coarse = coarse_occupancy(vol)
    start, target, excl, _, active = _k5_operands(cuda, n, 3, n)
    if region is not None:
        mid = torch.tensor([(a + b) / 2 / n - 0.5 for a, b in zip(*region)], device=cuda)
        aim = torch.rand(start.shape[0], 1, *start.shape[2:], device=cuda,
                         generator=torch.Generator(cuda).manual_seed(n)) < 0.5
        target = torch.where(aim, mid[None, :, None, None].expand_as(target), target)
        target = target.contiguous()
    cell_half = float(np.float32(1.0 / n) * np.float32(0.85) * np.float32(0.5))
    kw = dict(grid_size=n, cell_half=cell_half)
    boxes = occupied_box_cuda.launches
    got = rs.shadow_sweep_cuda(vol, coarse, start, target, excl, active, **kw)
    assert occupied_box_cuda.launches == boxes + 1  # as K2's entry point reports
    want = rs.shadow_sweep(vol, start, target, excl, active, **kw)
    assert torch.equal(got, want)
    if region is not None:
        lo = torch.tensor(region[0], device=cuda)[None, :, None, None] / n - 0.5
        hi = torch.tensor(region[1], device=cuda)[None, :, None, None] / n - 0.5
        outside = ((start < lo - 9 / n) | (start > hi + 9 / n)).any(dim=1)
        assert int((want.bool() & outside).sum()) > 0
    else:
        assert int(want.sum()) == 0
    idle = torch.zeros_like(active)
    assert int(rs.shadow_sweep_cuda(vol, coarse, start, target, excl, idle, **kw).sum()) == 0


@pytest.mark.parametrize(
    "lighting",
    [dict(), dict(gi_temporal=True), dict(indirect_bounces=2)],
    ids=["full_quality", "gi_temporal", "two_bounces"],
)
def test_lighting_engine_matches_cpu(cuda, lighting):
    """The Engine on the card against the Engine on the CPU: ids equal,
    frames within rtol 3e-3 / atol 3e-4."""
    cfg = dict(grid_size=N, width=W, height=H, soft_shadow_samples=4,
               indirect_lighting=True, light_radius=0.08, **lighting)
    out = []
    for dev in (cuda, "cpu"):
        eng = ct.Engine(device=dev, **cfg)
        eng.step(20)
        frames = [eng.render() for _ in range(3)] + [eng.run_fused(2, reset_every=1)]
        out.append(([f.cpu() for f in frames], eng.history.hit_idx.cpu()))
    (gpu, gidx), (cpu, cidx) = out
    assert torch.equal(gidx, cidx)
    for a, b in zip(gpu, cpu):
        torch.testing.assert_close(a, b, rtol=3e-3, atol=3e-4)


@pytest.mark.parametrize(
    "lighting", [dict(), dict(LIGHTING_320, gi_temporal=True)],
    ids=["hard", "gi_temporal"],
)
def test_sliced_engine_matches_cpu(cuda, lighting):
    """The 320³ Engine (the sliced path: K4, K2, K3) on the card against
    the Engine on the CPU: ids equal, frames within rtol 3e-3 / atol
    3e-4."""
    cfg = dict(grid_size=320, width=64, height=32, **lighting)
    out = []
    for dev in (cuda, "cpu"):
        eng = ct.Engine(device=dev, **cfg)
        eng.step(100)
        frames = [eng.render() for _ in range(2)] + [eng.run_fused(2, reset_every=1)]
        out.append(([f.cpu() for f in frames], eng.history.hit_idx.cpu()))
    (gpu, gidx), (cpu, cidx) = out
    assert torch.equal(gidx, cidx) and int((cidx >= 0).sum()) > 0
    for a, b in zip(gpu, cpu):
        torch.testing.assert_close(a, b, rtol=3e-3, atol=3e-4)



def _moved_ticks(eng, n):
    """``n`` ticks, each after a camera move (translate and mouse look)."""
    frames = []
    for i in range(n):
        eng.camera.translate((1, 0, -1), 0.02)
        eng.camera.mouse_look(5.0 + i, -2.0)
        frames.append(eng.tick())
    return frames


@pytest.mark.parametrize(
    "cfg", [dict(grid_size=N, width=W, height=H),
            dict(grid_size=N, width=W, height=H, gi_temporal=True, **LIGHTING_320),
            dict(grid_size=320, width=64, height=32)],
    ids=["hard", "gi_temporal", "sliced"],
)
def test_moved_engine_matches_cpu(cuda, cfg):
    """Moved ticks (history reprojected every frame) on the card against
    the CPU: ids equal, frames within rtol 3e-3 / atol 3e-4; the
    reprojection of the last frame, the same function on the same inputs,
    keeps the same pixels on both."""
    from cellularautomatons3d_tpu_torch.render import renderer_fast

    out = []
    for dev in (cuda, "cpu"):
        eng = ct.Engine(device=dev, **cfg)
        # gi_temporal: off the default camera, no GI 0/0 enters a history.
        eng.camera.translate((1, 0, 0), 0.05)
        eng.step(100 if cfg["grid_size"] > 256 else 20)
        eng.render()
        hist = eng.history
        frames = _moved_ticks(eng, 6)
        out.append(([f.cpu() for f in frames], eng.history.hit_idx.cpu(), eng, hist))
    (gpu, gidx, geng, ghist), (cpu, cidx, ceng, chist) = out
    assert torch.equal(gidx, cidx) and int((cidx >= 0).sum()) > 0
    for a, b in zip(gpu, cpu):
        torch.testing.assert_close(a, b, rtol=3e-3, atol=3e-4)
    # reproject_history alone, on copies of the CPU's operands.
    h, w = cfg["height"], cfg["width"]
    params = ceng.render_params()
    rgb = torch.rand((h, w, 3), generator=torch.Generator().manual_seed(1))
    depth = torch.rand((h, w), generator=torch.Generator().manual_seed(2)) * 1.5
    args = (chist, rgb, depth, cidx)
    want = renderer_fast.reproject_history(*args, params, w, h)
    got = renderer_fast.reproject_history(
        renderer_fast.FastHistory(chist.color.to(cuda), chist.hit_idx.to(cuda)),
        rgb.to(cuda), depth.to(cuda), cidx.to(cuda), params, w, h)
    assert torch.equal(got[1].cpu(), want[1]) and torch.equal(got[2].cpu(), want[2])
    assert torch.equal(got[0].cpu(), want[0])


def test_checkpoint_loads_on_the_other_device(cuda, tmp_path):
    """save on the card, load on the CPU and on the card (the default), and
    the reverse: the state bit-exact, the history equal, and the next moved
    frame of the loaded card engine bit for bit the saved engine's."""
    eng = ct.Engine(device=cuda, grid_size=N, width=W, height=H)
    eng.step(20)
    _moved_ticks(eng, 3)
    path = str(tmp_path / "card.npz")
    eng.save(path)
    on_cpu = ct.Engine.load(path, device="cpu")
    back = ct.Engine.load(path)
    assert back.device.type == "cuda"
    for other in (on_cpu, back):
        assert torch.equal(other.state.cpu(), eng.state.cpu())
        assert torch.equal(other.history.color.cpu(), eng.history.color.cpu())
        assert torch.equal(other.history.hit_idx.cpu(), eng.history.hit_idx.cpu())
    assert torch.equal(_moved_ticks(back, 1)[0], _moved_ticks(eng, 1)[0])
    path = str(tmp_path / "cpu.npz")
    on_cpu.save(path)
    again = ct.Engine.load(path, device=cuda)
    assert torch.equal(again.state.cpu(), on_cpu.state)
    assert torch.equal(again.history.hit_idx.cpu(), on_cpu.history.hit_idx)


def _k5_operands(device, n, nq, seed):
    """nq random shadow-ray queries at n³ (starts inside and outside the
    volume, exclusions at the start cell, random, or with a coordinate of
    -1 or n, rays with dz == 0 in the last query) as K2's and K5's
    operands."""
    from cellularautomatons3d_tpu_torch.render import render_slab as rs

    w, h = 128, 64
    g = torch.Generator(device).manual_seed(seed)
    rnd = lambda *s: torch.rand(*s, device=device, generator=g)  # noqa: E731
    start = rnd(nq, 3, h, w) * 1.4 - 0.7
    target = rnd(nq, 3, h, w) * 2.0 - 1.0
    flat = rnd(h, w) < 0.5
    target[-1, 2] = torch.where(flat, start[-1, 2], target[-1, 2])
    cell = torch.floor((start + 0.5) * n).to(torch.int32)
    other = (rnd(nq, 3, h, w) * (n + 2) - 1).to(torch.int32)
    excl = torch.where(rnd(nq, 1, h, w) < 0.5, cell, other).contiguous()
    active = rnd(nq, h, w) < 0.7
    return start, target, excl, rs.pack_exclusion(excl, n), active


@pytest.mark.parametrize("nq", range(1, 9))
def test_k5_kernel_matches_plain_and_k2(cuda, nq):
    """K5 on a full-quality frame's 8 queries and 2 of random rays at 64³,
    in chunks of nq (every template of the kernel): flags equal the plain
    K5's and K2's."""
    from cellularautomatons3d_tpu_torch.render import render_slab as rs

    vol, coarse, (start, target, excl, active), _, cell_half = _lighting_operands(cuda)
    exid = rs.pack_exclusion(excl, N)
    kw = dict(grid_size=N, cell_half=cell_half)
    per_pixel = [t.movedim(1, -1) for t in (start, target, excl)]
    got = torch.cat([
        rs.shadow_sweep_multi_cuda(vol, coarse, *(t[i:i + nq] for t in per_pixel),
                                   active[i:i + nq], **kw)
        for i in range(0, start.shape[0], nq)])
    want = rs.shadow_sweep_multi(vol, start, target, exid, active, **kw)
    k2 = rs.shadow_sweep_cuda(vol, coarse, start, target, excl, active, **kw)
    assert torch.equal(got, want) and torch.equal(got, k2)
    assert int(want[:8].sum()) > 0 and int(want[8:].sum()) > 0


@pytest.mark.parametrize("n", [320, 512])
def test_k5_kernel_matches_plain_above_256(cuda, n):
    """K5 with the coarse mip read from global memory (two x-groups, at
    320³ the last one partial), on random rays: equal to plain K5 and K2."""
    from cellularautomatons3d_tpu_torch.render import render_slab as rs

    vol = sparse_volume(cuda, n, 0.002, 7)
    coarse = coarse_occupancy(vol)
    start, target, excl, exid, active = _k5_operands(cuda, n, 3, n)
    kw = dict(grid_size=n, cell_half=float(np.float32(1.0 / n) * np.float32(0.85) * np.float32(0.5)))
    got = rs.shadow_sweep_multi_cuda(vol, coarse, start.movedim(1, -1), target.movedim(1, -1),
                                     excl.movedim(1, -1), active, **kw)
    want = rs.shadow_sweep_multi(vol, start, target, exid, active, **kw)
    k2 = rs.shadow_sweep_cuda(vol, coarse, start, target, excl, active, **kw)
    assert torch.equal(got, want) and torch.equal(got, k2)
    assert int(want.sum()) > 0


def _queries_on(device, queries):
    return [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in q)
            for q in queries]


def _k5_k2_plain(vol, coarse, queries, n, cell_half, w, h):
    """(K5 on the queries' own tensors, plain K5 and K2 on them stacked)."""
    from cellularautomatons3d_tpu_torch.render import render_slab as rs

    kw = dict(grid_size=n, cell_half=cell_half)
    start, target, excl, active = rs.stack_occlusion_queries(queries, w, h)
    got = rs.shadow_sweep_multi_cuda(vol, coarse, *zip(*queries), **kw)
    want = rs.shadow_sweep_multi(vol, start, target, rs.pack_exclusion(excl, n), active, **kw)
    k2 = rs.shadow_sweep_cuda(vol, coarse, start, target, excl, active, **kw)
    return got, want, k2


@pytest.mark.parametrize("window", [(128, 64), (37, 13)], ids=["128x64", "37x13"])
@pytest.mark.parametrize("nq", range(1, 9))
def test_k5_queries_kernel_matches_plain_and_k2(cuda, nq, window):
    """K5 on queries where the lighting code leaves them (broadcast [3]
    targets, int32 and int64 cells, excluded cells at -1, n and 2n + 3),
    on a window that fills its tiles and one that does not: flags equal the
    plain K5's on the stacked queries and K2's; with every lane inactive
    all 0."""
    w, h = window
    vol = random_volume(cuda, 5, 0.05)
    coarse = coarse_occupancy(vol)
    queries = _queries_on(cuda, occlusion_queries(N, nq, h, w, seed=nq))
    cell_half = float(np.float32(1.0 / N) * np.float32(0.85) * np.float32(0.5))
    got, want, k2 = _k5_k2_plain(vol, coarse, queries, N, cell_half, w, h)
    assert torch.equal(got, want) and torch.equal(got, k2)
    assert int(want.sum()) > 0
    idle = [(s, t, e, torch.zeros_like(a)) for s, t, e, a in queries]
    assert int(_k5_k2_plain(vol, coarse, idle, N, cell_half, w, h)[0].sum()) == 0


@pytest.mark.parametrize("case", BOX_CASES)
@pytest.mark.parametrize("n", [64, 320, 512])
def test_k5_box_edges_match_plain_and_k2(cuda, n, case):
    """K5 on the box-edge volumes (its launch's box: empty, at a corner, on
    a face, at the centre, the whole volume), half the rays aimed through
    the region: flags equal the plain K5's and K2's; the entry point
    reports its box launch."""
    from cellularautomatons3d_tpu_torch.ops.occupancy import occupied_box_cuda

    words, region = box_edge_volume(n, case, n + 2)
    vol = ct.from_reference(words, cuda)
    coarse = coarse_occupancy(vol)
    queries = _queries_on(cuda, occlusion_queries(n, 4, 64, 128, seed=n, region=region))
    cell_half = float(np.float32(1.0 / n) * np.float32(0.85) * np.float32(0.5))
    boxes = occupied_box_cuda.launches
    got, want, k2 = _k5_k2_plain(vol, coarse, queries, n, cell_half, 128, 64)
    assert occupied_box_cuda.launches == boxes + 2  # K5's and K2's entry points
    assert torch.equal(got, want) and torch.equal(got, k2)
    assert (int(want.sum()) > 0) == (case != "empty")


@pytest.mark.parametrize("window", [(128, 64), (37, 13)], ids=["128x64", "37x13"])
@pytest.mark.parametrize("n", [64, 320, 512])
def test_k3_queries_kernel_matches_plain(cuda, n, window):
    """K3 on 8 lookups where the lighting code leaves them (int32 and int64
    coordinates in [-3, 2n + 5], a quarter exactly -1, n or 2n + 3), on a
    window whose pixel count is a multiple of 8 and one that is not (the
    scalar tail): states equal the plain K3's on the stacked lookups and,
    at 64³, the numpy oracle; with every lane inactive all 0."""
    from cellularautomatons3d_tpu_torch.render import render_slab as rs

    w, h = window
    queries = cell_queries(n, 8, h, w, seed=n + w)
    if n == N:
        dense = (np.random.default_rng(3).random((N,) * 3) < 0.3).astype(np.uint8)
        vol = ct.from_reference(ct.pack_grid(dense), cuda)
    else:
        vol = sparse_volume(cuda, n, 0.1, n)
    tq = _queries_on(cuda, queries)
    got = rs.cell_state_cuda(vol, *zip(*tq), grid_size=n)
    coords, active = rs.stack_cell_queries(tq, w, h)
    want = rs.cell_state(vol, coords, active, grid_size=n)
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    if n == N:
        np.testing.assert_array_equal(got.cpu().numpy(), cell_states_oracle(dense, queries))
    assert int(want.sum()) > 0
    idle = [(c, torch.zeros_like(a)) for c, a in tq]
    assert int(rs.cell_state_cuda(vol, *zip(*idle), grid_size=n).sum()) == 0


def test_k5_and_k3_on_an_empty_volume(cuda):
    """An empty volume: K5's box is empty and every flag 0; K3 finds no
    live cell."""
    from cellularautomatons3d_tpu_torch.render import render_slab as rs

    vol = torch.zeros((N // 32, N, N), dtype=torch.int32, device=cuda)
    queries = _queries_on(cuda, occlusion_queries(N, 4, 64, 128, seed=4))
    got, want, k2 = _k5_k2_plain(vol, coarse_occupancy(vol), queries, N, 0.005, 128, 64)
    assert int(got.sum()) == int(want.sum()) == int(k2.sum()) == 0
    tq = _queries_on(cuda, cell_queries(N, 4, 64, 128, seed=4))
    assert int(rs.cell_state_cuda(vol, *zip(*tq), grid_size=N).sum()) == 0


BAND = dict(width=1920, height=64, row0=480)  # rows 480-543 of a 1080p window


def _band_cam(view):
    return rf.pack_cam(VIEWS[view], 1920, 1080, (0.721, 1.0, 1.0), 5.0, 0.85, 0.29,
                       (0.17,) * 3, (0.0,) * 3, row0=BAND["row0"])


def _dilated_twice(coarse):
    from cellularautomatons3d_tpu_torch.ops.occupancy import dilate_occupancy

    return dilate_occupancy(dilate_occupancy(coarse, dilate_z=False), dilate_z=False,
                            dilate_y=False)


@pytest.mark.parametrize("view", list(VIEWS))
@pytest.mark.parametrize("n", [64, 96, 256])
def test_k6_kernel_matches_plain(cuda, n, view):
    """K6 on the undilated mip (4 lanes per patch, dilated on read) against
    the plain prepass on the twice-dilated mip and the plain per-column
    twin, bit for bit, on the 1080p band, at 128×64 and at 203×61."""
    coarse = coarse_occupancy(sparse_volume(cuda, n, 0.002, 3))
    pre = _dilated_twice(coarse)
    for cam, w, h in ((_band_cam(view), BAND["width"], BAND["height"]),
                      *((rf.pack_cam(VIEWS[view], w, h, (0.721, 1.0, 1.0), 5.0, 0.85, 0.29,
                                     (0.17,) * 3, (0.0,) * 3), w, h)
                        for w, h in ((W, H), (203, 61)))):
        kw = dict(grid_size=n, width=w, height=h)
        got = rf.prepass_cuda(coarse, cam, **kw)
        want = rf.prepass(pre, cam, **kw)
        assert torch.equal(got, want)
        assert torch.equal(rf.prepass_columns(coarse, cam, **kw), want)
        assert bool((want != 0).any())


@pytest.mark.parametrize("compose", [False, True])
@pytest.mark.parametrize("view", ["front", "oblique"])
@pytest.mark.parametrize("window", ["1080p", "small"])
@pytest.mark.parametrize("n", [64, 256])
def test_k1_inline_prepass_matches_given_mask(cuda, n, window, view, compose):
    """K1 computing its own patch masks (``prepass=True``) renders K1's
    frame given the plain masks and its frame without the prepass, bit for
    bit: at 1920×1080, where the masks gate, and at 128×64, where the gate
    is forced open and the prologue is skipped."""
    vol = sparse_volume(cuda, n, 0.002 if n == 64 else 0.0005, 3)
    coarse = coarse_occupancy(vol)
    w, h = (1920, 1080) if window == "1080p" else (W, H)
    cam = rf.pack_cam(VIEWS[view], w, h, (0.721, 1.0, 1.0), 5.0, 0.85, 0.29, (0.17,) * 3,
                      (0.0,) * 3)
    assert rf.mask_gate_forced(cam) == (window == "small")
    kw = dict(grid_size=n, width=w, height=h, shadow=True)
    hist = None
    if compose:
        rgb, _, idx = rf.raytrace_cuda(vol, coarse, cam, **kw)
        hist = (torch.clamp(rgb * 1.5, 0, 1).contiguous(), idx.contiguous())
    plain_mask = rf.prepass(_dilated_twice(coarse), cam, grid_size=n, width=w, height=h)
    launches = rf.raytrace_cuda.prepass_launches
    got = rf.raytrace_cuda(vol, coarse, cam, hist, prepass=True, **kw)
    assert rf.raytrace_cuda.prepass_launches == launches + 1
    given = rf.raytrace_cuda(vol, coarse, cam, hist, colmask=plain_mask, **kw)
    none = rf.raytrace_cuda(vol, coarse, cam, hist, **kw)
    for a, b, c in zip(got, given, none):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert int((none[2] >= 0).sum()) > 0
    gated = (plain_mask != -1) & (plain_mask != 0)
    assert bool(gated.any()) and not bool((plain_mask[gated] == (1 << n // 8) - 1).all())


@pytest.mark.parametrize("compose", [False, True])
@pytest.mark.parametrize("mask", ["prepass", "random"])
@pytest.mark.parametrize("window", ["small", "band"])
def test_k1_mask_kernel_matches_plain(cuda, window, mask, compose):
    """K1 with a column mask (the prepass's, or random bits) against the
    plain K1 with the same mask, at 64³ on a 128×64 window (where the gate
    is forced open) and on a 1920×64 band of 1080p (where it gates)."""
    vol = random_volume(cuda, 5, 0.05)
    coarse = coarse_occupancy(vol)
    if window == "small":
        w, h = W, H
        cam = rf.pack_cam(VIEWS["oblique"], W, H, (0.721, 1.0, 1.0), 5.0, 0.85, 0.29,
                          (0.17,) * 3, (0.0,) * 3)
    else:
        w, h = BAND["width"], BAND["height"]
        cam = _band_cam("oblique")
    assert rf.mask_gate_forced(cam) == (window == "small")
    kw = dict(grid_size=N, width=w, height=h, shadow=True)
    if mask == "prepass":
        colmask = rf.prepass_mask(coarse, cam, grid_size=N, width=w, height=h)
    else:
        colmask = torch.randint(-2**31, 2**31 - 1, (h // 8, w // 8), dtype=torch.int32,
                                device=cuda, generator=torch.Generator(cuda).manual_seed(2))
    hist = None
    if compose:
        rgb, _, idx = rf.raytrace(vol, coarse, cam, **kw)
        hist = (torch.clamp(rgb * 1.5, 0, 1).contiguous(), idx.contiguous())
    got = rf.raytrace_cuda(vol, coarse, cam, hist, colmask=colmask, **kw)
    want = rf.raytrace(vol, coarse, cam, hist, colmask=colmask, **kw)
    assert torch.equal(got[2], want[2]) and int((want[2] >= 0).sum()) > 0
    torch.testing.assert_close(got[1], want[1], atol=3e-5, rtol=0)
    torch.testing.assert_close(got[0], want[0], atol=3e-4, rtol=3e-3)
    if compose:
        torch.testing.assert_close(got[3], want[3], atol=3e-4, rtol=3e-3)


@pytest.mark.parametrize("view", list(VIEWS))
def test_k1_prepass_equals_no_mask_at_1080p(cuda, view):
    """At the reference's window the prepass mask is conservative: K1 with
    it renders K1's frame without it (a 1920×64 band of 1080p, 64³)."""
    vol = random_volume(cuda, 5, 0.05)
    coarse = coarse_occupancy(vol)
    cam = _band_cam(view)
    kw = dict(grid_size=N, width=BAND["width"], height=BAND["height"])
    got = rf.raytrace_tiles(vol, coarse, cam, use_prepass=True, **kw)
    want = rf.raytrace_tiles(vol, coarse, cam, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int((want[2] >= 0).sum()) > 0


def test_k1_prepass_exact_at_small_window(cuda):
    """At 128×64 the mask gate is forced open: the prepass frame is K1's
    frame without the prepass, from every view, in both modes."""
    vol = random_volume(cuda, 5, 0.05)
    coarse = coarse_occupancy(vol)
    kw = dict(grid_size=N, width=W, height=H)
    for view in VIEWS:
        cam = rf.pack_cam(VIEWS[view], W, H, (0.721, 1.0, 1.0), 5.0, 0.85, 0.29,
                          (0.17,) * 3, (0.0,) * 3)
        want = rf.raytrace_tiles(vol, coarse, cam, **kw)
        hist = (torch.clamp(want[0] * 1.5, 0, 1).contiguous(), want[2].contiguous())
        for history in (None, hist):
            got = rf.raytrace_tiles(vol, coarse, cam, history, use_prepass=True, **kw)
            ref = rf.raytrace_tiles(vol, coarse, cam, history, **kw)
            for a, b in zip(got, ref):
                assert torch.equal(a, b)
        assert int((want[2] >= 0).sum()) > 0


@pytest.mark.parametrize("compose", [False, True])
def test_k1_no_sweep_kernel_is_the_empty_volume_frame(cuda, compose):
    """K1 with ``no_sweep`` gives the kernel's frame of an empty volume
    bit for bit, and the plain K1's within the contract."""
    vol = random_volume(cuda, 5, 0.05)
    empty = torch.zeros_like(vol)
    cam = rf.pack_cam(mat4.initial_view_matrix(), W, H, (0.721, 1.0, 1.0), 5.0, 0.85,
                      0.29, (0.17,) * 3, (0.0,) * 3, emissive_color=(0.02, 0.03, 0.04),
                      emissive_strength=0.5)
    kw = dict(grid_size=N, width=W, height=H, shadow=True)
    hist = None
    if compose:
        rgb, _, idx = rf.raytrace_cuda(vol, coarse_occupancy(vol), cam, **kw)
        hist = (torch.clamp(rgb * 1.5, 0, 1).contiguous(), idx.contiguous())
    got = rf.raytrace_cuda(vol, coarse_occupancy(vol), cam, hist, no_sweep=True, **kw)
    same = rf.raytrace_cuda(empty, coarse_occupancy(empty), cam, hist, **kw)
    want = rf.raytrace(empty, None, cam, hist, **kw)
    for a, b in zip(got, same):
        assert torch.equal(a, b)
    assert torch.equal(got[2], want[2]) and bool((got[2] == -1).all())
    torch.testing.assert_close(got[1], want[1], atol=3e-5, rtol=0)
    for a, b in zip(got[:1] + got[3:], want[:1] + want[3:]):
        torch.testing.assert_close(a, b, atol=3e-4, rtol=3e-3)


def test_k5_engine_matches_cpu(cuda, monkeypatch):
    """The full-quality Engine with CA3D_OCC_SWEEP=0 (K5) on the card
    against the Engine on the CPU (plain K5)."""
    from cellularautomatons3d_tpu_torch.render import render_slab as rs

    monkeypatch.setenv("CA3D_OCC_SWEEP", "0")
    rs.shadow_sweep_multi_cuda.launches = 0
    cfg = dict(grid_size=N, width=W, height=H, soft_shadow_samples=4,
               indirect_lighting=True, light_radius=0.08)
    out = []
    for dev in (cuda, "cpu"):
        eng = ct.Engine(device=dev, **cfg)
        eng.step(20)
        frames = [eng.render() for _ in range(2)] + [eng.run_fused(2, reset_every=1)]
        out.append(([f.cpu() for f in frames], eng.history.hit_idx.cpu()))
    (gpu, gidx), (cpu, cidx) = out
    assert rs.shadow_sweep_multi_cuda.launches > 0
    assert torch.equal(gidx, cidx)
    for a, b in zip(gpu, cpu):
        torch.testing.assert_close(a, b, rtol=3e-3, atol=3e-4)


# ------------------------------------------------- multi-state rules ---


def random_ages(device, n, total_states, seed, p_dead=0.6):
    """Age bit-planes [B, n/32, n, n] of a random volume of valid ages
    (cells on every face), and the dense ages."""
    from cellularautomatons3d_tpu_torch.ops import ca_reference

    rng = np.random.default_rng(seed)
    ages = rng.integers(1, total_states, (n, n, n)).astype(np.uint8)
    ages[rng.random((n, n, n)) < p_dead] = 0
    dense = torch.from_numpy(ages).to(device)
    nbits = max(1, (total_states - 1).bit_length())
    return ca_reference.dense_to_planes(dense, nbits), dense


@pytest.mark.parametrize("boundary", ct.BoundaryMode.ALL)
@pytest.mark.parametrize("total_states", [3, 5, 8, 10])
def test_multistate_step_kernel_matches_plain_and_dense(cuda, total_states, boundary):
    """The multi-state step kernel against the plain step, bit for bit, and against the dense oracle, over every neighbourhood."""
    from cellularautomatons3d_tpu_torch.ops import ca_reference

    for i, neighbourhood in enumerate(ct.NEIGHBOURHOOD_MAP):
        spec = ct.AutomatonSpec.from_rule_strings(
            N, neighbourhood=neighbourhood, born="2,4", survive="1-4",
            total_states=total_states, boundary=boundary,
        )
        a, dense = random_ages(cuda, N, total_states, 10 * total_states + i)
        b = a.clone()
        for _ in range(5):
            a = ca_step.step_packed_multistate_cuda(a, spec)
            b = ca_step.step_packed_multistate(b, spec)
            dense = ca_reference.step_dense(dense, spec)
            assert torch.equal(a, b)
            assert torch.equal(ca_reference.planes_to_dense(a), dense)
        assert int((dense > 1).sum()) > 0 and int((dense == 1).sum()) > 0


def test_multistate_step_kernel_on_invalid_encodings_and_two_states(cuda):
    """Ages >= S never arise from valid states; the kernel still equals the
    bit-sliced plain step on them.  total_states == 2 through the multi-state
    entry is the binary step."""
    g = torch.Generator(cuda).manual_seed(3)
    for total_states in (3, 5, 6, 10):
        spec = ct.AutomatonSpec.from_rule_strings(
            N, neighbourhood="moore", born="4-9", survive="3-12",
            total_states=total_states)
        a = torch.randint(-2**31, 2**31 - 1, (spec.age_bits, N // 32, N, N),
                          dtype=torch.int32, device=cuda, generator=g)
        got = ca_step.step_packed_multistate_cuda(a, spec)
        assert torch.equal(got, ca_step.step_packed_multistate(a, spec))
    spec = ct.AutomatonSpec.from_rule_strings(N)
    vol = random_volume(cuda, 1, 0.2)
    got = ca_step.step_packed_multistate_cuda(vol[None], spec)
    assert torch.equal(got[0], ca_step.fires_plane(vol, spec))


@pytest.mark.parametrize("states", [2, 10])
@pytest.mark.parametrize("boundary", ct.BoundaryMode.ALL)
@pytest.mark.parametrize("n", [32, 96])
def test_ca_step_kernel_tiles(cuda, n, boundary, states):
    """The step kernel's tiling at the sizes that stress it: n = 32 (one
    word along x, whose x-wrap is itself; one y tile, four z tiles) and
    n = 96 (three words along x, three y tiles, twelve z tiles), Moore and
    von Neumann, binary and 10 states, bit-exact against the plain step
    (and the dense oracle) over 5 generations."""
    from cellularautomatons3d_tpu_torch.ops import ca_reference

    for i, neighbourhood in enumerate(("moore", "von neumann")):
        spec = ct.AutomatonSpec.from_rule_strings(
            n, neighbourhood=neighbourhood, born="2,4", survive="1-4",
            total_states=states, boundary=boundary)
        if states == 2:
            rng = np.random.default_rng(n + i)
            a = ct.from_reference(ct.pack_grid((rng.random((n,) * 3) < 0.2).astype(np.uint8)),
                                  cuda)
        else:
            a, dense = random_ages(cuda, n, states, n + i)
        b = a.clone()
        for _ in range(5):
            a, b = ca_step.step_packed(a, spec), ca_step.step_packed(b.cpu(), spec).to(cuda)
            assert torch.equal(a, b)
            if states > 2:
                dense = ca_reference.step_dense(dense, spec)
                assert torch.equal(ca_reference.planes_to_dense(a), dense)
        assert int((a != 0).sum()) > 0


@pytest.mark.parametrize("states", [2, 10])
def test_ca_step_kernel_wide_halo(cuda, states):
    """Offsets beyond the six neighbourhoods' radius (|dy|, |dz| up to 3,
    |dx| up to 31) widen the kernel's halo; every boundary mode, 64³."""
    import dataclasses

    n = 64
    for boundary in ct.BoundaryMode.ALL:
        spec = dataclasses.replace(
            ct.AutomatonSpec.from_rule_strings(n, born="1,3", survive="1-2",
                                               total_states=states, boundary=boundary),
            offsets_main=((0, 2, 0), (0, 0, -3), (5, 0, 0), (-31, 1, 1), (0, -2, 2), (1, 1, 0)))
        assert ca_step._step_plan(spec) == (3, 1)
        if states == 2:
            a = random_volume(cuda, 2, 0.1)
        else:
            a, _ = random_ages(cuda, n, states, 2)
        b = a.clone()
        for _ in range(3):
            a, b = ca_step.step_packed(a, spec), ca_step.step_packed(b.cpu(), spec).to(cuda)
            assert torch.equal(a, b)


def test_age_masks_kernel_matches_plain(cuda):
    for total_states in (3, 5, 10):
        planes, _ = random_ages(cuda, N, total_states, total_states)
        alive, vis = ca_step.age_masks_cuda(planes)
        want_alive, want_vis = ca_step.age_masks(planes)
        assert torch.equal(alive, want_alive) and torch.equal(vis, want_vis)
        assert ca_step.age_masks_cuda(planes, alive=False)[0] is None
        spec = ct.AutomatonSpec.from_rule_strings(N, total_states=total_states)
        assert torch.equal(ca_step.visibility_plane(planes, spec), want_vis)


@pytest.mark.parametrize("compose", [False, True])
@pytest.mark.parametrize("shadow", [True, False])
def test_k1_kernel_with_ages_matches_plain(cuda, shadow, compose):
    total_states = 8
    ages, dense = random_ages(cuda, N, total_states, 5, p_dead=0.95)
    vol = ca_step.age_masks_cuda(ages, alive=False)[1]
    coarse = coarse_occupancy(vol)
    cam = rf.pack_cam(
        mat4.initial_view_matrix(), W, H, (0.721, 1.0, 1.0), 5.0, 0.85, 0.29,
        (0.17,) * 3, (0.0,) * 3, emissive_color=(0.02, 0.03, 0.04),
        emissive_strength=0.5,
    )
    kw = dict(grid_size=N, width=W, height=H, shadow=shadow, ages=ages,
              total_states=total_states)
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
    # The fade is there: the frame differs from the binary frame of the
    # same visibility plane wherever a dying cell was hit.
    binary = rf.raytrace_cuda(vol, coarse, cam, hist, grid_size=N, width=W,
                              height=H, shadow=shadow)
    assert torch.equal(binary[2], got[2])
    hit_age = dense.reshape(-1)[got[2].clamp(min=0).long()]  # id = x + y·n + z·n²
    dying = (got[2] >= 0) & (hit_age > 1)
    assert int(dying.sum()) > 0
    if not compose:
        assert bool((got[0][dying] <= binary[0][dying]).all())
        assert bool((got[0][dying] < binary[0][dying]).any())
        assert torch.equal(got[0][~dying], binary[0][~dying])


@pytest.mark.parametrize("n", [64, 320])
def test_k4_kernel_with_ages_matches_plain(cuda, n):
    from cellularautomatons3d_tpu_torch.render import render_slab as rs

    total_states = 10
    ages, dense = random_ages(cuda, n, total_states, n, p_dead=0.995)
    vol = ca_step.age_masks_cuda(ages, alive=False)[1]
    coarse = coarse_occupancy(vol)
    w, h = 256, 128
    cam = rf.pack_cam(VIEWS["oblique"], w, h, (0.721, 1.0, 1.0), 5.0, 0.85, 0.29,
                      (0.17,) * 3, (0.0,) * 3)
    kw = dict(grid_size=n, width=w, height=h)
    t_k, i_k, a_k = rs.primary_sweep_cuda(vol, coarse, cam, ages, **kw)
    t_p, i_p, a_p = rs.primary_sweep(vol, cam, ages, **kw)
    assert torch.equal(i_k, i_p) and torch.equal(a_k, a_p)
    torch.testing.assert_close(t_k, t_p, atol=3e-5, rtol=0)
    hit = i_p >= 0
    assert int(hit.sum()) > 0 and bool((a_p[~hit] == 1).all())
    want = dense.reshape(-1)[i_p.clamp(min=0).long()]  # id = x + y·n + z·n²
    assert torch.equal(a_p[hit], want[hit].to(torch.int32))
    assert len(torch.unique(a_p[hit])) == total_states - 1
    # Without ages the binary outputs are unchanged.
    t_b, i_b = rs.primary_sweep_cuda(vol, coarse, cam, **kw)
    assert torch.equal(i_b, i_k) and torch.equal(t_b, t_k)


@pytest.mark.parametrize("variant", [{}, dict(**LIGHTING_320, gi_temporal=True)])
@pytest.mark.parametrize("grid", [64, 320])
def test_multistate_engine_cuda_matches_cpu(cuda, grid, variant):
    cfg = dict(grid_size=grid, width=64, height=32, **ct.PRESETS["pyroclastic"],
               random_initial_state=True, **variant)
    out = []
    for device in ("cuda", "cpu"):
        e = ct.Engine(device=device, **cfg)
        e.step(12 if grid == 64 else 70)  # the blob must span a few 64×32 pixels
        frames = [e.render(), e.render(), e.run_fused(2, reset_every=1)]
        out.append(([f.cpu() for f in frames], e.history.hit_idx.cpu(), e.state.cpu()))
    (gpu, gidx, gstate), (cpu, cidx, cstate) = out
    assert torch.equal(gstate, cstate) and torch.equal(gidx, cidx)
    assert int((cidx >= 0).sum()) > 0
    for a, b in zip(gpu, cpu):
        torch.testing.assert_close(a, b, atol=3e-4, rtol=3e-3)


# ------------------------------------------- the exact reference pipeline ---

REFERENCE_VARIANTS = {
    "clustered": {},
    "simple": dict(render_variant="simple"),
    "lighting": dict(LIGHTING_320),
    "two_bounces": dict(LIGHTING_320, indirect_bounces=2),
    "pyroclastic": dict(ct.PRESETS["pyroclastic"], random_initial_state=True),
    # BASELINE config 1's rule; the preset dies out from the Engine's seed,
    # so both devices load the same random ages (REFERENCE_START).
    "amoeba": dict(ct.PRESETS["amoeba-445"], render_variant="simple"),
}
# Dense start states loaded on both devices, by variant.
REFERENCE_START = {"amoeba": lambda: random_ages("cpu", N, 5, 17, p_dead=0.7)[1].numpy()}
# The card against the CPU: the same torch ops in the same order, float64
# sin, IEEE division and sqrt on both; a stated share of pixels may still
# differ (pow's last bit through the f16 history).
REFERENCE_CARD_MISMATCH = 1e-3


def test_reference_functions_card_equal_cpu(cuda):
    """The hash, the saturating conversion, cell addressing, the wrapped
    lookup far outside the volume, the texel fetch on non-finite uv and the
    shadow march: bit for bit on the card and the CPU."""
    from cellularautomatons3d_tpu_torch.render import intersect as ti
    from cellularautomatons3d_tpu_torch.render import raymarch as tm
    from cellularautomatons3d_tpu_torch.render import renderer as tr

    rng = np.random.default_rng(40)
    special = torch.tensor([np.nan, np.inf, -np.inf, 3e9, -3e9, 2147483520.0, 2.5, -2.5,
                            -0.5, 0.0, 63.99, 64.0], dtype=torch.float32)
    n = torch.from_numpy(rng.uniform(-1.0, 1.1, (1 << 16, 2)).astype(np.float32))
    pts = torch.from_numpy(rng.uniform(-40, 40, (1 << 14, 3)).astype(np.float32))
    pts = torch.cat([pts, special.reshape(-1, 3)])
    coords = torch.from_numpy(rng.integers(0, 2**31 - 1, (1 << 14, 3)).astype(np.int32))
    vol = random_volume("cpu", 41, 0.2)
    img = torch.from_numpy(rng.random((H, W, 4)).astype(np.float16))
    uv = torch.cartesian_prod(special, special)
    start = torch.from_numpy(rng.uniform(-0.49, 0.49, (1 << 14, 3)).astype(np.float32))
    end = torch.tensor([0.721, 1.0, 1.0]).expand_as(start).contiguous()
    rnd = torch.from_numpy(rng.random(1 << 14).astype(np.float32))

    def run(dev):
        d = lambda x: x.to(dev)  # noqa: E731
        cells = ti.cell_from_sample_point(d(start), N)[0]
        return [
            ti.nrand(d(n)), ti.n1rand(d(n), np.float32(12.345)), ti.to_int32(d(special)),
            *ti.cell_from_sample_point(d(pts), N),
            ti.get_cell_state(d(vol).reshape(-1), d(coords), N),
            tr._texture_load(d(img), d(uv), W, H),
            tm.ray_march_shadow(d(vol).reshape(-1), d(start), d(end), cells, d(rnd),
                                grid_size=N, cell_size_mul=0.85, shadow_samples=30),
        ]

    for a, b in zip(run(cuda), run("cpu")):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("variant", list(REFERENCE_VARIANTS))
def test_reference_engine_cuda_matches_cpu(cuda, variant):
    """Engine(pipeline="reference") at 64³ / 256×128 on the card and the CPU
    over 4 ticks, a camera move before the last two: states equal, frames
    by the reference tests' comparison."""
    from _torch_reference_scene import compare

    cfg = dict(grid_size=N, width=256, height=128, pipeline="reference",
               **REFERENCE_VARIANTS[variant])
    dense = REFERENCE_START[variant]() if variant in REFERENCE_START else None
    out = []
    for device in ("cuda", "cpu"):
        e = ct.Engine(device=device, **cfg)
        if dense is not None:
            e.set_state_dense(dense)
        e.camera.translate((1, 0, 0), 0.01)  # off the GI 0/0 diagonal
        e.step(12)
        frames = []
        for i in range(4):
            if i >= 2:
                e.camera.translate((1, 0, -1), 0.02)
                e.camera.mouse_look(4.0, -2.0)
            f = e.tick()
            frames.append((f.cpu().numpy(), e.history.color.cpu().numpy(),
                           e.history.depth.cpu().numpy()))
        out.append((frames, e.state.cpu()))
    (gpu, gstate), (cpu, cstate) = out
    assert torch.equal(gstate, cstate)
    for a, b in zip(gpu, cpu):
        compare(a, b, depth=REFERENCE_CARD_MISMATCH, rgb=REFERENCE_CARD_MISMATCH)
    assert (cpu[-1][0].sum(-1) > 0).sum() > 100


@pytest.mark.parametrize("states", [2, 10])
@pytest.mark.parametrize("n,shape", [(32, (8,)), (32, (32,)), (32, (4, 2)), (32, (2, 4)),
                                     (32, (2, 16)), (96, (3, 3))])
def test_ca_step_slab_kernel(cuda, n, shape, states):
    """The slab mode of the step kernel (every shard of a mesh on one card)
    against the plain slab step on the same halos, and the sharded step
    against the single-device step, the slab's own halos arbitrary: Moore and
    von Neumann, every boundary mode, at 32³ (shards of 4 and 1 z planes, of
    16 and 2 y columns) and 96³ over (3, 3), bit for bit over 3
    generations."""
    from cellularautomatons3d_tpu_torch.parallel import sharded

    k = int(np.prod(shape))
    mesh = sharded.make_mesh(k, devices=[cuda] * k, shape=shape if len(shape) == 2 else None)
    for i, neighbourhood in enumerate(("moore", "von neumann")):
        for boundary in ct.BoundaryMode.ALL:
            spec = ct.AutomatonSpec.from_rule_strings(
                n, neighbourhood=neighbourhood, born="2,4", survive="1-4",
                total_states=states, boundary=boundary)
            if states == 2:
                rng = np.random.default_rng(n + i)
                a = ct.from_reference(
                    ct.pack_grid((rng.random((n,) * 3) < 0.3).astype(np.uint8)), cuda)
            else:
                a, _ = random_ages(cuda, n, states, n + i)
            step = sharded.make_sharded_step(spec, mesh)
            st, ref = sharded.shard_state(a, mesh), a
            for _ in range(3):
                shard = st.shards.flat[k // 2]
                alive = shard if states == 2 else ca_step.age_masks_cuda(shard, vis=False)[0]
                zh = (torch.zeros_like(alive[:, :1]), alive[:, -1:].contiguous())
                yh = None
                if len(shape) == 2:
                    z2 = alive.shape[1] + 2
                    yh = tuple(torch.full((alive.shape[0], z2, 1), v, dtype=torch.int32,
                                          device=cuda) for v in (-1, 0x5555))
                got = ca_step.step_slab(shard, alive, zh, yh, spec)
                want = ca_step.step_slab(shard.cpu(), alive.cpu(),
                                         tuple(t.cpu() for t in zh),
                                         None if yh is None else tuple(t.cpu() for t in yh),
                                         spec)
                assert torch.equal(got.cpu(), want)
                st, ref = step(st), ca_step.step_packed(ref, spec)
                assert torch.equal(st.full(), ref)
            assert int((ref != 0).sum()) > 0


def test_ca_step_slab_kernel_refuses(cuda):
    spec = ct.AutomatonSpec.from_rule_strings(32)
    slab = torch.zeros((1, 4, 32), dtype=torch.int32, device=cuda)
    zh = (slab[:, :1].clone(), slab[:, :1].clone())
    with pytest.raises(ValueError, match="z halo 1"):
        ca_step.fires_slab_cuda(slab, (zh[0], zh[1][:, :, :16]), None, spec)
    with pytest.raises(ValueError, match="z halo 1 must be a CUDA tensor"):
        ca_step.fires_slab_cuda(slab, (zh[0], zh[1].cpu()), None, spec)
    import dataclasses

    deep = dataclasses.replace(spec, offsets_main=((0, 0, 2),))
    with pytest.raises(RuntimeError, match="ca_step_slab"):
        ca_step.fires_slab_cuda(slab, zh, None, deep)


def test_cuda_time_fn_queued_reads_the_device(cuda):
    """``cuda_time_fn(queued=True)`` times the device alone: 8 tiny launches
    a call read far less than the host's enqueue does, one 512³ step reads
    the kernel's time either way, and a call that synchronises raises."""
    from cellularautomatons3d_tpu_torch.utils.metrics import cuda_time_fn

    spec = ct.AutomatonSpec.from_rule_strings(32)
    small = random_volume(cuda, 3, 0.2)[:1, :32, :32].contiguous()
    tiny = lambda: [ca_step.fires_plane_cuda(small, spec) for _ in range(8)]  # noqa: E731
    assert 0.0 < cuda_time_fn(tiny, reps=20, queued=True) < cuda_time_fn(tiny, reps=20)
    big_spec = ct.AutomatonSpec.from_rule_strings(512)
    g = torch.Generator(cuda).manual_seed(1)
    words = torch.randint(-2**31, 2**31 - 1, (16, 512, 512), dtype=torch.int32, device=cuda,
                          generator=g)
    step = lambda: ca_step.fires_plane_cuda(words, big_spec)  # noqa: E731
    queued, events = cuda_time_fn(step, reps=20, queued=True), cuda_time_fn(step, reps=20)
    assert queued == pytest.approx(events, rel=0.25)
    with pytest.raises(RuntimeError, match="could not enqueue"):
        cuda_time_fn(lambda: torch.cuda.synchronize(), reps=2, warmup=0, queued=True)


K1_OPTIONS = {
    "mip1": dict(mip1=True), "slicegate": dict(slicegate=True),
    "mip1_prepass": dict(mip1=True, prepass=True),
    "slicegate_prepass": dict(slicegate=True, prepass=True),
    "noskip": dict(column_skip=False),
}


@pytest.mark.parametrize("compose", [False, True])
@pytest.mark.parametrize("option", list(K1_OPTIONS))
@pytest.mark.parametrize("window", ["small", "band"])
def test_k1_descent_options_equal_default(cuda, window, option, compose):
    """K1's descents (the plane-mip gate, the prefetched column, every
    column descended) render the default kernel's frame bit for bit (the
    prepass kernel's, with ``prepass``), and the plain twin's within the
    contract, with ages too; each counts its launch."""
    from cellularautomatons3d_tpu_torch.ops.occupancy import plane_occupancy

    vol = random_volume(cuda, 5, 0.05)
    coarse = coarse_occupancy(vol)
    if window == "small":
        w, h = W, H
        cam = rf.pack_cam(VIEWS["oblique"], W, H, (0.721, 1.0, 1.0), 5.0, 0.85, 0.29,
                          (0.17,) * 3, (0.0,) * 3)
    else:
        w, h = BAND["width"], BAND["height"]
        cam = _band_cam("oblique")
    g = torch.Generator(cuda).manual_seed(4)
    ages = torch.randint(-2**31, 2**31 - 1, (3, *vol.shape), dtype=torch.int32, device=cuda,
                         generator=g) & vol
    options = dict(K1_OPTIONS[option])
    if options.pop("mip1", False):
        options["mip1"] = plane_occupancy(vol)
    prepass = options.get("prepass", False)
    counter = {"mip1": "mip1_launches", "slicegate": "slicegate_launches",
               "noskip": "noskip_launches"}[option.split("_")[0]]
    for extra in (dict(), dict(ages=ages, total_states=8)):
        kw = dict(grid_size=N, width=w, height=h, shadow=True, **extra)
        hist = None
        if compose:
            rgb, _, idx = rf.raytrace(vol, coarse, cam, **kw)
            hist = (torch.clamp(rgb * 1.5, 0, 1).contiguous(), idx.contiguous())
        before = getattr(rf.raytrace_cuda, counter)
        got = rf.raytrace_cuda(vol, coarse, cam, hist, **options, **kw)
        assert getattr(rf.raytrace_cuda, counter) == before + 1
        ref = rf.raytrace_cuda(vol, coarse, cam, hist, prepass=prepass, **kw)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        want = rf.raytrace(vol, coarse, cam, hist, mip1=options.get("mip1"), **kw)
        assert torch.equal(got[2], want[2]) and int((want[2] >= 0).sum()) > 0
        torch.testing.assert_close(got[1], want[1], atol=3e-5, rtol=0)
        torch.testing.assert_close(got[0], want[0], atol=3e-4, rtol=3e-3)


@pytest.mark.parametrize("variable", ["CA3D_MIP1", "CA3D_SLICEGATE"])
def test_k1_options_engine_matches_default(cuda, monkeypatch, variable):
    """The Engine's frames and fused loop under each variable (read per
    call) equal the default Engine's on the card, through the option's
    kernel."""
    cfg = dict(grid_size=N, width=W, height=H)
    out = []
    for on in (False, True):
        if on:
            monkeypatch.setenv(variable, "1")
        counts = (rf.raytrace_cuda.launches, rf.raytrace_cuda.mip1_launches,
                  rf.raytrace_cuda.slicegate_launches)
        eng = ct.Engine(device=cuda, **cfg)
        eng.step(20)
        frames = [eng.render(), eng.run_fused(4, reset_every=2)]
        torch.cuda.synchronize()
        k1, mip1, slicegate = (rf.raytrace_cuda.launches - counts[0],
                               rf.raytrace_cuda.mip1_launches - counts[1],
                               rf.raytrace_cuda.slicegate_launches - counts[2])
        assert k1 >= 5
        if not on:
            assert (mip1, slicegate) == (0, 0)
        else:
            assert (mip1, slicegate) == ((k1, 0) if variable == "CA3D_MIP1" else (0, k1))
        out.append([*frames, eng.history.hit_idx])
    for a, b in zip(*out):
        assert torch.equal(a, b)
