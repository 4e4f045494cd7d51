"""K5's and K3's entry contract: each query's tensors as the lighting passes
leave them (start and cells [H, W, 3], a target [H, W, 3] or one light
position [3], cells int32 or int64, active [H, W]), which the kernels read in
place.  On the CPU the same calls run the plain versions on the queries
stacked; here they are held to today's stacked plain twins: the occlusion
batch under ``CA3D_OCC_SWEEP=0`` (K5's path) to the plain K2 on
``stack_occlusion_queries``, and ``cell_state_batch`` (K3's path) to the
plain K3 on ``stack_cell_queries`` and to a numpy oracle on the dense grid,
for 1 to 8 queries, with broadcast targets, excluded cells outside the
volume (the −1 rule), coordinates at −1, n and 2n + 3, n = 320, and the
box-edge volumes.  No JAX call.

Tolerance: flags and states equal on every (query, pixel).
"""

import numpy as np
import pytest
import torch

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.render import render_slab

from _torch_box_scene import BOX_CASES, box_edge_volume
from _torch_query_scene import cell_queries, cell_states_oracle, occlusion_queries

N = 64
W, H = 32, 16
CELL_HALF = float(np.float32(1.0 / N) * np.float32(0.85) * np.float32(0.5))
CAM = np.zeros(64, np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's many small torch ops (restored
    after the file)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def volume():
    rng = np.random.default_rng(5)
    return ct.from_reference(ct.pack_grid((rng.random((N,) * 3) < 0.05).astype(np.uint8)))


def as_torch(queries):
    return [tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in q) for q in queries]


def k5_path(monkeypatch, vol, queries, n, cell_half, nq_chunk):
    """The occlusion batch through K5's path in chunks of nq_chunk (a chunk
    of one too), with the plain K5 calls counted."""
    monkeypatch.setenv("CA3D_OCC_SWEEP", "0")
    monkeypatch.setenv("CA3D_OCC_NQ", str(nq_chunk))
    monkeypatch.setenv("CA3D_OCC_NQ1_SWEEP", "0")
    monkeypatch.setattr(render_slab, "_cell_half", lambda cam, size: cell_half)
    calls = []
    real = render_slab.shadow_sweep_multi

    def spy(vol_, start, *a, **kw):
        calls.append(start.shape[0])
        return real(vol_, start, *a, **kw)

    monkeypatch.setattr(render_slab, "shadow_sweep_multi", spy)
    h, w = queries[0][3].shape
    got = render_slab.shadow_occlusion_batch(
        CAM, queries, render_slab.prep_volume(vol), grid_size=n, width=w, height=h)
    assert sum(calls) == len(queries)
    return torch.stack(got).to(torch.int32)


def k2_plain(vol, queries, n, cell_half):
    h, w = queries[0][3].shape
    ops = render_slab.stack_occlusion_queries(queries, w, h)
    return render_slab.shadow_sweep(vol, *ops, grid_size=n, cell_half=cell_half)


@pytest.mark.parametrize("nq", range(1, 9))
def test_k5_queries_match_k2_plain(monkeypatch, volume, nq):
    """1 to 8 queries in one chunk, broadcast targets and int64 cells among
    them, excluded cells inside and outside the volume: K5's path equals the
    plain K2 on the stacked queries; flat rays are never occluded."""
    queries = as_torch(occlusion_queries(N, nq, H, W, seed=nq))
    got = k5_path(monkeypatch, volume, queries, N, CELL_HALF, nq)
    want = k2_plain(volume, queries, N, CELL_HALF)
    assert torch.equal(got, want)
    assert int(want.sum()) > 0
    start, target = queries[-1][0], queries[-1][1]
    if target.ndim == 3:
        assert not want[-1][target[..., 2] == start[..., 2]].any()


@pytest.mark.parametrize("case", BOX_CASES)
def test_k5_queries_box_edges_match_k2_plain(monkeypatch, case):
    """The box-edge volumes (an empty volume, a region at a corner, on a
    face, at the centre, the whole volume), half of the rays aimed through
    the region, in the dispatch's default chunks of 4."""
    words, region = box_edge_volume(N, case, N + 1)
    vol = ct.from_reference(words)
    queries = as_torch(occlusion_queries(N, 6, H, W, seed=len(case), region=region))
    got = k5_path(monkeypatch, vol, queries, N, CELL_HALF, 4)
    want = k2_plain(vol, queries, N, CELL_HALF)
    assert torch.equal(got, want)
    assert (int(want.sum()) > 0) == (case != "empty")


def test_k5_broadcast_target_and_wide_cells(monkeypatch, volume):
    """A [3] target gives the flags of the same target at every pixel, and
    int64 cells those of the same cells as int32."""
    start, target, excl, active = as_torch(occlusion_queries(N, 2, H, W, seed=9))[1]
    assert target.shape == (3,) and excl.dtype == torch.int64
    shared = [(start, target, excl, active)] * 2
    per_pixel = [(start, target.expand(H, W, 3).contiguous(), excl.to(torch.int32), active)] * 2
    got = k5_path(monkeypatch, volume, shared, N, CELL_HALF, 2)
    assert torch.equal(got, k5_path(monkeypatch, volume, per_pixel, N, CELL_HALF, 2))
    assert torch.equal(got, k2_plain(volume, per_pixel, N, CELL_HALF))
    assert int(got.sum()) > 0


@pytest.mark.parametrize("excl, occupied", [
    ((N, 4, 7), (0, 5, 7)),              # x == n aliases (0, y + 1, z)
    ((-1, 5, 7), (N - 1, 4, 7)),         # x == -1 aliases (n - 1, y - 1, z)
    ((2 * N + 3, 4, 7), (3, 6, 7)),      # x == 2n + 3 aliases (3, y + 2, z)
])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_k5_out_of_range_cell_skips_nothing(monkeypatch, excl, occupied, dtype):
    """A ray straight down -z through the occupied cell that a plain packing
    of the out-of-range excluded cell would name: K5's path sees the
    occluder, as K2 does."""
    dense = np.zeros((N, N, N), np.uint8)
    ox, oy, oz = occupied
    dense[oz, oy, ox] = 1  # dense grids are [z, y, x]
    vol = ct.from_reference(ct.pack_grid(dense))
    centre = lambda c: (c + 0.5) / N - 0.5  # noqa: E731
    start = torch.tensor([centre(ox), centre(oy), centre(oz + 2)]).reshape(1, 1, 3)
    target = start.reshape(3) + torch.tensor([1e-4, 0.0, -0.6])
    query = (start, target, torch.tensor(excl, dtype=dtype).reshape(1, 1, 3),
             torch.ones((1, 1), dtype=torch.bool))
    assert k5_path(monkeypatch, vol, [query] * 2, N, CELL_HALF, 2).tolist() == [[[1]], [[1]]]
    assert k2_plain(vol, [query], N, CELL_HALF).tolist() == [[[1]]]


def _k3_case(n, nq, seed, p):
    rng = np.random.default_rng(seed)
    dense = (rng.random((n,) * 3, dtype=np.float32) < p).astype(np.uint8)
    queries = cell_queries(n, nq, H, W, seed)
    return dense, queries


@pytest.mark.parametrize("nq", range(1, 9))
def test_k3_queries_match_plain_and_oracle(nq):
    """1 to 8 lookups with coordinates in [-3, 2n + 5] (a quarter exactly
    -1, n or 2n + 3), int32 and int64: K3's path equals the plain K3 on the
    stacked lookups and the numpy oracle state(max(c, 0) mod n)."""
    dense, queries = _k3_case(N, nq, nq, 0.3)
    vol = ct.from_reference(ct.pack_grid(dense))
    tq = as_torch(queries)
    got = render_slab.cell_state_batch(tq, render_slab.prep_volume(vol), grid_size=N,
                                       width=W, height=H)
    coords, active = render_slab.stack_cell_queries(tq, W, H)
    want = render_slab.cell_state(vol, coords, active, grid_size=N)
    oracle = cell_states_oracle(dense, queries)
    assert want.dtype == torch.uint8
    assert torch.equal(torch.stack(got), want)
    np.testing.assert_array_equal(want.numpy(), oracle)
    assert 0 < int(want.sum()) < int(active.sum())


@pytest.mark.parametrize("nq", [3, 8])
def test_k3_queries_at_320(nq):
    """n = 320 (not a power of two: the wrap's subtract and % differ from a
    mask)."""
    dense, queries = _k3_case(320, nq, 320 + nq, 0.02)
    vol = ct.from_reference(ct.pack_grid(dense))
    tq = as_torch(queries)
    got = torch.stack(render_slab.cell_state_batch(
        tq, render_slab.prep_volume(vol), grid_size=320, width=W, height=H))
    coords, active = render_slab.stack_cell_queries(tq, W, H)
    assert torch.equal(got, render_slab.cell_state(vol, coords, active, grid_size=320))
    np.testing.assert_array_equal(got.numpy(), cell_states_oracle(dense, queries))
    assert int(got.sum()) > 0


def test_k5_k3_wrappers_refuse_cpu_operands():
    """The kernel wrappers take CUDA tensors only, and at most 8 queries a
    launch; nothing is launched."""
    vol = ct.from_reference(np.zeros((N // 32, N, N), np.uint32))
    coarse = render_slab.prep_volume(vol).coarse
    start, target, excl, active = as_torch(occlusion_queries(N, 1, H, W, seed=1))[0]
    with pytest.raises(ValueError, match="CUDA tensor"):
        render_slab.shadow_sweep_multi_cuda(vol, coarse, [start], [target], [excl], [active],
                                            grid_size=N, cell_half=CELL_HALF)
    with pytest.raises(ValueError, match="1 to 8"):
        render_slab.shadow_sweep_multi_cuda(vol, coarse, [start] * 9, [target] * 9,
                                            [excl] * 9, [active] * 9, grid_size=N,
                                            cell_half=CELL_HALF)
    with pytest.raises(ValueError, match="CUDA tensor"):
        render_slab._pixel_operand(start, "start", H, W, (torch.float32,))
    with pytest.raises(ValueError, match="CUDA tensor"):
        render_slab.cell_state_cuda(vol, [excl], [active], grid_size=N)
    with pytest.raises(ValueError, match="1 to 8"):
        render_slab.cell_state_cuda(vol, [excl] * 9, [active] * 9, grid_size=N)
    assert render_slab.shadow_sweep_multi_cuda.launches == 0
    assert render_slab.cell_state_cuda.launches == 0
