"""The multi-query occlusion backend (K5, ``CA3D_OCC_SWEEP=0``): the port's
plain K5 against the JAX package's ``shadow_occlusion_batch`` under the
same variable (its ``_make_shadow_kernel`` in interpret mode) and against
the plain K2, the packed exclusion id, the backend dispatch, and the
Engine with the variable set.

Tolerance: flags equal on every (query, pixel); frames equal bit for bit
(K5's flags are K2's, so the Engine renders the same image).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cellularautomatons3d_tpu.render import render_slab as jrs

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.render import render_slab

from _torch_lighting_scene import (
    LIGHTING, N_RANDOM, H, N, W, jax_frame_queries, scene_cam, scene_words,
)

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's many small torch ops: the suite
    runs several workers, and a thread pool per worker oversubscribes the
    cores (restored after the file)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CELL_HALF = float(np.float32(1.0 / N) * np.float32(0.85) * np.float32(0.5))


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def frame():
    """A full-quality frame's 8 occlusion queries plus random rays, and
    their flags from the JAX package's multi-query kernel (chunks of 4)."""
    f = jax_frame_queries()
    prepped = jrs.prep_slabs(jnp.asarray(f["words"]), [(0, N)], N)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CA3D_OCC_SWEEP", "0")
        occ = jrs.shadow_occlusion_batch(
            jnp.asarray(f["cam"]), [tuple(jnp.asarray(a) for a in qq) for qq in f["queries"]],
            prepped, grid_size=N, width=W, height=H, interpret=True)
    return dict(f, occ=[np.asarray(o) for o in occ])


def _spy(monkeypatch, calls):
    """Record (backend, nq) of every plain occlusion call."""
    for name, tag in (("shadow_sweep", "k2"), ("shadow_sweep_multi", "k5")):
        real = getattr(render_slab, name)

        def spy(vol, start, *a, real=real, tag=tag, **kw):
            calls.append((tag, start.shape[0]))
            return real(vol, start, *a, **kw)

        monkeypatch.setattr(render_slab, name, spy)


def test_k5_plain_matches_jax(frame, monkeypatch):
    """The port's batch under CA3D_OCC_SWEEP=0 runs the plain K5 in chunks
    of 4, as the reference runs its K5, and every flag equals JAX's."""
    monkeypatch.setenv("CA3D_OCC_SWEEP", "0")
    calls = []
    _spy(monkeypatch, calls)
    prepped = render_slab.prep_volume(ct.from_reference(frame["words"]))
    got = render_slab.shadow_occlusion_batch(
        frame["cam"], [tuple(t(a) for a in qq) for qq in frame["queries"]],
        prepped, grid_size=N, width=W, height=H)
    assert calls == [("k5", 4)] * 3
    assert len(got) == 8 + N_RANDOM
    for i, (g, want) in enumerate(zip(got, frame["occ"])):
        np.testing.assert_array_equal(g.numpy(), want, err_msg=f"query {i}")
    occluded = np.stack(frame["occ"])
    assert occluded[:8].sum() > 20 and occluded[8:].sum() > 100


def test_k5_plain_matches_k2_plain(frame):
    """Packed ids with the -1 sentinel skip exactly the cells K2's
    component test skips: the random rays exclude their start cell, a
    random cell, or one with a coordinate of -1 or n."""
    start, target, excl, active = render_slab.stack_occlusion_queries(
        [tuple(t(a) for a in qq) for qq in frame["queries"]], W, H)
    vol = ct.from_reference(frame["words"])
    kw = dict(grid_size=N, cell_half=CELL_HALF)
    k2 = render_slab.shadow_sweep(vol, start, target, excl, active, **kw)
    exid = render_slab.pack_exclusion(excl, N)
    k5 = render_slab.shadow_sweep_multi(vol, start, target, exid, active, **kw)
    assert torch.equal(k5, k2)
    out_of_range = ((excl < 0) | (excl >= N)).any(dim=1)
    assert out_of_range.any() and torch.all(exid[out_of_range] == -1)
    x, y, z = excl.unbind(1)
    assert torch.equal(exid[~out_of_range], (x + y * N + z * N * N)[~out_of_range])


@pytest.mark.parametrize("excl, occupied", [
    ((N, 4, 7), (0, 5, 7)),        # x == n aliases (0, y + 1, z)
    ((-1, 5, 7), (N - 1, 4, 7)),   # x == -1 aliases (n - 1, y - 1, z)
])
def test_k5_out_of_range_exclusion_never_aliases(excl, occupied):
    """A ray straight down -z through an occupied cell whose id a plain
    packing of the out-of-range excluded cell would equal: K2 and K5 both
    see the occluder; without the sentinel K5 would skip it."""
    dense = np.zeros((N, N, N), np.uint8)
    ox, oy, oz = occupied
    dense[oz, oy, ox] = 1  # dense grids are [z, y, x]
    vol = ct.from_reference(ct.pack_grid(dense))
    centre = lambda c: (c + 0.5) / N - 0.5  # noqa: E731
    start = torch.tensor([centre(ox), centre(oy), centre(oz + 2)], dtype=torch.float32)
    target = start + torch.tensor([1e-4, 0.0, -0.6])
    ops = (start.reshape(1, 3, 1, 1), target.reshape(1, 3, 1, 1),
           torch.tensor(excl, dtype=torch.int32).reshape(1, 3, 1, 1),
           torch.ones((1, 1, 1), dtype=torch.bool))
    kw = dict(grid_size=N, cell_half=CELL_HALF)
    k2 = render_slab.shadow_sweep(vol, *ops, **kw)
    exid = render_slab.pack_exclusion(ops[2], N)
    assert int(exid) == -1
    k5 = render_slab.shadow_sweep_multi(vol, ops[0], ops[1], exid, ops[3], **kw)
    assert int(k2) == int(k5) == 1
    naive = (excl[0] + excl[1] * N + excl[2] * N * N) * torch.ones_like(exid)
    assert int(naive) == ox + oy * N + oz * N * N
    assert int(render_slab.shadow_sweep_multi(vol, ops[0], ops[1], naive, ops[3], **kw)) == 0


@pytest.mark.parametrize("env, nq, want", [
    ({}, 8, [("k2", 8)]),
    ({"CA3D_OCC_SWEEP": "0"}, 8, [("k5", 4), ("k5", 4)]),
    ({"CA3D_OCC_SWEEP": "0"}, 9, [("k5", 4), ("k5", 4), ("k2", 1)]),
    ({"CA3D_OCC_SWEEP": "0"}, 1, [("k2", 1)]),
    ({"CA3D_OCC_SWEEP": "0", "CA3D_OCC_NQ1_SWEEP": "0"}, 9,
     [("k5", 4), ("k5", 4), ("k5", 1)]),
    ({"CA3D_OCC_SWEEP": "0", "CA3D_OCC_NQ": "8"}, 8, [("k5", 8)]),
    ({"CA3D_OCC_SWEEP": "0", "CA3D_OCC_NQ": "3"}, 8, [("k5", 3), ("k5", 3), ("k5", 2)]),
    ({"CA3D_OCC_NQ1_SWEEP": "0"}, 1, [("k2", 1)]),
], ids=["default", "sweep0", "sweep0-remainder1", "sweep0-nq1", "nq1sweep0",
        "nq8", "nq3", "default-nq1sweep0"])
def test_dispatch_follows_reference(monkeypatch, env, nq, want):
    """Which backend each chunk reaches, read per call from the variables
    with the reference's defaults; the flags are the same either way and
    come back in query order."""
    rng = np.random.default_rng(nq)
    queries = []
    for _ in range(nq):
        start = rng.uniform(-0.6, 0.6, (H, W, 3)).astype(np.float32)
        target = rng.uniform(-1.0, 1.0, (H, W, 3)).astype(np.float32)
        excl = np.floor((start + 0.5) * N).astype(np.int32)
        queries.append((t(start), t(target), t(excl), t(rng.random((H, W)) < 0.8)))
    prepped = render_slab.prep_volume(ct.from_reference(scene_words()))
    kw = dict(grid_size=N, width=W, height=H)
    base = render_slab.shadow_occlusion_batch(scene_cam(), queries, prepped, **kw)
    for k in ("CA3D_OCC_SWEEP", "CA3D_OCC_NQ1_SWEEP", "CA3D_OCC_NQ"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    _spy(monkeypatch, calls)
    got = render_slab.shadow_occlusion_batch(scene_cam(), queries, prepped, **kw)
    assert calls == want
    assert len(got) == nq and all(torch.equal(a, b) for a, b in zip(got, base))
    assert sum(int(a.sum()) for a in got) > 0


def test_k5_wrapper_does_not_fall_back(monkeypatch):
    """The K5 wrapper refuses CPU tensors and more than 8 queries; a
    non-CPU batch under CA3D_OCC_SWEEP=0 takes the kernel path, which
    raises here rather than running the plain version."""
    vol = ct.from_reference(scene_words())
    prepped = render_slab.prep_volume(vol)
    z3 = torch.zeros((2, 3, H, W))
    ops = (z3, z3, torch.zeros((2, H, W), dtype=torch.int32),
           torch.ones((2, H, W), dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA tensor"):
        render_slab.shadow_sweep_multi_cuda(vol, prepped.coarse, *ops, grid_size=N,
                                            cell_half=CELL_HALF)
    z9 = torch.zeros((9, 3, H, W))
    with pytest.raises(ValueError, match="1 to 8"):
        render_slab.shadow_sweep_multi_cuda(
            vol, prepped.coarse, z9, z9, torch.zeros((9, H, W), dtype=torch.int32),
            torch.ones((9, H, W), dtype=torch.bool), grid_size=N, cell_half=CELL_HALF)
    monkeypatch.setenv("CA3D_OCC_SWEEP", "0")
    meta = render_slab.Prepped(vol.to("meta"), prepped.coarse.to("meta"))
    q = (torch.zeros((H, W, 3)), torch.ones((H, W, 3)),
         torch.zeros((H, W, 3), dtype=torch.int32), torch.ones((H, W), dtype=torch.bool))
    with pytest.raises((ValueError, RuntimeError)):
        render_slab.shadow_occlusion_batch(
            scene_cam(), [tuple(a.to("meta") for a in q)] * 2, meta,
            grid_size=N, width=W, height=H)
    assert render_slab.shadow_sweep_multi_cuda.launches == 0


@pytest.mark.parametrize("lighting", [dict(), dict(indirect_bounces=2), dict(gi_temporal=True)],
                         ids=["full_quality", "two_bounces", "gi_temporal"])
def test_engine_with_k5_equals_default(monkeypatch, lighting):
    """The Engine on the CPU with CA3D_OCC_SWEEP=0 goes through the plain
    K5 and renders the default Engine's frames bit for bit."""
    def frames():
        eng = ct.Engine(grid_size=N, width=W, height=H, device="cpu",
                        light_radius=0.08, **{**LIGHTING, **lighting})
        eng.set_state_dense(ct.unpack_grid(scene_words()))
        return [eng.render(), eng.render(), eng.run_fused(2)]

    want = frames()
    monkeypatch.setenv("CA3D_OCC_SWEEP", "0")
    calls = []
    _spy(monkeypatch, calls)
    got = frames()
    assert calls and all(tag == "k5" for tag, _ in calls)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert float(want[0].max()) > 0.0
