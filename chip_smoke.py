#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Builds the hand-written kernels from ``cellularautomatons3d_tpu_torch/csrc``
(nvcc, ``sm_90a``) and runs, each phase fatal on failure:

  (a) CA step kernel vs its plain torch version, bit-exact, at 256³ for
      20 generations: every neighbourhood × boundary mode on a random 5³
      block and on a random volume (whose cells reach the boundary), the
      default rule on the centre seed, a mixed-group rule; the population
      after one step from the centre seed is 7; and the step kernel's tile
      edges, 32³ and 96³, Moore and von Neumann, every boundary mode, binary
      and 10 states, against the plain step and the dense oracle.
  (b) K1 (render kernel) vs its plain torch version in both modes at
      64³ / 128×64 and 256³ / 1920×1080 on the scene after 80 steps: ids
      equal, depth within atol 3e-5, rgb within rtol 3e-3 / atol 3e-4;
      K1 with ``no_sweep`` against K1 on an empty volume (bit for bit) and
      the plain K1 on it; then the whole Engine on the card vs on the CPU
      at 64³.
  (c) the main path at real size: Engine(grid_size=256, 1920×1080,
      device="cuda"): step(80), render() twice, run_fused(150,
      reset_every=10), with both kernels' launch counters read around it.
  (d) timings with CUDA events (kernel vs plain, CA step, step + composed
      frame; K2 and K3 vs plain, the lighting passes, and step + frame of
      the three lighting configurations; K4 and K2's hard-shadow query vs
      plain and step + frame at 512³ and 1024³; K5 against K2 on a
      full-quality frame's 8 queries at 256³ and 512³, K6, K1 with and
      without the prepass mask on gen-80 and gen-230, K1's split (no sweep,
      primary sweep only, full) on both scenes, and full-quality step
      + frame with K5 against K2, each pair alternated; the multi-state step
      at 256³ / 512³ / 1024³ beside its plain version and beside the binary
      kernel on the same rule, K1 compose and K4 with and
      without ages on the same visibility plane, and step + frame of the
      multi-state paths; the box kernel at 256³, 512³ and 1024³; the floors
      of K2 and K5, every lane inactive, and of K4, an empty volume; K2, K5
      and K4 where the box is the whole volume, gen-230 at 256³ and gen-260
      at 512³),
      beside the card's name and power limit, and each kernel's bound from
      this run's inputs.  It runs last, after (e) to (i).
  (e) the extended-lighting path: K2 (occlusion sweep) and K3 (cell
      state) vs their plain versions, equal on every (query, pixel), on
      the 8 occlusion queries (4 soft-shadow samples, 4 GI slots) and 4
      GI lookups of a full-quality frame at 64³ / 128×64 and 256³ /
      1920×1080 on the scene after 80 steps; the Engine on the card vs on
      the CPU at 64³ for full quality, gi_temporal and two-bounce GI; then
      each of the three at real size, Engine(256, 1920×1080, soft shadows
      ×4, GI, light_radius 0.08): step(80), render(), run_fused(50,
      reset_every=10), with every kernel's launch counter read around it.
  (f) the >256³ path (render_slab.raytrace_sliced): K4 (primary-hit
      sweep) vs its plain version, ids equal and depth within atol 3e-5,
      at 320³ / 480×270 on a sparse random volume (two coarse x-groups,
      the last one partial) from three views, 512³ / 1920×1080 on the
      gen-160 scene and 1024³ / 1920×1080 on the gen-200 scene (the
      centre seed under the default rule); K2 vs plain on those frames'
      hard-shadow query and on a full-quality frame's 8 queries at 512³,
      K3 on its 4 GI lookups and at 320³ on random lookups (coordinates at
      -1, n and 2n + 3 among them, int32 and int64, a window of 481×270
      pixels), and the CA step at 512³ (gen-160) and 1024³
      (gen-200) and on random words at both, over 5 generations, all
      equal; the Engine on the card vs on the CPU at 320³ / 64×32 for
      hard shadows and gi_temporal; then Engine(512, 1920×1080): step(160),
      render(), run_fused(20, reset_every=10), Engine(1024, 1920×1080):
      step(200), render(), run_fused(5), and Engine(512) with soft shadows
      ×4, GI, light_radius 0.08 and gi_temporal, with every kernel's launch
      counter read around each.
  (g) the opt-in paths: K5 (multi-query occlusion, CA3D_OCC_SWEEP=0), on
      each query's own tensors, vs its plain version and vs K2 on them
      stacked, bit for bit, and all 0 with every lane inactive, on a
      full-quality frame's 8 queries (chunks of 4 and one launch of 8) at
      64³ / 128×64, 256³ (gen-80 and, in (d), gen-230), 512³ and 1024³ /
      1920×1080 and on random rays at 64³ and 512³ (broadcast targets,
      int64 cells, excluded cells at -1, n and 2n + 3), K3 on the same
      frames' 4 GI lookups; K6 (the patch
      prepass, 4 lanes per patch, on the undilated mip) vs its plain version
      on the twice-dilated mip, bit for bit, K1 computing its own masks
      (``prepass=True``) vs K1 given the plain masks and vs K1 without
      masks, bit for bit, and K1 with K6's mask vs K1 without it (ids
      equal, depth and rgb within the contract), both modes, at 256³ /
      1080p on the gen-80 and the dense gen-230 scene from three views; the
      prepass frame against the frame without the prepass, bit for bit, on
      both scenes at 1080p and at 64³ / 128×64 (where the mask gate is
      forced open and K1 skips its prologue), both modes; 20 composed frames
      through raytrace_tiles(use_prepass=True) with K6's and K1's launch
      counters (one K1 launch with its prologue a frame, no K6 launch) and
      the kernels of 5 such frames from a torch.profiler trace (one a
      frame); the Engine with CA3D_OCC_SWEEP=0 on the card
      vs on the CPU at 64³ (full quality, two bounces), then Engine(256,
      1080p) full quality and two bounces and Engine(512) gi_temporal with
      it, K5 launched and K2 not, one box launch per K5 and K4 launch.

  (h) the multi-state (Generations) path, on the `pyroclastic` preset (Moore
      B6-8/S4-7, 10 states = 4 age planes) grown from the random 5³ seed: the
      multi-state step kernel vs its plain version and vs the dense oracle ``ops.ca_reference.step_dense``, bit-exact, at 256³
      for 20 generations over 3, 5, 8 and 10 states × every neighbourhood ×
      boundary mode on random volumes of valid ages, and at 512³ and 1024³
      for 5 generations; the alive / visibility pass vs plain on random
      words and on every scene (64³ to 1024³); K1 with ages
      vs its plain version in both modes at 64³ / 128×64 and 256³ /
      1920×1080, K4 with ages (ids and ages equal) at 320³ / 480×270, 512³
      and 1024³ / 1920×1080, K2 and K3 vs plain on a full-quality frame's
      queries of the multi-state scene; the Engine on the card vs on the CPU
      at 64³ (hard shadows, full quality, gi_temporal) and 320³; then the
      path at full width, Engine(256, 1920×1080, total_states=10): step(160),
      render() twice, run_fused(150, reset_every=10), the same with full
      quality and gi_temporal lighting (50 frames), Engine(512) (gen-320, 20
      frames) and Engine(1024) (gen-560, 5 frames), with every kernel's
      launch counter read around each (one multi-state step per generation,
      the binary step never), and on each scene a population above zero,
      every age 1..9 among the hit pixels and a hit share of 2 to 25 %.
  (i) the occupied box (``csrc/occupied_box.cu``, launched inside K2's and
      K4's entry points, which clip their sweeps to it): the box kernel vs
      its plain twin on every scene of this run and on box-edge volumes at
      256³, 512³ and 1024³ (an empty volume, a region at a corner touching
      three faces, a slab on a face, a region at the centre off the block
      grid, the whole volume), and on those volumes K4 vs plain from three
      views at 480×270 (ids equal, t within 3e-5), K2 and K5 vs plain on
      random rays, half of them aimed through the region (flags equal, with
      every lane inactive all 0), and K3 vs plain on random lookups.
  (j) the interactive path (the viewer's loop: a camera move, then
      ``Engine.tick``): Engine(256, 1920×1080): step(80), render(), 10 ticks
      each after a translate, a rotate and a mouse look, K1's launch
      counters read around them (one non-compose launch a frame, no compose
      launch); the same at 512³ (gen-160, K4 + K2, 5 ticks) and at 256³ with
      gi_temporal lighting (K1 + K2 + K3, camera off the GI 0/0 diagonal as
      in (h)); for every moved frame ``reproject_history`` on the card
      against the CPU on the same inputs (source pixel and valid mask equal
      on 1 − 1e-4 of the pixels, rgb within the contract there, some
      history kept); the Engine on the card vs the CPU over 10 moved ticks
      at 64³ / 128×64; a checkpoint of the 256³ and 512³ engines saved,
      loaded on the card (state, history, camera and counters equal, the
      next moved frame bit for bit) and on the CPU, with save / load wall
      ms; the viewer over the 256³ engine: 10 ``frame_png()`` with key and
      mouse inputs between them, each PNG decoding to ``to_uint8`` of its
      frame, one GET /frame and one POST /input on 127.0.0.1, the native
      PNG codec's state.  (d) then times render() with a static camera
      against a moved one (alternated) at 256³ and 512³, reproject_history
      alone, and the kernels and device ms a moved frame adds (torch.profiler).

  (k) the exact reference pipeline (``Engine(pipeline="reference")``, plain
      torch frames; the CA step's kernels): the Engine on the card against the
      CPU at 64³ / 256×128 over 4 ticks with a camera move (clustered, simple,
      soft shadows ×4 with GI, ``pyroclastic``, and amoeba-445 simple from the
      seeded random ages BASELINE config 1 loads, so its multi-state step on
      [3, 2, 64, 64] planes is held to the CPU's; states equal, frames within
      the reference tests' comparison); then at 1920×1080, every kernel's
      counter set to 0 before each and read after (one CA step a generation,
      no frame kernel): 256³ gen-80 with static and moved ticks, the simple
      variant, ``pyroclastic`` gen-160, soft shadows ×4 with GI and with two
      bounces, 1024³ gen-200, and BASELINE config 1 (amoeba-445, 64³,
      640×480, simple; a seeded random grid of ages when the preset dies out
      from the seed); for each the frame time (median of CUDA events around
      single ``render()`` calls), the kernels and device ms of one frame
      (torch.profiler) and its peak memory.

  (l) the mesh (``Engine(mesh_devices=4)``, ``parallel.sharded``), its 4
      shards on one card through ``mesh_device_list=[cuda:0] * 4`` (and, on
      a host with more cards, also on distinct cards): the slab mode of the
      step kernel against its plain twin on the card, bit for bit, on the
      halos the exchange gives (Moore and von Neumann x 3 boundary modes at
      512³ as 4 z shards and as (2, 2), 1024³ as 4; ``pyroclastic`` at
      512³); the sharded step against the single-device step over 20
      generations at 512³ (4 and (2, 2) shards, every boundary mode); then,
      every counter set to 0 before each and read after, mesh Engines at
      1920×1080: 512³ (gen-160, K4 + K2 per shard, 2 render() and
      run_fused(10)), 256³ (gen-80, K1 per shard) and ``pyroclastic`` 512³
      (gen-320, the multi-state slab step), with exact slab and frame launch
      counts, each against the single-device Engine on the same calls (state
      and hit ids equal, rgb within rtol 3e-3 / atol 3e-4); on each band
      with row0 > 0 that those frames render, K1 (256³) or K4 and the
      hard-shadow K2 (512³, with ages for ``pyroclastic``) against its
      plain twin on the band's camera, at the tolerances of (a), (f) and
      (h); the port's ``dryrun_multichip(4, devices=[cuda:0] * 4)``; and
      the times (CUDA events, ``utils.metrics.cuda_time_fn``, alternated
      with the single-device ones: the sharded step and the single-device
      step at 512³ and 1024³, the halo exchange alone, the slab kernel alone
      with its bound, the multi-state slab step, mesh render() and
      run_fused frames at 512³ and 256³).  On one card these
      are the cost of the decomposition, not a scaling.
  (m) K1's descents (run right after (c)): the plane mip's kernel
      (``csrc/plane_occupancy.cu``) against ``plane_occupancy``, bit for bit,
      on random volumes at 32³ to 1024³; on the gen-80, gen-230 and
      ``pyroclastic`` gen-160 scenes of ``Engine(256)`` at 1920×1080, K1 in
      both modes with mip1, slicegate, each with the prepass, and the column
      skip off, bit for bit against the default kernel and within the
      contract of the plain twin; ``Engine.run_fused(10, reset_every=10)``
      under ``CA3D_MIP1=1`` and ``CA3D_SLICEGATE=1`` equal to the default
      Engine's, every counter set to 0 before each and read after (10 launches
      of the mode, and of the plane mip under mip1); the attribution run
      without the column skip; then each mode alternated with the default and
      the plane mip with its twin, by CUDA events and by the device's time.
  (n) the attribution tools (``cellularautomatons3d_tpu_torch.tools``, run
      after (i)): K4 and K2 without the coarse column skip
      (``column_skip=False``) bit for bit against the default kernels and
      within the contract of their plain twins (ids equal, depth within
      3e-5, flags equal) on the 512³ gen-160 and 1024³ gen-200 frames of (f)
      and the box-edge volumes of (i) (checked inside (i)); their
      attribution run (10 launches each at 512³, every counter set to 0
      before it) and their times alternated with the defaults'; then each
      tool's short form (``profile_trace`` in the headline, ``multistate
      --grid 1024`` and ``moved`` modes, 3-5 frames; ``trace_summary`` on the
      headline trace; ``profile_gi``, ``profile_frame``, ``bench_dense``,
      ``bench_scale``, ``bench_512_ablate``) in one child process of this
      script (``--tools``: a torch.profiler trace in this process would make
      the later phases' traces drop kernel events), each line's keys finite
      and positive, and the trace summary's launches per frame equal to the
      launch counters read around the traced frames (headline: one K1
      compose launch and one CA step a frame; multi-state: one step and two
      age-mask launches a generation and frame).

The last two lines of standard output are the card (``nvidia-smi
--query-gpu=name,power.limit``) and ``{"ok": true, "device": {...}}``; the
line before them is the kernels' JSON summary.  Exits non-zero, printing no
result, without a CUDA device or outside a checkout of the repository.
Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.modules["jax"] = None  # the port must not import JAX (ImportError if it tries)

GRID, WIDTH, HEIGHT = 256, 1920, 1080   # the main path's full size
LIGHTING = dict(soft_shadow_samples=4, indirect_lighting=True, light_radius=0.08)
LIGHTING_VARIANTS = {
    "full_quality": {},
    "gi_temporal": dict(gi_temporal=True),
    "two_bounces": dict(indirect_bounces=2),
}
ID_MISMATCH_LIMIT = 1e-4   # fraction of pixels; see CHANGES.md
DEPTH_ATOL = 3e-5
RGB_RTOL, RGB_ATOL = 3e-3, 3e-4


class SmokeFailure(Exception):
    pass


@contextlib.contextmanager
def env_var(name, value):
    """Set an environment variable for a block, then restore it."""
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def need(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    need(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def timed(torch, fn):
    """(fn(), its device ms): one call between CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def device_queries(torch, queries):
    """Query tuples of numpy arrays (tests/_torch_query_scene.py) as CUDA
    tensors."""
    return [tuple(torch.from_numpy(a).to("cuda") for a in q) for q in queries]


def k5_check(torch, rs, tag, vol, coarse, n, queries, cell_half):
    """K5 on ``queries`` (each query's own tensors, as the lighting passes
    leave them) in launches of 4, as the CA3D_OCC_SWEEP=0 dispatch runs
    them, and in one launch, against the plain K5 and K2 on them stacked:
    every (query, pixel) equal, and with every lane inactive all 0.
    Returns (the plain flags, the plain K5's ms)."""
    h, w = queries[0][3].shape
    start, target, excl, active = rs.stack_occlusion_queries(queries, w, h)
    kw = dict(grid_size=n, cell_half=cell_half)
    got = torch.cat([rs.shadow_sweep_multi_cuda(vol, coarse, *zip(*queries[i:i + 4]), **kw)
                     for i in range(0, len(queries), 4)])
    one = rs.shadow_sweep_multi_cuda(vol, coarse, *zip(*queries), **kw)
    k2 = rs.shadow_sweep_cuda(vol, coarse, start, target, excl, active, **kw)
    want, ms = timed(torch, lambda: rs.shadow_sweep_multi(
        vol, start, target, rs.pack_exclusion(excl, n), active, **kw))
    idle = rs.shadow_sweep_multi_cuda(
        vol, coarse, *zip(*[(s, t, e, torch.zeros_like(a)) for s, t, e, a in queries]), **kw)
    bad = int((got != want).sum()) + int((one != want).sum())
    bad_k2 = int((got != k2).sum())
    log(f"  K5 {tag}: {len(queries)} queries, {int(active.sum())} active, {int(want.sum())} "
        f"occluded, {bad} differ from plain, {bad_k2} from K2, plain {ms:.1f} ms")
    need(bad == 0, f"K5 {tag}: {bad} flags differ from the plain version")
    need(bad_k2 == 0, f"K5 {tag}: {bad_k2} flags differ from K2")
    need(int(idle.abs().sum()) == 0, f"K5 {tag}: an inactive lane is not 0")
    return want, ms


def k3_check(torch, rs, tag, vol, n, lookups):
    """K3 on ``lookups`` (each lookup's own coordinates and mask) against
    the plain K3 on them stacked, every (query, pixel) equal, and with
    every lane inactive all 0.  Returns the plain states."""
    h, w = lookups[0][1].shape
    coords, active = rs.stack_cell_queries(lookups, w, h)
    got = rs.cell_state_cuda(vol, *zip(*lookups), grid_size=n)
    want = rs.cell_state(vol, coords, active, grid_size=n)
    idle = rs.cell_state_cuda(vol, [c for c, _ in lookups],
                              [torch.zeros_like(a) for _, a in lookups], grid_size=n)
    bad = int((got != want).sum())
    log(f"  K3 {tag}: {len(lookups)} lookups, {int(active.sum())} active, "
        f"{int(want.sum())} live, {bad} differ")
    need(bad == 0, f"K3 {tag}: {bad} states differ from the plain version")
    need(int(idle.sum()) == 0, f"K3 {tag}: an inactive lane is not 0")
    return want


SLICED_SMALL = dict(grid_size=320, width=64, height=32)
SLICED_ENGINES = {
    # name: (Engine overrides, warm-up steps, run_fused kwargs, timed frames)
    "sliced_512": (dict(grid_size=512), 160, dict(frames=20, reset_every=10), 10),
    "sliced_1024": (dict(grid_size=1024), 200, dict(frames=5), 5),
    "sliced_512_gi_temporal": (dict(grid_size=512, **LIGHTING, gi_temporal=True), 160,
                               dict(frames=20, reset_every=10), 10),
}


def sliced_phase(torch, np, ct, rf, rs, ca_step, AutomatonSpec, coarse_occupancy,
                 to_dev, grown, scene_cam, views, lighting_operands) -> dict:
    """Phase (f): K4, K2, K3 and the CA step against their plain versions
    above 256³, the Engine on the card against the Engine on the CPU at
    320³, and the Engine at 512³ and 1024³ / 1080p with its launch
    counters.  Returns what (d) times and reports."""
    dev = torch.device("cuda", 0)
    k4_err = 0.0
    plain_ms = {}

    def k4_check(tag, vol, coarse, cam, size, w, h):
        nonlocal k4_err
        kw = dict(grid_size=size, width=w, height=h)
        t_k, i_k = rs.primary_sweep_cuda(vol, coarse, cam, **kw)
        (t_p, i_p), ms = timed(torch, lambda: rs.primary_sweep(vol, cam, **kw))
        bad = int((i_k != i_p).sum())
        err = float((t_k - t_p).abs().max())
        hits = int((i_p >= 0).sum())
        log(f"  K4 {tag}: {hits} hits, {bad} ids differ, max |t| err {err:.3g}, "
            f"plain {ms:.1f} ms")
        need(bad == 0, f"K4 {tag}: {bad} ids differ from the plain version")
        need(err <= DEPTH_ATOL, f"K4 {tag}: t error {err} > {DEPTH_ATOL}")
        need(hits > 0, f"K4 {tag}: no pixel hits")
        k4_err = max(k4_err, err)
        return t_k, i_k, ms

    def k2_check(tag, vol, coarse, cam, size, ops):
        kw = dict(grid_size=size, cell_half=rs._cell_half(cam, size))
        got = rs.shadow_sweep_cuda(vol, coarse, *ops, **kw)
        want, ms = timed(torch, lambda: rs.shadow_sweep(vol, *ops, **kw))
        bad = int((got != want).sum())
        log(f"  K2 {tag}: {ops[0].shape[0]} queries, {int(ops[3].sum())} active, "
            f"{int(want.sum())} occluded, {bad} differ, plain {ms:.1f} ms")
        need(bad == 0, f"K2 {tag}: {bad} flags differ from the plain version")
        need(int(want.sum()) > 0, f"K2 {tag}: nothing is occluded")
        return ms

    # K4 at 320³ (XG = 2, the last coarse group partial) on a sparse random
    # volume, from three views.
    vol = to_dev(ct.pack_grid(
        (np.random.default_rng(5).random((320,) * 3) < 0.01).astype(np.uint8)))
    coarse = coarse_occupancy(vol)
    for name, view in views.items():
        k4_check(f"320^3 480x270 random {name}", vol, coarse, scene_cam(view, 480, 270),
                 320, 480, 270)
    # K3 at 320³ with coordinates in [-3, 2n + 5], a quarter exactly -1, n or
    # 2n + 3, int32 and int64, on a window whose pixel count is not a
    # multiple of 8.
    from _torch_query_scene import cell_queries

    want3 = k3_check(torch, rs, "320^3 481x270 random lookups", vol, 320,
                     device_queries(torch, cell_queries(320, 4, 270, 481, seed=320)))
    need(int(want3.sum()) > 0, "K3 320^3: no live cell found")

    # K4 and the hard-shadow K2 query at 512³ and 1024³ / 1080p.
    timed_ops = {}
    for size, steps in ((512, 160), (1024, 200)):
        vol = grown(size, steps)
        coarse = coarse_occupancy(vol)
        cam = scene_cam(views["front"], WIDTH, HEIGHT)
        tag = f"{size}^3 {WIDTH}x{HEIGHT} gen-{steps}"
        t_k, i_k, plain_ms[f"k4_{size}_plain_ms"] = k4_check(
            tag, vol, coarse, cam, size, WIDTH, HEIGHT)
        kw = dict(grid_size=size, width=WIDTH, height=HEIGHT)
        q, origin, coords, found, _ = rs.hit_geometry(cam, i_k, t_k, **kw)
        queries, _, _ = rs.lighting_queries(cam, q, origin, coords, found, soft_k=1, **kw)
        k2 = rs.stack_occlusion_queries(queries, WIDTH, HEIGHT)
        plain_ms[f"k2_hard_{size}_plain_ms"] = k2_check(
            f"{tag} hard shadow", vol, coarse, cam, size, k2)
        timed_ops[size] = (vol, coarse, cam, k2)
        del q, origin, coords, found, queries

    # K2 and K3 on a full-quality frame at 512³, the CA step at 512³.
    vol, coarse, cam, _, k2, _, _, lookups = lighting_operands(512, WIDTH, HEIGHT, steps=160)
    k2_check("512^3 full quality", vol, coarse, cam, 512, k2)
    want3 = k3_check(torch, rs, "512^3 full quality", vol, 512, lookups)
    need(int(want3.sum()) > 0, "K3 512^3: no live neighbour found")
    del k2, lookups, want3
    # The CA step at both sizes the Engines below run it at: the grown
    # scenes, and random words whose cells reach the boundary.
    g = torch.Generator(dev).manual_seed(11)
    ca_volumes = [(512, "gen-160", vol), (1024, "gen-200", timed_ops[1024][0])]
    ca_volumes += [(size, "random words", torch.randint(
        -2**31, 2**31 - 1, (size // 32, size, size), dtype=torch.int32, device=dev,
        generator=g)) for size in (512, 1024)]
    for size, tag, a in ca_volumes:
        spec = AutomatonSpec.from_rule_strings(size)
        b = a.clone()
        for gen in range(5):
            a = ca_step.fires_plane_cuda(a, spec)
            b = ca_step.fires_plane(b, spec)
            need(torch.equal(a, b), f"CA kernel != plain at {size}^3: {tag} generation {gen + 1}")
        log(f"  CA kernel == plain at {size}^3 on {tag}: 5 generations")
    del ca_volumes, a, b

    # The Engine on the card against the Engine on the CPU at 320³.
    for name, variant in (("hard", {}), ("gi_temporal", dict(**LIGHTING, gi_temporal=True))):
        rs.primary_sweep_cuda.launches = 0
        out = []
        for d in ("cuda", "cpu"):
            e = ct.Engine(device=d, **SLICED_SMALL, **variant)
            e.step(100)
            fr = [e.render() for _ in range(2)] + [e.run_fused(2, reset_every=1)]
            out.append(([f.cpu() for f in fr], e.history.hit_idx.cpu()))
        (gpu, gidx), (cpu, cidx) = out
        need(rs.primary_sweep_cuda.launches > 0, f"Engine 320^3 {name} did not launch K4")
        need(torch.equal(gidx, cidx), f"Engine 320^3 {name}: ids cuda != cpu")
        need(int((cidx >= 0).sum()) > 0, f"Engine 320^3 {name}: no pixel hits")
        for a, b in zip(gpu, cpu):
            need(bool(torch.all((a - b).abs() <= RGB_ATOL + RGB_RTOL * b.abs())),
                 f"Engine 320^3 {name}: frame cuda vs cpu max err "
                 f"{float((a - b).abs().max())}")
        log(f"  Engine 320^3 {name} cuda == cpu ({len(gpu)} frames, "
            f"{int((cidx >= 0).sum())} hit pixels)")

    # The Engine at full size.
    counted = (ca_step.fires_plane_cuda, rf.raytrace_cuda, rs.primary_sweep_cuda,
               rs.shadow_sweep_cuda, rs.cell_state_cuda, rs.occupied_box_cuda)
    launches, engines = {}, {}
    for name, (cfg, steps, fused, frames) in SLICED_ENGINES.items():
        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        eng = ct.Engine(width=WIDTH, height=HEIGHT, device="cuda", **cfg)
        eng.step(steps)
        fr = [eng.render(), eng.run_fused(**fused)]
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in counted}
        for i, f in enumerate(fr):
            need(tuple(f.shape) == (HEIGHT, WIDTH, 3), f"{name} frame {i} shape {tuple(f.shape)}")
            need(bool(torch.isfinite(f).all()), f"{name} frame {i} has non-finite values")
            need(float(f.max()) > 0.0, f"{name} frame {i} is black")
        needed = ["fires_plane_cuda", "primary_sweep_cuda", "shadow_sweep_cuda",
                  "occupied_box_cuda"]
        if cfg.get("indirect_lighting"):
            needed.append("cell_state_cuda")
        need(all(counts[k] > 0 for k in needed), f"{name} missed a kernel: {counts}")
        need(counts["raytrace_cuda"] == 0, f"{name} launched K1: {counts}")
        need(counts["occupied_box_cuda"] == counts["primary_sweep_cuda"]
             + counts["shadow_sweep_cuda"], f"{name}: one box launch per K2 / K4 launch: {counts}")
        hits = float((eng.history.hit_idx >= 0).float().mean())
        log(f"(f) {name}: step({steps}), render(), run_fused({fused}) in "
            f"{time.perf_counter() - t0:.2f} s; launches {counts}; hit fraction {hits:.3f}")
        launches[name] = counts
        engines[name] = (eng, frames)
    return dict(k4_max_abs_err=k4_err, plain_ms=plain_ms, launches=launches,
                engines=engines, timed=timed_ops)


# ---------------------------------------------- (i) the occupied box ---
BOX_SIZES = (256, 512, 1024)
BOX_WINDOW = (480, 270)


def box_phase(torch, np, rs, occupancy, scene_cam, views, to_dev, scenes, noskip) -> dict:
    """Phase (i): the box kernel against its plain twin on ``scenes`` ({tag:
    (vol, coarse, n)}) and on the box-edge volumes, and K4, K2, K5 and K3
    against their plain versions on the box-edge volumes; for phase (n), K4
    and K2 without the column skip on the same volumes, bit for bit against
    the default kernels and within the contract of the plain twins (counted
    in ``noskip``).  Returns the boxes."""
    from _torch_box_scene import BOX_CASES, box_edge_volume
    from _torch_query_scene import cell_queries, occlusion_queries

    dev = torch.device("cuda", 0)
    boxes = {}

    def box_check(tag, coarse, n):
        got = occupancy.occupied_box_cuda(coarse, n)
        want = occupancy.occupied_box(coarse, n)
        need(torch.equal(got, want), f"box kernel != plain on {tag}: {got.tolist()} "
             f"!= {want.tolist()}")
        b = got.tolist()
        ext = np.array(b[4:], np.int32).view(np.float32).tolist()
        boxes[tag] = dict(empty=b[0], full=b[1], zc=b[2:4], x=ext[:2], y=ext[2:])
        return b

    for tag, (vol, coarse, n) in scenes.items():
        box_check(tag, coarse, n)
        log(f"  box of {tag}: {boxes[tag]}")
    k4_cmp = k2_cmp = 0
    for n in BOX_SIZES:
        for case in BOX_CASES:
            words, region = box_edge_volume(n, case, n)
            vol = to_dev(words)
            coarse = occupancy.coarse_occupancy(vol)
            tag = f"{n}^3 {case}"
            b = box_check(tag, coarse, n)
            need((b[0], b[1]) == (case == "empty", case == "full"), f"box of {tag}: {b}")
            w, h = BOX_WINDOW
            kw = dict(grid_size=n, width=w, height=h)
            for name, view in views.items():
                cam = scene_cam(view, w, h)
                t_k, i_k = rs.primary_sweep_cuda(vol, coarse, cam, **kw)
                t_p, i_p = rs.primary_sweep(vol, cam, **kw)
                bad = int((i_k != i_p).sum())
                err = float((t_k - t_p).abs().max())
                hits = int((i_p >= 0).sum())
                need(bad == 0 and err <= DEPTH_ATOL,
                     f"K4 {tag} {name}: {bad} ids differ, t error {err}")
                need((hits > 0) == (case != "empty"), f"K4 {tag} {name}: {hits} hits")
                k4_cmp += 1
                t_n, i_n = rs.primary_sweep_cuda(vol, coarse, cam, column_skip=False, **kw)
                need(torch.equal(t_n, t_k) and torch.equal(i_n, i_k),
                     f"(n) K4 without the column skip != the default on {tag} {name}")
                need(torch.equal(i_n, i_p) and float((t_n - t_p).abs().max()) <= DEPTH_ATOL,
                     f"(n) K4 without the column skip != plain on {tag} {name}")
                noskip["k4_box_edge"] = noskip.get("k4_box_edge", 0) + 1
            # K2 on random rays: starts in [-0.7, 0.7]³ (inside and outside
            # the box and the volume), half the rays aimed at the region's
            # centre, the last query's rays half flat (dz == 0).
            g = torch.Generator(dev).manual_seed(n + len(case))
            rnd = lambda *s: torch.rand(*s, device=dev, generator=g)  # noqa: E731
            nq, w, h = 3, 256, 128
            start = rnd(nq, 3, h, w) * 1.4 - 0.7
            target = rnd(nq, 3, h, w) * 2.0 - 1.0
            if region is not None:
                mid = torch.tensor([(a + c) / 2 / n - 0.5 for a, c in zip(*region)],
                                   device=dev)[None, :, None, None]
                target = torch.where(rnd(nq, 1, h, w) < 0.5, mid.expand_as(target), target)
            target[-1, 2] = torch.where(rnd(h, w) < 0.5, start[-1, 2], target[-1, 2])
            target = target.contiguous()
            cell = torch.floor((start + 0.5) * n).to(torch.int32)
            other = (rnd(nq, 3, h, w) * (n + 2) - 1).to(torch.int32)
            excl = torch.where(rnd(nq, 1, h, w) < 0.5, cell, other).contiguous()
            active = rnd(nq, h, w) < 0.7
            kw2 = dict(grid_size=n, cell_half=float(np.float32(1.0 / n) * np.float32(0.85)
                                                    * np.float32(0.5)))
            got = rs.shadow_sweep_cuda(vol, coarse, start, target, excl, active, **kw2)
            want = rs.shadow_sweep(vol, start, target, excl, active, **kw2)
            bad = int((got != want).sum())
            need(bad == 0, f"K2 {tag}: {bad} flags differ from the plain version")
            need((int(want.sum()) > 0) == (case != "empty"), f"K2 {tag}: {int(want.sum())} occluded")
            got_n = rs.shadow_sweep_cuda(vol, coarse, start, target, excl, active,
                                         column_skip=False, **kw2)
            need(torch.equal(got_n, got) and torch.equal(got_n, want),
                 f"(n) K2 without the column skip != the default or plain on {tag}")
            noskip["k2_box_edge"] = noskip.get("k2_box_edge", 0) + 1
            idle = rs.shadow_sweep_cuda(vol, coarse, start, target, excl,
                                        torch.zeros_like(active), **kw2)
            need(int(idle.abs().sum()) == 0, f"K2 {tag}: an inactive lane is not 0")
            k2_cmp += 1
            # K5 on queries as the lighting passes leave them (broadcast
            # targets, int64 cells, excluded cells outside the volume), half
            # the rays aimed through the region; K3 on random lookups.
            queries = device_queries(torch, occlusion_queries(n, 4, h, w, seed=n + len(case),
                                                              region=region))
            want5, _ = k5_check(torch, rs, tag, vol, coarse, n, queries, kw2["cell_half"])
            need((int(want5.sum()) > 0) == (case != "empty"),
                 f"K5 {tag}: {int(want5.sum())} occluded")
            want3 = k3_check(torch, rs, tag, vol, n, device_queries(
                torch, cell_queries(n, 4, h, w, seed=n + len(case))))
            need(case != "empty" or int(want3.sum()) == 0, f"K3 {tag}: a live cell")
            log(f"  box-edge {tag}: box {boxes[tag]}; K4 == plain from {len(views)} views, "
                f"K2 == plain ({int(active.sum())} active, {int(want.sum())} occluded), "
                f"idle K2 all 0")
            del vol, coarse, words
    log(f"(i) box kernel == plain on {len(boxes)} mips; K4 == plain on {k4_cmp} frames and "
        f"K2, K5 and K3 on {k2_cmp} batches of box-edge volumes at {BOX_SIZES}")
    return boxes


# ---------------------------------------------------------------- bounds ---
# The least time the card could take for a kernel's work: the larger of its
# bytes over the H100's memory rate (each input read once, each output
# written once; an input a lane does not need, such as the operands of an
# inactive lane, is not counted) and its operations over the card's
# peak rate (67 TFLOP/s float32 outside the tensor cores; int32 operations
# are counted at that rate too, a lower bound).  Operations are counted from
# the kernels' code, per lane and per 8-plane column that this run's rays
# cross inside the box of occupied 8³ blocks (the box's columns and the
# t-range of its x / y extent: nowhere else can a probe find a cell); plane
# probes are not counted.  The sweeps' bytes count the mip once but not the
# packed volume, of which they read only the words they probe.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
OPS_RAY = 40          # camera or occlusion ray set-up: normalise, slab exits
OPS_COLUMN = 50       # column span, cell range, mip test (sweep.cuh)
OPS_SHADE = 150       # Cook-Torrance shading and composition of a hit
OPS_CA_NEIGHBOUR = 24  # boundary sources, funnel shift, 5-plane carry add
OPS_CA_RULE_VALUE = 6  # rule_hit per member count of born / survive
OPS_CA_DECAY = 12     # decay epilogue per age plane: increment, three selects
OPS_AGE = 20          # age fetch (shift, mask, or per plane) and the fade
OPS_PATCH = 60        # K6 patch ray and box
OPS_PATCH_COLUMN = 40  # K6 column span and 3 probes
OPS_DILATE = 12       # K6's two dilations of the mip, per word


def bound(nbytes, ops):
    b = nbytes / HBM_BYTES_PER_S * 1e3
    o = ops / ALU_OPS_PER_S * 1e3
    return {"bound_ms": max(b, o), "bound_by": "bytes" if b >= o else "operations",
            "bytes": float(nbytes), "ops": float(ops)}


def columns_in_box(torch, o, d, t0, t1, n, active, box):
    """8-plane columns that the rays o + t·d (``o``, ``d``: (x, y, z)
    tensors) cross over [t0, t1] inside the mip's occupied box (``box``: the
    int32 [8] words of ``ops.occupancy.occupied_box``), summed over active
    rays: the t-range clipped to the box's x / y extent and the columns to
    [zc0, zc1], the only columns where a probe can find an occupied cell."""
    b = box.cpu()
    if int(b[0]):
        return 0.0
    ext = b[4:].view(torch.float32).tolist()
    for (lo, hi), oi, di in zip((ext[:2], ext[2:]), o[:2], d[:2]):
        ta, tb = (lo - oi) / di, (hi - oi) / di
        ok = ~(torch.isnan(ta) | torch.isnan(tb))
        t0 = torch.where(ok, torch.maximum(t0, torch.minimum(ta, tb)), t0)
        t1 = torch.where(ok, torch.minimum(t1, torch.maximum(ta, tb)), t1)
    ca = torch.floor((o[2] + t0 * d[2] + 0.5) * (n / 8.0))
    cb = torch.floor((o[2] + t1 * d[2] + 0.5) * (n / 8.0))
    cols = (torch.maximum(ca, cb).clamp(max=int(b[3]))
            - torch.minimum(ca, cb).clamp(min=int(b[2])) + 1.0).clamp(min=0.0)
    ok = active & (t0 <= t1) & torch.isfinite(cols)
    return float(torch.where(ok, cols, 0.0).sum())


def mip_bytes(n):
    return (n // 8) ** 2 * 4 * -(-n // 256)


def occlusion_work(torch, start, target, active, n, bytes_per_lane, box):
    """(bytes, ops) of K2 or K5 on stacked queries: active lanes read their
    operands, every lane its active flag and its output, the mip once; the
    ray set-up of the active lanes and the columns they cross inside the
    box from their start to the volume's exit."""
    d = target - start
    d = d / torch.sqrt((d * d).sum(dim=1, keepdim=True))
    exits = torch.maximum((-0.5 - start) / d, (0.5 - start) / d)
    t1 = exits.amin(dim=1)
    lanes, act = active.numel(), int(active.sum())
    cols = columns_in_box(torch, start.unbind(1), d.unbind(1), torch.zeros_like(t1), t1, n,
                          active, box)
    return act * bytes_per_lane + lanes * 5 + mip_bytes(n), act * OPS_RAY + cols * OPS_COLUMN


def in_place_bytes(queries):
    """Bytes K5 reads for its active lanes from the queries' own tensors:
    the start, a per-pixel target (a shared [3] one once a block, not
    counted), the excluded cell at its element size."""
    return sum(int(a.sum()) * (12 + (12 if t.dim() == 3 else 0) + 3 * e.element_size())
               for _, t, e, a in queries)


def lookup_work(lookups):
    """(bytes, ops) of K3 on its lookups: every lane's flag and state (1 B
    each), the coordinates of the active lanes at their element size and
    the word each gathers, a few operations per active lane."""
    act = [int(a.sum()) for _, a in lookups]
    nbytes = sum(a.numel() * 2 for _, a in lookups) + sum(
        n * (3 * c.element_size() + 4) for (c, _), n in zip(lookups, act))
    return nbytes, sum(act) * 12


def primary_work(torch, rf, cam, n, w, h, t_hit, idx, dev, box):
    """(active rays, columns crossed inside the box to the hit or the exit)
    of K1's or K4's primary sweep."""
    _, dx, dy, dz = rf._pixel_rays(cam, w, h, dev)
    o = [torch.full_like(di, float(cam[rf.P_O + i])) for i, di in enumerate((dx, dy, dz))]
    slabs = [rf._vol_slab(oi, di) for oi, di in zip(o, (dx, dy, dz))]
    tn = torch.maximum(torch.maximum(slabs[0][0], slabs[1][0]), slabs[2][0])
    tf = torch.minimum(torch.minimum(slabs[0][1], slabs[1][1]), slabs[2][1])
    active = (tn <= tf) & (tf >= 0.0)
    t_end = torch.where(idx >= 0, t_hit, tf)
    return int(active.sum()), columns_in_box(torch, o, (dx, dy, dz), tn.clamp(min=0.0), t_end,
                                             n, active, box)


def multi_phase(torch, np, ct, rf, rs, coarse_occupancy, dilate_occupancy, grown,
                scene_cam, views, lighting_operands, compare, to_dev) -> dict:
    """Phase (g): K5 against plain K5 and K2 (and K3 against plain K3 on
    the same frames), K6 against plain K6, K1 with
    the prepass mask against K1 without it, the prepass frame path and the
    Engine with CA3D_OCC_SWEEP=0 with their launch counters.  Returns what
    (d) times and reports."""
    dev = torch.device("cuda", 0)
    out = {"k5_timed": {}, "k1_timed": {}, "k3_bounds": {}}

    # K5 on a full-quality frame's 8 queries (in launches of 4, as the
    # dispatch runs them, and in one launch of 8) and K3 on its 4 lookups,
    # and on random rays.
    from _torch_query_scene import occlusion_queries

    for size, w, h, steps in ((64, 128, 64, 80), (256, WIDTH, HEIGHT, 80),
                              (512, WIDTH, HEIGHT, 160), (1024, WIDTH, HEIGHT, 200)):
        vol, coarse, cam, _, k2, _, queries, lookups = lighting_operands(size, w, h, steps=steps)
        tag = f"{size}^3 {w}x{h} gen-{steps} full quality"
        want, ms = k5_check(torch, rs, tag, vol, coarse, size, queries, rs._cell_half(cam, size))
        need(int(want.sum()) > 0, f"K5 {tag}: nothing is occluded")
        want3 = k3_check(torch, rs, tag, vol, size, lookups)
        need(int(want3.sum()) > 0, f"K3 {tag}: no live neighbour found")
        if w == WIDTH:
            out["k3_bounds"][size] = bound(*lookup_work(lookups))
        if w == WIDTH and size <= 512:
            out["k5_timed"][size] = (vol, coarse, cam, k2, queries, ms)
        del want, want3, lookups
    for size in (64, 512):
        rng = np.random.default_rng(size)
        words = np.zeros((size // 32) * size * size, np.uint32)
        k = int(0.002 * size**3)
        np.bitwise_or.at(words, rng.integers(0, words.size, k),
                         np.uint32(1) << rng.integers(0, 32, k).astype(np.uint32))
        vol = to_dev(words.reshape(size // 32, size, size))
        half = float(np.float32(1.0 / size) * np.float32(0.85) * np.float32(0.5))
        queries = device_queries(torch, occlusion_queries(size, 3, 128, 256, seed=size))
        want, _ = k5_check(torch, rs, f"{size}^3 random rays", vol, coarse_occupancy(vol), size,
                           queries, half)
        need(int(want.sum()) > 0, f"K5 {size}^3 random rays: nothing is occluded")
    g = torch.Generator(dev).manual_seed(17)

    # K6 on the undilated mip against the plain prepass on the twice-dilated
    # mip; K1 computing its own masks against K1 given the plain masks and
    # K1 without masks, bit for bit; K1 with K6's mask against K1 without it
    # within the contract.  At 256³ / 1080p on the main path's gen-80 scene
    # and the dense gen-230 scene (tools/bench_dense.py), from three views.
    def dilated_twice(coarse):
        return dilate_occupancy(dilate_occupancy(coarse, dilate_z=False),
                                dilate_z=False, dilate_y=False)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    mask_frac, exact = 0.0, 0
    rf.prepass_cuda.launches = 0
    for steps in (80, 230):
        vol = grown(GRID, steps)
        coarse = coarse_occupancy(vol)
        for name, view in views.items():
            cam = scene_cam(view, WIDTH, HEIGHT)
            kw = dict(grid_size=GRID, width=WIDTH, height=HEIGHT)
            m_k = rf.prepass_mask(coarse, cam, **kw)
            m_p, k6_plain_ms = timed(torch, lambda: rf.prepass(dilated_twice(coarse), cam, **kw))
            bad = int((m_k != m_p).sum())
            tag = f"{GRID}^3 {WIDTH}x{HEIGHT} gen-{steps} {name}"
            log(f"  K6 {tag}: {m_k.numel()} patches, {int((m_p == -1).sum())} forced, "
                f"{int((m_p == 0).sum())} empty, {bad} differ, plain {k6_plain_ms:.1f} ms")
            need(bad == 0, f"K6 {tag}: {bad} masks differ from the plain version")
            kw = dict(kw, shadow=True)
            hist = None
            for mode in ("non-compose", "compose"):
                got = rf.raytrace_cuda(vol, coarse, cam, hist, colmask=m_k, **kw)
                want = rf.raytrace_cuda(vol, coarse, cam, hist, **kw)
                torch.cuda.synchronize()
                _, f = compare(f"K1 mask vs no mask {tag} {mode}", got, want)
                mask_frac = max(mask_frac, f)
                inline = rf.raytrace_cuda(vol, coarse, cam, hist, prepass=True, **kw)
                given = rf.raytrace_cuda(vol, coarse, cam, hist, colmask=m_p, **kw)
                need(same(inline, given), f"K1 {tag} {mode}: its own masks != the plain masks")
                need(same(inline, want), f"K1 {tag} {mode}: its own masks != no masks")
                exact += 2
                if hist is None:
                    hist = (torch.clamp(want[0] * 1.5 + 0.02, 0.0, 1.0).contiguous(),
                            torch.where(torch.rand(want[2].shape, device=dev, generator=g)
                                        < 0.7, want[2], want[2] + 1).contiguous())
            if name == "front":
                out["k1_timed"][steps] = (vol, coarse, cam, hist, m_k, kw, k6_plain_ms)
    out["k1_mask_id_mismatch"] = mask_frac
    # K6 alone runs only where a caller asks prepass_mask for a frame's
    # masks, as above; the prepass frame below never launches it.
    out["k6_launches"] = rf.prepass_cuda.launches
    need(out["k6_launches"] == 6, f"prepass_mask launched K6 {out['k6_launches']} times, not 6")
    log(f"  K1 with its own masks == K1 given the plain masks == K1 without: {exact} frames")
    # The prepass frame equals the frame without the prepass, exactly: at
    # 1080p (the mask gate on) on both scenes, and at 64³ / 128×64, where
    # the window is too small for the masks, the gate is forced open and K1
    # skips its prologue.
    exact = 0
    for vol, coarse, cam, hist, _, kw, _ in out["k1_timed"].values():
        need(not rf.mask_gate_forced(cam), "the mask gate is forced open at 1080p")
        for h in (None, hist):
            got = rf.raytrace_tiles(vol, coarse, cam, h, use_prepass=True, **kw)
            want = rf.raytrace_tiles(vol, coarse, cam, h, **kw)
            need(same(got, want), "the 1080p prepass frame != the frame without the prepass")
            exact += 1
    vol = grown(64)
    coarse = coarse_occupancy(vol)
    for name, view in views.items():
        cam = scene_cam(view, 128, 64)
        need(rf.mask_gate_forced(cam), "the mask gate is not forced open at 128x64")
        kw = dict(grid_size=64, width=128, height=64, shadow=True)
        want = rf.raytrace_tiles(vol, coarse, cam, **kw)
        hist = (torch.clamp(want[0] * 1.5, 0, 1).contiguous(), want[2].contiguous())
        m_p = rf.prepass(dilated_twice(coarse), cam, grid_size=64, width=128, height=64)
        for h in (None, hist):
            got = rf.raytrace_tiles(vol, coarse, cam, h, use_prepass=True, **kw)
            ref = rf.raytrace_tiles(vol, coarse, cam, h, **kw)
            given = rf.raytrace_cuda(vol, coarse, cam, h, colmask=m_p, **kw)
            need(same(got, ref) and same(got, given),
                 f"the 128x64 prepass frame != the frame without the prepass ({name})")
            exact += 1
    log(f"  prepass frame == frame without the prepass: {exact} frames at 1080p and 128x64")

    # The prepass frame path (tools/bench_dense.py's loop with
    # CA3D_PREPASS=1): composed frames of the gen-230 scene through
    # raytrace_tiles(use_prepass=True), one K1 launch a frame.
    vol, coarse, cam, hist, _, kw, _ = out["k1_timed"][230]
    rf.prepass_cuda.launches = 0
    rf.raytrace_cuda.launches = 0
    rf.raytrace_cuda.prepass_launches = 0
    h = hist
    for _ in range(20):
        pres, _, idx, color = rf.raytrace_tiles(vol, coarse_occupancy(vol), cam, h,
                                                use_prepass=True, **kw)
        h = (color, idx)
    torch.cuda.synchronize()
    counts = {"prepass_cuda": rf.prepass_cuda.launches,
              "raytrace_cuda": rf.raytrace_cuda.launches,
              "raytrace_cuda_prepass": rf.raytrace_cuda.prepass_launches}
    need(counts == {"prepass_cuda": 0, "raytrace_cuda": 20, "raytrace_cuda_prepass": 20},
         f"prepass path: not one K1 launch with its prologue a frame: {counts}")
    need(bool(torch.isfinite(pres).all()) and float(pres.max()) > 0.0,
         "prepass frame is not finite or is black")
    log(f"(g) prepass path: 20 composed frames of gen-230; launches {counts}")
    out["prepass_launches"] = counts
    # The kernels a prepass frame runs, from the card's trace of 5 frames.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            rf.raytrace_tiles(vol, coarse, cam, hist, use_prepass=True, **kw)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    need(len(names) == 5 and all("render_kernel" in k for k in names),
         f"a prepass frame is not one K1 kernel: {len(names)} device events in 5 frames, "
         f"{sorted(set(names))}")
    log(f"(g) prepass frame: {len(names) / 5:g} kernel a frame (torch.profiler)")
    out["prepass_frame_kernels"] = len(names) / 5

    # The Engine with CA3D_OCC_SWEEP=0: on the card against the CPU at 64³,
    # then at real size, with every kernel's launch counter read around it.
    with env_var("CA3D_OCC_SWEEP", "0"):
        small = dict(grid_size=64, width=128, height=64, **LIGHTING)
        for name in ("full_quality", "two_bounces"):
            variant = LIGHTING_VARIANTS[name]
            rs.shadow_sweep_multi_cuda.launches = 0
            res = []
            for d in ("cuda", "cpu"):
                e = ct.Engine(device=d, **small, **variant)
                e.step(30)
                fr = [e.render(), e.render(), e.run_fused(2, reset_every=1)]
                res.append(([f.cpu() for f in fr], e.history.hit_idx.cpu()))
            (gpu, gidx), (cpu, cidx) = res
            need(rs.shadow_sweep_multi_cuda.launches > 0, f"K5 64^3 {name}: K5 never ran")
            need(torch.equal(gidx, cidx), f"K5 64^3 {name}: Engine ids cuda != cpu")
            for a, b in zip(gpu, cpu):
                need(bool(torch.all((a - b).abs() <= RGB_ATOL + RGB_RTOL * b.abs())),
                     f"K5 64^3 {name}: frame cuda vs cpu max err {float((a - b).abs().max())}")
            log(f"  Engine {name} with CA3D_OCC_SWEEP=0 cuda == cpu at 64^3")
        counted = (rf.raytrace_cuda, rs.primary_sweep_cuda, rs.shadow_sweep_cuda,
                   rs.shadow_sweep_multi_cuda, rs.cell_state_cuda, rs.occupied_box_cuda)
        out["launches"], out["engines"] = {}, {}
        for name, cfg, steps, fused in (
            ("k5_full_quality", dict(grid_size=GRID, **LIGHTING), 80, 10),
            ("k5_two_bounces", dict(grid_size=GRID, **LIGHTING, indirect_bounces=2), 80, 3),
            ("k5_sliced_512_gi_temporal", dict(grid_size=512, **LIGHTING, gi_temporal=True),
             160, 10),
        ):
            for fn in counted:
                fn.launches = 0
            t0 = time.perf_counter()
            eng = ct.Engine(width=WIDTH, height=HEIGHT, device="cuda", **cfg)
            eng.step(steps)
            fr = [eng.render(), eng.run_fused(fused, reset_every=fused)]
            torch.cuda.synchronize()
            counts = {fn.__name__: fn.launches for fn in counted}
            for i, f in enumerate(fr):
                need(tuple(f.shape) == (HEIGHT, WIDTH, 3), f"{name} frame {i} shape")
                need(bool(torch.isfinite(f).all()), f"{name} frame {i} has non-finite values")
                need(float(f.max()) > 0.0, f"{name} frame {i} is black")
            need(counts["shadow_sweep_multi_cuda"] > 0, f"{name}: K5 never ran: {counts}")
            need(counts["shadow_sweep_cuda"] == 0, f"{name}: K2 ran: {counts}")
            need(counts["cell_state_cuda"] > 0, f"{name}: K3 never ran: {counts}")
            need(counts["occupied_box_cuda"] == counts["shadow_sweep_multi_cuda"]
                 + counts["primary_sweep_cuda"], f"{name}: one box launch per K5 / K4 launch: "
                 f"{counts}")
            log(f"(g) {name}: step({steps}), render(), run_fused({fused}) in "
                f"{time.perf_counter() - t0:.2f} s; launches {counts}")
            out["launches"][name] = counts
            out["engines"][name] = eng
    return out


# ------------------------------------------------- (h) multi-state path ---
MS_PRESET = "pyroclastic"               # Moore B6-8/S4-7, 10 states, 4 age planes
MS_GENERATIONS = {64: 60, 256: 160, 512: 320, 1024: 560}  # from the random 5³ seed
MS_HIT_SHARE = (0.02, 0.25)
MS_SLICED = (512, 1024)   # the sliced path's grids
MS_K4_SMALL = 320         # two coarse x-groups, the last one partial
MS_ENGINES = {
    # name: (Engine overrides, run_fused kwargs, timed frames)
    "ms_256": (dict(grid_size=GRID), dict(frames=150, reset_every=10), 100),
    "ms_256_full_quality": (dict(grid_size=GRID, **LIGHTING),
                            dict(frames=50, reset_every=10), 20),
    "ms_256_gi_temporal": (dict(grid_size=GRID, **LIGHTING, gi_temporal=True),
                           dict(frames=50, reset_every=10), 20),
    "ms_sliced_512": (dict(grid_size=512), dict(frames=20, reset_every=10), 10),
    "ms_sliced_1024": (dict(grid_size=1024), dict(frames=5), 5),
}
MS_SCENE_ENGINES = ("ms_256", "ms_sliced_512", "ms_sliced_1024")  # hard shadows: scene checked


def multistate_phase(torch, np, ct, rf, rs, ca_step, AutomatonSpec, coarse_occupancy,
                     scene_cam, views, lighting_operands, compare) -> dict:
    """Phase (h): the multi-state step, K1 and K4 with ages against their
    plain versions and the dense oracle, K2 and K3 on a multi-state scene,
    the Engine on the card against the Engine on the CPU, and the Engine at
    256³, 512³ and 1024³ / 1080p with its launch counters and the checks that
    the scene exercises the ages.  Returns what (d) times and reports."""
    from cellularautomatons3d_tpu_torch.ops import ca_reference

    dev = torch.device("cuda", 0)
    preset = ct.PRESETS[MS_PRESET]
    states = preset["total_states"]
    out = {"plain_ms": {}}

    def random_ages(n, total_states, seed, p_dead=0.6):
        """Age planes and dense ages of a random volume of valid ages, with
        cells on every face."""
        g = torch.Generator(dev).manual_seed(seed)
        dense = torch.randint(1, total_states, (n, n, n), dtype=torch.uint8, device=dev,
                              generator=g)
        dense[torch.rand((n, n, n), device=dev, generator=g) < p_dead] = 0
        nbits = max(1, (total_states - 1).bit_length())
        return ca_reference.dense_to_planes(dense, nbits), dense

    def step_check(tag, planes, dense, spec, generations):
        a, b = planes, planes.clone()
        for gen in range(generations):
            a = ca_step.step_packed_multistate_cuda(a, spec)
            b = ca_step.step_packed_multistate(b, spec)
            dense = ca_reference.step_dense(dense, spec)
            where = f"{tag} generation {gen + 1}"
            need(torch.equal(a, b), f"multi-state step kernel != plain: {where}")
            need(torch.equal(ca_reference.planes_to_dense(a), dense),
                 f"multi-state step kernel != step_dense: {where}")
        return a, dense

    # The step kernel at 256³: every state count x neighbourhood x boundary.
    cases = 0
    for total_states in (3, 5, 8, 10):
        for i, neigh in enumerate(ct.NEIGHBOURHOOD_MAP):
            for boundary in ct.BoundaryMode.ALL:
                spec = AutomatonSpec.from_rule_strings(
                    GRID, neighbourhood=neigh, born="2,4", survive="1-4",
                    total_states=total_states, boundary=boundary)
                planes, dense = random_ages(GRID, total_states, 100 * total_states + i)
                _, dense = step_check(f"{total_states} states {neigh} {boundary}", planes,
                                      dense, spec, 20)
                need(int((dense > 0).sum()) > 0, f"{total_states} states {neigh}: died out")
                cases += 1
    mixed = AutomatonSpec.from_rule_strings(
        GRID, born="2", survive="1-3", born_edges="2,5", survive_edges="3-6",
        born_corners="1", survive_corners="2-4", total_states=6)
    step_check("mixed groups", *random_ages(GRID, 6, 7, p_dead=0.7), mixed, 20)
    log(f"(h) multi-state step kernel == plain == step_dense, bit-exact: "
        f"{cases + 1} cases x 20 generations at {GRID}^3")
    out["ms_cases"] = cases + 1
    for size in MS_SLICED:
        spec = AutomatonSpec.from_rule_strings(size, **preset)
        step_check(f"{size}^3 random ages", *random_ages(size, states, size), spec, 5)
        log(f"  multi-state step kernel == plain == step_dense at {size}^3: 5 generations")
    # Invalid encodings (ages >= S): the kernel follows the bit-sliced update.
    g = torch.Generator(dev).manual_seed(3)
    for total_states in (3, 5, 6, 10):
        spec = AutomatonSpec.from_rule_strings(GRID, neighbourhood="moore", born="4-9",
                                               survive="3-12", total_states=total_states)
        a = torch.randint(-2**31, 2**31 - 1, (spec.age_bits, GRID // 32, GRID, GRID),
                          dtype=torch.int32, device=dev, generator=g)
        want = ca_step.step_packed_multistate(a, spec)
        need(torch.equal(ca_step.step_packed_multistate_cuda(a, spec), want),
             f"multi-state step on random words, {total_states} states")
        alive, vis = ca_step.age_masks_cuda(a)
        want_alive, want_vis = ca_step.age_masks(a)
        need(torch.equal(alive, want_alive) and torch.equal(vis, want_vis),
             f"age masks kernel != plain, {a.shape[0]} planes")
    log("  multi-state step and age-masks kernels == plain on random words")

    # The scenes: the preset grown from the Engine's random 5³ seed.
    def scene(size):
        eng = ct.Engine(grid_size=size, width=WIDTH, height=HEIGHT, device="cuda",
                        random_initial_state=True, **preset)
        eng.step(MS_GENERATIONS[size])
        alive, vis = ca_step.age_masks_cuda(eng.state)
        want_alive, want_vis = ca_step.age_masks(eng.state)
        need(torch.equal(alive, want_alive) and torch.equal(vis, want_vis),
             f"age masks kernel != plain on the {size}^3 scene")
        return eng.state, vis, eng.spec

    def hit_ages(planes, idx):
        dense = ca_reference.planes_to_dense(planes).reshape(-1)
        return dense[idx.clamp(min=0).long()][idx >= 0]

    def scene_checks(tag, planes, idx):
        """The scene exercises the ages: it lives, every age is on screen,
        and as many pixels hit as in the binary scenes."""
        pop = int((ca_step.age_masks_cuda(planes, alive=False)[1] != 0).sum())
        ages = torch.bincount(hit_ages(planes, idx).long(), minlength=states).tolist()
        share = float((idx >= 0).float().mean())
        log(f"  scene {tag}: {pop} non-empty words, hit share {share:.4f}, hit ages {ages}")
        need(pop > 0, f"{tag}: the scene died out")
        need(ages[0] == 0 and all(a > 0 for a in ages[1:]), f"{tag}: hit ages {ages}")
        need(MS_HIT_SHARE[0] <= share <= MS_HIT_SHARE[1], f"{tag}: hit share {share}")

    # K1 with ages against its plain version, both modes.
    k1_err = k1_frac = 0.0
    for size, w, h in ((64, 128, 64), (GRID, WIDTH, HEIGHT)):
        planes, vis, spec = scene(size)
        coarse = coarse_occupancy(vis)
        cam = scene_cam(views["front"], w, h)
        kw = dict(grid_size=size, width=w, height=h, shadow=True, ages=planes,
                  total_states=states)
        tag = f"K1 with ages {size}^3 {w}x{h} gen-{MS_GENERATIONS[size]}"
        got = rf.raytrace_cuda(vis, coarse, cam, **kw)
        want = rf.raytrace(vis, coarse, cam, **kw)
        e, f = compare(f"{tag} non-compose", got, want)
        k1_err, k1_frac = max(k1_err, e), max(k1_frac, f)
        keep = torch.rand(want[2].shape, device=dev,
                          generator=torch.Generator(dev).manual_seed(7)) < 0.7
        hist = (torch.clamp(want[0] * 1.5 + 0.02, 0.0, 1.0).contiguous(),
                torch.where(keep, want[2], want[2] + 1).contiguous())
        got = rf.raytrace_cuda(vis, coarse, cam, hist, **kw)
        want = rf.raytrace(vis, coarse, cam, hist, **kw)
        e, f = compare(f"{tag} compose", got, want)
        k1_err, k1_frac = max(k1_err, e), max(k1_frac, f)
        binary = rf.raytrace_cuda(vis, coarse, cam, grid_size=size, width=w, height=h,
                                  shadow=True)
        need(torch.equal(binary[2], got[2]), f"{tag}: ids differ from the binary frame")
        need(float(got[0].sum()) > 0, f"{tag}: black")
    scene_checks(f"{GRID}^3", planes, got[2])
    need(float(rf.raytrace_cuda(vis, coarse, cam, **kw)[0].sum()) < float(binary[0].sum()),
         "K1 with ages is not dimmer than the binary frame")
    out["k1_timed"] = (planes, vis, coarse, cam, hist, kw)
    out["k1_max_abs_err"], out["k1_id_mismatch"] = k1_err, k1_frac

    # K2 and K3 on a full-quality frame's queries of the multi-state scene.
    vol, coarse, cam, _, k2, _, _, lookups = lighting_operands(GRID, WIDTH, HEIGHT, vol=vis)
    kw23 = dict(grid_size=GRID, cell_half=rs._cell_half(cam, GRID))
    k2_bad = int((rs.shadow_sweep_cuda(vol, coarse, *k2, **kw23)
                  != rs.shadow_sweep(vol, *k2, **kw23)).sum())
    log(f"  multi-state scene {GRID}^3: K2 {k2[0].shape[0]} queries, {int(k2[3].sum())} "
        f"active, {k2_bad} differ")
    need(k2_bad == 0, "K2 != plain on the multi-state scene")
    want3 = k3_check(torch, rs, f"multi-state scene {GRID}^3", vol, GRID, lookups)
    need(int(want3.sum()) > 0, "K3 on the multi-state scene: no neighbour found")
    del vol, k2, lookups, want3

    # K4 with ages: ids and ages equal, t within tolerance.
    k4_err = 0.0

    def k4_check(tag, planes, vis, size, cam, w, h):
        nonlocal k4_err
        coarse = coarse_occupancy(vis)
        kw = dict(grid_size=size, width=w, height=h)
        t_k, i_k, a_k = rs.primary_sweep_cuda(vis, coarse, cam, planes, **kw)
        (t_p, i_p, a_p), ms = timed(torch, lambda: rs.primary_sweep(vis, cam, planes, **kw))
        bad, bad_age = int((i_k != i_p).sum()), int((a_k != a_p).sum())
        err = float((t_k - t_p).abs().max())
        log(f"  K4 with ages {tag}: {int((i_p >= 0).sum())} hits, {bad} ids and {bad_age} "
            f"ages differ, max |t| err {err:.3g}, plain {ms:.1f} ms")
        need(bad == 0 and bad_age == 0, f"K4 with ages {tag}: ids or ages differ")
        need(err <= DEPTH_ATOL, f"K4 with ages {tag}: t error {err}")
        need(torch.equal(hit_ages(planes, i_k).to(torch.int32), a_k[i_k >= 0]),
             f"K4 with ages {tag}: the age image is not the hit cells' age")
        need(bool((a_k[i_k < 0] == 1).all()), f"K4 with ages {tag}: a miss's age is not 1")
        t_b, i_b = rs.primary_sweep_cuda(vis, coarse, cam, **kw)
        need(torch.equal(i_b, i_k) and torch.equal(t_b, t_k),
             f"K4 {tag}: the outputs change with the ages")
        k4_err = max(k4_err, err)
        return coarse, i_k, ms

    planes, _ = random_ages(MS_K4_SMALL, states, 5, p_dead=0.99)
    vis = ca_step.age_masks_cuda(planes, alive=False)[1]
    for name, view in views.items():
        k4_check(f"{MS_K4_SMALL}^3 480x270 random {name}", planes, vis, MS_K4_SMALL,
                 scene_cam(view, 480, 270), 480, 270)
    out["k4_timed"] = {}
    for size in MS_SLICED:
        planes, vis, spec = scene(size)
        cam = scene_cam(views["front"], WIDTH, HEIGHT)
        tag = f"{size}^3 {WIDTH}x{HEIGHT} gen-{MS_GENERATIONS[size]}"
        coarse, idx, out["plain_ms"][f"k4_ages_{size}_plain_ms"] = k4_check(
            tag, planes, vis, size, cam, WIDTH, HEIGHT)
        scene_checks(f"{size}^3", planes, idx)
        out["k4_timed"][size] = (planes, vis, coarse, cam, spec)
    out["k4_max_abs_err"] = k4_err
    del planes, vis, coarse, idx

    # The Engine on the card against the Engine on the CPU.
    block = np.random.default_rng(1)
    lo = MS_K4_SMALL // 2 - 32  # a 64³ block of random ages at the centre
    ages_small = np.zeros((MS_K4_SMALL,) * 3, np.uint8)
    ages_small[lo:lo + 64, lo:lo + 64, lo:lo + 64] = np.where(
        block.random((64,) * 3) < 0.2, 1,
        np.where(block.random((64,) * 3) < 0.3, block.integers(1, states, (64,) * 3), 0))
    for name, cfg in (("64^3 hard", dict(grid_size=64)),
                      ("64^3 full quality", dict(grid_size=64, **LIGHTING)),
                      ("64^3 gi_temporal", dict(grid_size=64, **LIGHTING, gi_temporal=True)),
                      (f"{MS_K4_SMALL}^3 hard", dict(grid_size=MS_K4_SMALL))):
        res = []
        for d in ("cuda", "cpu"):
            e = ct.Engine(device=d, width=128, height=64, random_initial_state=True,
                          **preset, **cfg)
            if cfg["grid_size"] == MS_K4_SMALL:
                e.set_state_dense(ages_small)
                e.step(3)
            else:
                e.step(40)
            fr = [e.render(), e.render(), e.run_fused(2, reset_every=1)]
            res.append(([f.cpu() for f in fr], e.history.hit_idx.cpu(), e.state.cpu()))
        (gpu, gidx, gstate), (cpu, cidx, cstate) = res
        need(torch.equal(gstate, cstate), f"multi-state Engine {name}: state cuda != cpu")
        need(torch.equal(gidx, cidx), f"multi-state Engine {name}: ids cuda != cpu")
        need(int((cidx >= 0).sum()) > 0, f"multi-state Engine {name}: no pixel hits")
        for a, b in zip(gpu, cpu):
            need(bool(torch.all((a - b).abs() <= RGB_ATOL + RGB_RTOL * b.abs())),
                 f"multi-state Engine {name}: frame cuda vs cpu max err "
                 f"{float((a - b).abs().max())}")
        log(f"  multi-state Engine {name} cuda == cpu ({len(gpu)} frames, "
            f"{int((cidx >= 0).sum())} hit pixels)")

    # The path at full width.
    counted = (ca_step.step_packed_multistate_cuda, ca_step.age_masks_cuda,
               ca_step.fires_plane_cuda, rf.raytrace_cuda, rs.primary_sweep_cuda,
               rs.shadow_sweep_cuda, rs.cell_state_cuda, rs.occupied_box_cuda)
    out["launches"], out["engines"] = {}, {}
    for name, (cfg, fused, frames) in MS_ENGINES.items():
        for fn in counted:
            fn.launches = 0
        size = cfg["grid_size"]
        steps = MS_GENERATIONS[size]
        t0 = time.perf_counter()
        eng = ct.Engine(width=WIDTH, height=HEIGHT, device="cuda",
                        random_initial_state=True, **preset, **cfg)
        if cfg.get("indirect_lighting"):
            # Off the screen's exact diagonal: there a ray meets the vertical
            # edge of a cell on the grid's diagonal, the GI slot's viewer then
            # lies in its neighbour's face plane (n·v = 0) and the specular
            # term is 0/0, in the reference as in the port (ROADMAP.md queue
            # 3): 3 pixels of this scene from the default camera.
            eng.camera.translate((1, 0, 0), 0.01)
        eng.step(steps)
        fr = [eng.render(), eng.render()]
        if name in MS_SCENE_ENGINES:
            scene_checks(name, eng.state, eng.history.hit_idx)
        fr.append(eng.run_fused(**fused))
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in counted}
        for i, f in enumerate(fr):
            need(tuple(f.shape) == (HEIGHT, WIDTH, 3), f"{name} frame {i} shape {tuple(f.shape)}")
            need(bool(torch.isfinite(f).all()), f"{name} frame {i} has non-finite values")
            need(float(f.max()) > 0.0, f"{name} frame {i} is black")
        generations = steps + fused["frames"]
        # One alive pass per generation, one visibility pass per frame, and
        # one more of the latter for scene_checks' population.
        passes = generations + 2 + fused["frames"] + (name in MS_SCENE_ENGINES)
        need(counts["step_packed_multistate_cuda"] == generations,
             f"{name}: {generations} generations, launches {counts}")
        need(counts["age_masks_cuda"] == passes, f"{name}: {passes} mask passes, {counts}")
        need(counts["fires_plane_cuda"] == 0, f"{name} launched the binary step: {counts}")
        needed = ["primary_sweep_cuda", "shadow_sweep_cuda"] if size > GRID else ["raytrace_cuda"]
        unused = ["raytrace_cuda"] if size > GRID else ["primary_sweep_cuda"]
        if cfg.get("indirect_lighting"):
            needed += ["shadow_sweep_cuda", "cell_state_cuda"]
        if "shadow_sweep_cuda" in needed:
            needed.append("occupied_box_cuda")
        need(all(counts[k] > 0 for k in needed), f"{name} missed a kernel: {counts}")
        need(counts["occupied_box_cuda"] == counts["primary_sweep_cuda"]
             + counts["shadow_sweep_cuda"], f"{name}: one box launch per K2 / K4 launch: {counts}")
        need(all(counts[k] == 0 for k in unused), f"{name} launched {unused}: {counts}")
        log(f"(h) {name}: step({steps}), render() x2, run_fused({fused}) in "
            f"{time.perf_counter() - t0:.2f} s; launches {counts}")
        out["launches"][name] = counts
        out["engines"][name] = (eng, frames)
    return out


def multistate_timings(torch, ct, rf, rs, ca_step, AutomatonSpec, ms):
    """Phase (d) for the multi-state path, from phase (h)'s scenes: the step
    (both launches), its plain version, the masks pass alone and the binary
    kernel on the same rule and the same alive plane; K1 compose and
    K4 with and without ages on the same visibility plane (alternated); step
    + frame of each Engine of (h).  Returns (timings, specs by size, states
    by size)."""
    from cellularautomatons3d_tpu_torch.utils.metrics import cuda_time_fn

    ms_ms = dict(ms["plain_ms"])
    ms_specs = {GRID: ms["engines"]["ms_256"][0].spec,
                **{size: v[4] for size, v in ms["k4_timed"].items()}}
    ms_states = {GRID: ms["k1_timed"][0], **{size: v[0] for size, v in ms["k4_timed"].items()}}
    for size, planes in ms_states.items():
        spec_ms = ms_specs[size]
        binary_spec = AutomatonSpec.from_rule_strings(
            size, **{k: v for k, v in ct.PRESETS[MS_PRESET].items() if k != "total_states"})
        alive = ca_step.age_masks_cuda(planes, vis=False)[0]
        iters = 500 if size == GRID else 50 if size == MS_SLICED[0] else 20
        ms_ms[f"ms_step_{size}_ms"] = cuda_time_fn(
            lambda: ca_step.step_packed_multistate_cuda(planes, spec_ms), reps=iters,
            warmup=3)
        ms_ms[f"age_masks_{size}_ms"] = cuda_time_fn(
            lambda: ca_step.age_masks_cuda(planes, vis=False), reps=iters, warmup=3)
        ms_ms[f"ca_step_same_rule_{size}_ms"] = cuda_time_fn(
            lambda: ca_step.fires_plane_cuda(alive, binary_spec), reps=iters, warmup=3)
        if size == GRID:
            ms_ms["ms_step_plain_ms"] = cuda_time_fn(
                lambda: ca_step.step_packed_multistate(planes, spec_ms), reps=10, warmup=2)
            ms_ms["age_masks_plain_ms"] = cuda_time_fn(
                lambda: ca_step.age_masks(planes), reps=20, warmup=2)
    planes, vis, coarse, cam, hist, kw = ms["k1_timed"]
    kw_binary = {k: v for k, v in kw.items() if k not in ("ages", "total_states")}
    with_ages = lambda: rf.raytrace_cuda(vis, coarse, cam, hist, **kw)  # noqa: E731
    without = lambda: rf.raytrace_cuda(vis, coarse, cam, hist, **kw_binary)  # noqa: E731
    reads = [cuda_time_fn(fn, reps=50, warmup=3) for fn in (without, with_ages, with_ages, without)]
    ms_ms["k1_compose_ms_scene_ms"] = (reads[0] + reads[3]) / 2
    ms_ms["k1_compose_ages_ms"] = (reads[1] + reads[2]) / 2
    ms_ms["k1_compose_without_with_with_without_ms"] = reads
    ms_ms["k1_ages_plain_compose_ms"] = cuda_time_fn(
        lambda: rf.raytrace(vis, coarse, cam, hist, **kw), reps=2, warmup=1)
    for size, (planes, vis, coarse, cam, _) in ms["k4_timed"].items():
        kw4 = dict(grid_size=size, width=WIDTH, height=HEIGHT)
        with_ages = lambda: rs.primary_sweep_cuda(vis, coarse, cam, planes, **kw4)  # noqa: E731
        without = lambda: rs.primary_sweep_cuda(vis, coarse, cam, **kw4)  # noqa: E731
        reads = [cuda_time_fn(fn, reps=20, warmup=2)
                 for fn in (without, with_ages, with_ages, without)]
        ms_ms[f"k4_{size}_ms_scene_ms"] = (reads[0] + reads[3]) / 2
        ms_ms[f"k4_ages_{size}_ms"] = (reads[1] + reads[2]) / 2
        ms_ms[f"k4_without_with_with_without_{size}_ms"] = reads
    for name, (e, fr) in ms["engines"].items():
        ms_ms[f"{name}_step_plus_frame_ms"] = cuda_time_fn(
            lambda e=e, fr=fr: e.run_fused(fr, reset_every=min(fr, 10)), reps=1,
            warmup=0) / fr
    return ms_ms, ms_specs, ms_states


def multistate_bounds(torch, rf, rs, ca_step, ms, ms_specs, ms_states) -> dict:
    """The bounds of the multi-state kernels from phase (h)'s inputs."""
    from cellularautomatons3d_tpu_torch.ops.occupancy import occupied_box

    dev = torch.device("cuda", 0)
    px = WIDTH * HEIGHT
    bounds = {}
    # The multi-state step is timed as its wrapper runs it, both launches, so
    # its bound counts both: the masks pass reads B planes and writes the
    # alive plane, the step kernel reads the B planes and the alive plane and
    # writes B.  The masks pass also stands alone, as the renderer calls it.
    ms_rule = ca_step._rule_arrays(ms_specs[GRID])
    ms_values = sum(bin(int(m)).count("1")
                    for m in (*ms_rule[3][:ms_rule[0]], *ms_rule[4][:ms_rule[0]]))
    age_bits = ms_specs[GRID].age_bits
    for size in ms_states:
        words = size**3 // 32
        key = "" if size == GRID else f"_{size}"
        bounds[f"age_masks{key}"] = bound(4 * words * (age_bits + 1), words * 2 * age_bits)
        bounds[f"ca_step_multistate{key}"] = bound(
            4 * words * (2 * age_bits + 1) + bounds[f"age_masks{key}"]["bytes"],
            words * (int(ms_rule[1][:ms_rule[0]].sum()) * OPS_CA_NEIGHBOUR
                     + ms_values * OPS_CA_RULE_VALUE + age_bits * OPS_CA_DECAY)
            + bounds[f"age_masks{key}"]["ops"])
    # K1 and K4 with ages on the multi-state scenes: the binary kernels' work
    # plus the age words of each hit pixel (a 32-byte sector per plane).
    planes, vis, coarse, cam, hist, kw = ms["k1_timed"]
    _, depth, idx, _ = rf.raytrace_cuda(vis, coarse, cam, hist, **kw)
    box = occupied_box(coarse, GRID)
    act, cols = primary_work(torch, rf, cam, GRID, WIDTH, HEIGHT, depth, idx, dev, box)
    _, dx, dy, dz = rf._pixel_rays(cam, WIDTH, HEIGHT, dev)
    q = torch.stack([dx, dy, dz]) * depth + torch.tensor(
        cam[rf.P_O:rf.P_O + 3], device=dev)[:, None, None]
    light = torch.tensor(cam[rf.P_LIGHT:rf.P_LIGHT + 3], device=dev)[:, None, None]
    _, shadow_ops = occlusion_work(torch, q[None], light.expand_as(q)[None],
                                   (idx >= 0)[None], GRID, 0, box)
    hits = int((idx >= 0).sum())
    bounds["render_fast_ages"] = bound(
        mip_bytes(GRID) + px * 48 + hits * age_bits * 32,
        act * OPS_RAY + cols * OPS_COLUMN + hits * (OPS_SHADE + OPS_AGE) + shadow_ops)
    for size, (planes, vis, coarse, cam, _) in ms["k4_timed"].items():
        t4, i4, _ = rs.primary_sweep_cuda(vis, coarse, cam, planes, grid_size=size,
                                          width=WIDTH, height=HEIGHT)
        act, cols = primary_work(torch, rf, cam, size, WIDTH, HEIGHT, t4, i4, dev,
                                 occupied_box(coarse, size))
        hits = int((i4 >= 0).sum())
        bounds[f"primary_sweep_ages_{size}"] = bound(
            mip_bytes(size) + px * 12 + hits * age_bits * 32,
            act * OPS_RAY + cols * OPS_COLUMN + hits * OPS_AGE)
    return bounds


# ---------------------------------------------- (j) the interactive path ---
# name: (Engine overrides, generations before the moves, moved ticks)
INTERACTIVE = {
    "moved_256": (dict(grid_size=GRID), 80, 10),
    "moved_512": (dict(grid_size=512), 160, 5),
    "moved_256_gi_temporal": (dict(grid_size=GRID, gi_temporal=True, **LIGHTING), 80, 10),
}


def move_camera(cam, i):
    """The viewer's three inputs in one frame: a WASD translate, an arrow
    rotate and a mouse look, to alternate sides so the scene stays in view."""
    s = 1 if i % 2 == 0 else -1
    cam.translate((s, 0, -1), 0.016)
    cam.rotate((0, 1, 0), 0.004 * s)
    cam.mouse_look(6.0 * s, -3.0 * s)


@contextlib.contextmanager
def recorded_frames(engine_mod):
    """Record each ``render_frame_fast`` call the Engine makes: its
    arguments and the history it returned (the calls are the Engine's own)."""
    real = engine_mod.render_frame_fast
    calls = []

    def spy(s, packed, params, history, camera_static, sample_idx=None, **kw):
        out = real(s, packed, params, history, camera_static, sample_idx, **kw)
        calls.append(dict(s=s, packed=packed, params=params, history=history,
                          camera_static=camera_static, sample_idx=sample_idx, kw=kw,
                          new=out[2]))
        return out

    engine_mod.render_frame_fast = spy
    try:
        yield calls
    finally:
        engine_mod.render_frame_fast = real


def reprojection_inputs(rfast, call):
    """The moved frame's traced (rgb, depth, idx), traced again from the
    recorded arguments (the frame's own ids are checked against them)."""
    s, params = call["s"], call["params"]
    cam = rfast._cam_vec(params, s.width, s.height)
    return rfast.trace_shaded(s, call["packed"], cam, call["sample_idx"], **call["kw"])


def interactive_phase(torch, np, ct, rf, rs, ca_step, occupancy) -> dict:
    """Phase (j): the interactive path on the card.  Engines at 1080p whose
    camera moves before every tick (K1 non-compose at 256³, K4 + K2 at 512³,
    K1 + K2 + K3 with gi_temporal), their launch counters read around the
    moved ticks, and ``reproject_history`` of every moved frame on the card
    against the CPU on the same inputs; the Engine on the card against the
    CPU at 64³; a checkpoint saved and loaded on the card and on the CPU; the
    viewer over the 256³ engine, with one HTTP request of each kind.
    Returns what (d) times and the report keeps."""
    from cellularautomatons3d_tpu_torch import engine as engine_mod
    from cellularautomatons3d_tpu_torch import native
    from cellularautomatons3d_tpu_torch.render import renderer_fast as rfast
    from cellularautomatons3d_tpu_torch.utils import image
    from cellularautomatons3d_tpu_torch.viewer import server
    from _torch_png import decode_png

    counted = (ca_step.fires_plane_cuda, rf.raytrace_cuda, rs.primary_sweep_cuda,
               rs.shadow_sweep_cuda, rs.cell_state_cuda, occupancy.occupied_box_cuda)
    out = {"launches": {}, "valid_px": {}, "valid_share_of_hits": {}, "engines": {},
           "walls_s": {}}
    for name, (over, steps, ticks) in INTERACTIVE.items():
        t0 = time.perf_counter()
        eng = ct.Engine(width=WIDTH, height=HEIGHT, device="cuda", **over)
        if over.get("indirect_lighting"):
            eng.camera.translate((1, 0, 0), 0.01)  # off the GI 0/0 diagonal, as in (h)
        eng.step(steps)
        eng.render()
        for fn in counted:
            fn.launches = 0
        rf.raytrace_cuda.compose_launches = 0
        with recorded_frames(engine_mod) as calls:
            frames = []
            for i in range(ticks):
                move_camera(eng.camera, i)
                frames.append(eng.tick())
            torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in counted}
        counts["raytrace_cuda_compose"] = rf.raytrace_cuda.compose_launches
        out["walls_s"][name] = time.perf_counter() - t0
        for i, f in enumerate(frames):
            need(tuple(f.shape) == (HEIGHT, WIDTH, 3), f"(j) {name} frame {i} shape {tuple(f.shape)}")
            need(bool(torch.isfinite(f).all()), f"(j) {name} frame {i} has non-finite values")
            need(float(f.max()) > 0.0, f"(j) {name} frame {i} is black")
        need(len(calls) == ticks and not any(c["camera_static"] for c in calls),
             f"(j) {name}: the Engine did not render every tick as moved")
        sliced, lit = over["grid_size"] > GRID, bool(over.get("indirect_lighting"))
        want = {"raytrace_cuda": 0 if sliced else ticks, "raytrace_cuda_compose": 0,
                "primary_sweep_cuda": ticks if sliced else 0,
                "shadow_sweep_cuda": ticks if sliced or lit else 0,
                "cell_state_cuda": ticks if lit else 0,
                "fires_plane_cuda": eng.simulation_step - steps}
        need(all(counts[k] == v for k, v in want.items()),
             f"(j) {name}: launches {counts}, expected {want}")
        need(counts["fires_plane_cuda"] > 0, f"(j) {name}: the CA never stepped")
        need(counts["occupied_box_cuda"] == counts["shadow_sweep_cuda"]
             + counts["primary_sweep_cuda"], f"(j) {name}: one box per K2 / K4: {counts}")
        # reproject_history on the card against the CPU, on the same inputs.
        valid = hits = 0
        for i, c in enumerate(calls):
            rgb, depth, idx = reprojection_inputs(rfast, c)
            need(torch.equal(idx, c["new"].hit_idx), f"(j) {name} frame {i}: traced ids differ")
            s, params = c["s"], c["params"]
            got = rfast.reproject_history(c["history"], rgb, depth, idx, params,
                                          s.width, s.height)
            hist = rfast.FastHistory(c["history"].color.cpu(), c["history"].hit_idx.cpu())
            ref = rfast.reproject_history(hist, rgb.cpu(), depth.cpu(), idx.cpu(), params,
                                          s.width, s.height)
            src_frac = float((got[1].cpu() != ref[1]).float().mean())
            valid_frac = float((got[2].cpu() != ref[2]).float().mean())
            need(src_frac <= ID_MISMATCH_LIMIT and valid_frac <= ID_MISMATCH_LIMIT,
                 f"(j) {name} frame {i}: source pixel / valid differ on {src_frac} / "
                 f"{valid_frac} of the pixels")
            same = got[2].cpu() == ref[2]
            a, b = got[0].cpu()[same], ref[0][same]
            need(bool(torch.all((a - b).abs() <= RGB_ATOL + RGB_RTOL * b.abs())),
                 f"(j) {name} frame {i}: reprojected rgb cuda vs cpu max err "
                 f"{float((a - b).abs().max())}")
            valid += int(ref[2].sum())
            hits += int((idx >= 0).sum())
        need(valid > 0, f"(j) {name}: no pixel kept its history through a move")
        out["valid_px"][name] = valid / len(calls)
        out["valid_share_of_hits"][name] = valid / max(hits, 1)
        out["launches"][name] = counts
        out["engines"][name] = eng
        if name == "moved_256":
            last = calls[-1]
            out["reproject_inputs"] = (last["history"], *reprojection_inputs(rfast, last),
                                       last["params"])
        del calls
        log(f"(j) {name}: step({steps}), render(), {ticks} moved ticks in "
            f"{out['walls_s'][name]:.2f} s; launches {counts}; history kept on "
            f"{out['valid_px'][name]:.0f} px a frame, {out['valid_share_of_hits'][name]:.3f} "
            f"of the hits (card == cpu reprojection)")

    # The Engine on the card against the CPU, 10 moved ticks at 64³.
    small = dict(grid_size=64, width=128, height=64)
    res = []
    for d in ("cuda", "cpu"):
        e = ct.Engine(device=d, **small)
        e.step(30)
        e.render()
        fr = []
        for i in range(10):
            move_camera(e.camera, i)
            fr.append((e.tick().cpu(), e.history.hit_idx.cpu()))
        res.append((fr, e.state.cpu()))
    (gpu, gst), (cpu, cst) = res
    need(torch.equal(gst, cst), "(j) 64^3 moved Engine state cuda != cpu")
    worst = 0.0
    for i, ((fg, ig), (fc, ic)) in enumerate(zip(gpu, cpu)):
        frac = float((ig != ic).float().mean())
        worst = max(worst, frac)
        need(frac <= ID_MISMATCH_LIMIT, f"(j) 64^3 moved tick {i}: ids differ on {frac}")
        ok = ig == ic
        need(bool(torch.all((fg - fc).abs()[ok] <= RGB_ATOL + RGB_RTOL * fc.abs()[ok])),
             f"(j) 64^3 moved tick {i}: frame cuda vs cpu max err {float((fg - fc).abs().max())}")
    log(f"(j) Engine cuda == cpu over 10 moved ticks at 64^3 (id mismatch {worst:.3g})")
    out["small_id_mismatch"] = worst

    # A checkpoint on the card: save, load on the card and on the CPU.
    ck_dir = HERE / "build" / "checkpoints"
    ck_dir.mkdir(parents=True, exist_ok=True)
    out["checkpoint_ms"] = {}
    for name in ("moved_256", "moved_512"):
        eng = out["engines"][name]
        path = str(ck_dir / f"{name}.npz")
        t0 = time.perf_counter()
        eng.save(path)
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        back = ct.Engine.load(path, device="cuda")
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        need(back.device.type == "cuda", f"(j) {name}: load put the Engine on {back.device}")
        need(torch.equal(back.state, eng.state), f"(j) {name}: loaded state differs")
        need(torch.equal(back.history.color, eng.history.color)
             and torch.equal(back.history.hit_idx, eng.history.hit_idx),
             f"(j) {name}: loaded history differs")
        need(all(np.array_equal(getattr(back.camera, k), getattr(eng.camera, k))
                 for k in ("view_mat", "prev_view_mat", "prev_proj_view")),
             f"(j) {name}: loaded camera differs")
        need((back.simulation_step, back._time_ms, back._frame_duration)
             == (eng.simulation_step, eng._time_ms, eng._frame_duration),
             f"(j) {name}: loaded counters differ")
        for e in (eng, back):
            move_camera(e.camera, 0)
        need(torch.equal(back.render(), eng.render()),
             f"(j) {name}: the next moved frame after load differs")
        on_cpu = ct.Engine.load(path, device="cpu")
        need(torch.equal(on_cpu.state, eng.state.cpu()), f"(j) {name}: CPU load state differs")
        size_mb = os.path.getsize(path) / 2**20
        os.remove(path)
        out["checkpoint_ms"][name] = {"save_ms": save_ms, "load_ms": load_ms, "file_mib": size_mb}
        del back, on_cpu
        log(f"(j) checkpoint {name}: save {save_ms:.1f} ms, load on the card {load_ms:.1f} ms "
            f"({size_mb:.2f} MiB), next moved frame bit for bit")
    ck_dir.rmdir()

    # The viewer over the 256³ 1080p engine.
    eng = out["engines"]["moved_256"]
    viewer = server.ViewerServer(engine=eng)
    shown = []
    real_tick = eng.tick
    eng.tick = lambda dt_ms=16.667: shown.append(real_tick(dt_ms)) or shown[-1]
    try:
        png_ms = []
        for i in range(10):
            s = 1 if i % 2 == 0 else -1
            viewer.handle_input({"type": "keys", "dt": 0.016, "translate": [s, 0, -1]})
            viewer.handle_input({"type": "mouse", "dx": 6 * s, "dy": -3 * s})
            t0 = time.perf_counter()
            png = viewer.frame_png()
            png_ms.append((time.perf_counter() - t0) * 1e3)
            need(np.array_equal(decode_png(png), image.to_uint8(shown[-1])),
                 f"(j) viewer frame {i}: the PNG is not the frame")
        httpd = viewer.make_server(port=0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        # http.client, not urllib: no proxy from the environment can take it
        # off this host.
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=120)
        try:
            conn.request("GET", "/frame")
            r = conn.getresponse()
            png = r.read()
            need(r.status == 200 and np.array_equal(decode_png(png), image.to_uint8(shown[-1])),
                 f"(j) GET /frame: {r.status}, the PNG is not the frame")
            conn.request("POST", "/input", body=json.dumps({"type": "mouse", "dx": 4, "dy": 1}),
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            reply = json.loads(r.read())
            need(r.status == 200 and reply.get("ok") is True, f"(j) POST /input: {reply}")
        finally:
            conn.close()
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=60)
        need(not thread.is_alive(), "(j) the HTTP server thread did not stop")
    finally:
        del eng.tick
    out["frame_png_ms"] = png_ms
    out["have_native"] = bool(native.HAVE_NATIVE)
    out["native_build_error"] = native.BUILD_ERROR
    log(f"(j) viewer: 10 frame_png() at {WIDTH}x{HEIGHT}, median "
        f"{sorted(png_ms)[len(png_ms) // 2]:.1f} ms ({min(png_ms):.1f}-{max(png_ms):.1f}); "
        f"GET /frame and POST /input over 127.0.0.1; HAVE_NATIVE {out['have_native']}"
        + (f" ({out['native_build_error']})" if out["native_build_error"] else ""))
    return out


def interactive_timings(torch, out) -> dict:
    """Phase (d) for (j): render() with a static camera against a moved one,
    alternated static, moved, moved, static, at 256³ and 512³ (CUDA events
    around 10 back-to-back calls: host-bound calls read the host's time);
    reproject_history alone; and from a torch.profiler trace of 5 calls
    each, the kernels and device ms of a static and a moved render() and of
    reproject_history."""
    from torch.profiler import ProfilerActivity, profile

    from cellularautomatons3d_tpu_torch.render import renderer_fast as rfast
    from cellularautomatons3d_tpu_torch.utils.metrics import cuda_time_fn

    def device_events(fn, calls):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        return len(ev) / calls, sum(e.time_range.elapsed_us() for e in ev) / 1e3 / calls

    ms = {}
    for name in ("moved_256", "moved_512"):
        eng = out["engines"][name]
        turn = [0]

        def moved():
            move_camera(eng.camera, turn[0])
            turn[0] += 1
            eng.render()

        reads = {"static": [], "moved": []}
        for kind in ("static", "moved", "moved", "static"):
            fn = eng.render if kind == "static" else moved
            reads[kind].append(cuda_time_fn(fn, reps=10, warmup=2))
        size = INTERACTIVE[name][0]["grid_size"]
        ms[f"render_static_{size}_ms"] = sum(reads["static"]) / 2
        ms[f"render_moved_{size}_ms"] = sum(reads["moved"]) / 2
        ms[f"render_static_moved_moved_static_{size}_ms"] = [
            reads["static"][0], reads["moved"][0], reads["moved"][1], reads["static"][1]]
        eng.render()
        for kind, fn in (("static", eng.render), ("moved", moved)):
            k, d = device_events(fn, 5)
            ms[f"render_{kind}_{size}_kernels"] = k
            ms[f"render_{kind}_{size}_device_ms"] = d
        ms[f"moved_frame_added_kernels_{size}"] = (ms[f"render_moved_{size}_kernels"]
                                                   - ms[f"render_static_{size}_kernels"])
    hist, rgb, depth, idx, params = out["reproject_inputs"]

    def reproject():
        rfast.reproject_history(hist, rgb, depth, idx, params, WIDTH, HEIGHT)

    ms["reproject_history_ms"] = cuda_time_fn(reproject, reps=20, warmup=2)
    ms["reproject_history_kernels"], ms["reproject_history_device_ms"] = device_events(
        reproject, 5)
    return ms


# -------------------------------------- (k) the exact reference pipeline ---
def reference_configs(ct) -> dict:
    """name: (Engine overrides, generations before the frames, static ticks,
    moved ticks, timed frames) of phase (k).  Every camera starts 0.01 off
    the screen's diagonal (the GI 0/0 decision, as in (h) and (j))."""
    pyro = dict(ct.PRESETS["pyroclastic"], random_initial_state=True)
    return {
        "reference_256": (dict(grid_size=GRID), 80, 3, 3, 5),
        "simple_256": (dict(grid_size=GRID, render_variant="simple"), 80, 2, 2, 5),
        "pyroclastic_256": (dict(grid_size=GRID, **pyro), 160, 2, 2, 5),
        "lighting_256": (dict(grid_size=GRID, **LIGHTING), 80, 1, 1, 3),
        "two_bounces_256": (dict(grid_size=GRID, indirect_bounces=2, **LIGHTING), 80, 1, 1, 3),
        "reference_1024": (dict(grid_size=1024), 200, 1, 0, 3),
        # BASELINE config 1: rule 4/4/5 "Amoeba" at 64³, non-clustered, 640×480.
        "baseline_config1": (dict(ct.PRESETS["amoeba-445"], grid_size=64, width=640,
                                  height=480, render_variant="simple"), 10, 2, 2, 5),
    }


REFERENCE_CARD_MISMATCH = 1e-3   # tests/test_torch_cuda.py's bound, card vs CPU


def reference_phase(torch, np, ct, rf, rs, ca_step, occupancy) -> dict:
    """Phase (k): Engine(pipeline="reference") on the card, the reference
    pipeline's frames in plain torch and the CA step's kernels.  First the
    Engine on the card against the CPU at 64³ / 256×128 over 4 ticks with a
    camera move (states equal, frames within tests/_torch_reference_scene.py's
    comparison); then each configuration of :func:`reference_configs` with
    every kernel's counter set to 0 before it and read after it (CA steps
    only: the frame launches no hand kernel), its frames finite, lit and
    of a RenderHistory; then its frame time (CUDA events around single
    render() calls, median after a warm-up), the kernels and device ms of
    one render() from a torch.profiler trace, and the peak memory of a
    render() above what the process had allocated before it."""
    from torch.profiler import ProfilerActivity, profile

    from cellularautomatons3d_tpu_torch.render.renderer import RenderHistory
    from _torch_multistate_scene import random_ages
    from _torch_reference_scene import compare

    out = {"launches": {}, "card_vs_cpu": {}, "frame_ms": {}, "frame_reads_ms": {},
           "kernels_per_frame": {}, "device_ms_per_frame": {}, "peak_mib": {},
           "allocated_before_mib": {}, "lit_share": {}, "walls_s": {}}
    # name: (Engine overrides, a dense start state loaded on both devices).
    # amoeba-445 at 64³ is BASELINE config 1's CA step, [3, 2, 64, 64] age
    # planes, from the random ages its run below loads.
    small = {"clustered": ({}, None), "simple": (dict(render_variant="simple"), None),
             "lighting": (dict(LIGHTING), None),
             "pyroclastic": (dict(ct.PRESETS["pyroclastic"], random_initial_state=True), None),
             "amoeba": (dict(ct.PRESETS["amoeba-445"], render_variant="simple"),
                        random_ages(64, 5, 17, p_dead=0.7))}
    for name, (over, dense) in small.items():
        t0 = time.perf_counter()
        runs = []
        for device in ("cuda", "cpu"):
            e = ct.Engine(grid_size=64, width=256, height=128, pipeline="reference",
                          device=device, **over)
            if dense is not None:
                e.set_state_dense(dense)
            e.camera.translate((1, 0, 0), 0.01)
            e.step(12)
            frames = []
            for i in range(4):
                if i >= 2:
                    move_camera(e.camera, i)
                f = e.tick()
                frames.append((f.cpu().numpy(), e.history.color.cpu().numpy(),
                               e.history.depth.cpu().numpy()))
            runs.append((frames, e.state.cpu()))
        (gpu, gstate), (cpu, cstate) = runs
        need(torch.equal(gstate, cstate), f"(k) {name}: Engine state cuda != cpu")
        fr = {"hit": 0.0, "depth": 0.0, "rgb": 0.0}
        for a, b in zip(gpu, cpu):
            try:
                got = compare(a, b, depth=REFERENCE_CARD_MISMATCH, rgb=REFERENCE_CARD_MISMATCH)
            except AssertionError as err:
                raise SmokeFailure(f"(k) {name} cuda vs cpu at 64^3: {err}") from err
            fr = {k: max(fr[k], v) for k, v in got.items()}
        need(int((cpu[-1][0].sum(-1) > 0).sum()) > 100, f"(k) {name}: the 64^3 frame is black")
        out["card_vs_cpu"][name] = fr
        log(f"(k) Engine(pipeline='reference') {name} cuda vs cpu at 64^3 / 256x128, 4 ticks: "
            f"mismatch {fr} ({time.perf_counter() - t0:.1f} s)")

    counted = (ca_step.fires_plane_cuda, ca_step.step_packed_multistate_cuda,
               ca_step.age_masks_cuda, rf.raytrace_cuda, rs.primary_sweep_cuda,
               rs.shadow_sweep_cuda, rs.shadow_sweep_multi_cuda, rs.cell_state_cuda,
               occupancy.occupied_box_cuda)
    ca_kernels = ("fires_plane_cuda", "step_packed_multistate_cuda", "age_masks_cuda")
    for name, (over, gens, static, moved, timed_frames) in reference_configs(ct).items():
        cfg = {"width": WIDTH, "height": HEIGHT, "pipeline": "reference", **over}
        multistate = cfg.get("total_states", 2) > 2
        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        eng = ct.Engine(device="cuda", **cfg)
        eng.camera.translate((1, 0, 0), 0.01)
        eng.step(gens)
        if name == "baseline_config1" and not eng.state_dense().any():
            # The preset dies out from the Engine's seed (a lone centre
            # cell): a seeded random grid of ages, as the CPU tests load.
            eng.set_state_dense(random_ages(64, 5, 17, p_dead=0.7))
            out["baseline_config1_state"] = "random ages (seed 17, 30 % live): died out"
            log("(k) baseline_config1: amoeba-445 dies out from the seed; loaded random ages")
        frames = []
        for i in range(static + moved):
            if i >= static:
                move_camera(eng.camera, i)
            frames.append(eng.tick())
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in counted}
        out["launches"][name] = counts
        out["walls_s"][name] = time.perf_counter() - t0
        need(isinstance(eng.history, RenderHistory), f"(k) {name}: history is not RenderHistory")
        for i, f in enumerate(frames):
            need(tuple(f.shape) == (cfg["height"], cfg["width"], 3),
                 f"(k) {name} frame {i} shape {tuple(f.shape)}")
            need(bool(torch.isfinite(f).all()), f"(k) {name} frame {i} has non-finite values")
        lit = float((frames[-1].sum(-1) > 0).float().mean())
        out["lit_share"][name] = lit
        need(lit > 0.005, f"(k) {name}: {lit:.4f} of the pixels lit")
        need(bool((eng.history.depth[..., 1] == 1).all()), f"(k) {name}: depth target")
        steps = eng.simulation_step
        if multistate:
            need(counts["step_packed_multistate_cuda"] == steps and counts["fires_plane_cuda"] == 0,
                 f"(k) {name}: not one multi-state step a generation ({steps}): {counts}")
            need(counts["age_masks_cuda"] == steps + len(frames),
                 f"(k) {name}: not one age-mask pass a step and a frame: {counts}")
        else:
            need(counts["fires_plane_cuda"] == steps, f"(k) {name}: {steps} steps, {counts}")
        need(all(v == 0 for k, v in counts.items() if k not in ca_kernels),
             f"(k) {name}: the reference frame launched a frame kernel: {counts}")
        # The frame's time, kernels, device time and memory (static camera).
        eng.render()
        torch.cuda.synchronize()
        reads = [timed(torch, eng.render)[1] for _ in range(timed_frames)]
        out["frame_reads_ms"][name] = reads
        out["frame_ms"][name] = float(np.median(reads))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng.render()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        out["kernels_per_frame"][name] = len(ev)
        out["device_ms_per_frame"][name] = sum(e.time_range.elapsed_us() for e in ev) / 1e3
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng.render()
        torch.cuda.synchronize()
        out["allocated_before_mib"][name] = base / 2**20
        out["peak_mib"][name] = (torch.cuda.max_memory_allocated() - base) / 2**20
        log(f"(k) {name}: {cfg['grid_size']}^3 {cfg['width']}x{cfg['height']} "
            f"{eng.config.render_variant}, gen {steps}, {static} static + {moved} moved ticks in "
            f"{out['walls_s'][name]:.1f} s, lit {lit:.3f}; launches "
            f"{ {k: v for k, v in counts.items() if v} }; render() {out['frame_ms'][name]:.2f} ms "
            f"(median of {reads}), {len(ev)} kernels, "
            f"{out['device_ms_per_frame'][name]:.2f} ms device, peak +"
            f"{out['peak_mib'][name]:.0f} MiB over the {out['allocated_before_mib'][name]:.0f} MiB "
            f"allocated before")
        del eng, frames
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- (l) the mesh ---
MESH_SHARDS = 4
MESH_RULES = {"moore": dict(neighbourhood="moore", born="4,5", survive="2-6"),
              "von_neumann": dict(neighbourhood="von neumann", born="1,3", survive="0-6")}
MESH_SLAB_CASES = ((512, None), (512, (2, 2)), (1024, None))   # (grid, mesh_shape)
# name: (Engine overrides, generations, render() calls, run_fused frames)
MESH_ENGINES = {
    "mesh_512": (dict(grid_size=512), 160, 2, 10),
    "mesh_256": (dict(grid_size=GRID), 80, 2, 0),
    "mesh_ms_512": (dict(ct_preset=MS_PRESET, grid_size=512, random_initial_state=True),
                    MS_GENERATIONS[512], 1, 5),
}
MESH_COUNTED = ("fires_slab_cuda", "step_slab_multistate_cuda", "age_masks_cuda",
                "fires_plane_cuda", "step_packed_multistate_cuda", "raytrace_cuda",
                "primary_sweep_cuda", "shadow_sweep_cuda", "occupied_box_cuda")


def mesh_phase(torch, np, ct, rf, rs, ca_step, occupancy, compare) -> dict:
    """Phase (l): the mesh (``Engine(mesh_devices=4)``, ``parallel.sharded``),
    its 4 shards on one card (``mesh_device_list=[cuda:0] * 4``) and, where
    the host has more cards, also on distinct cards.  The slab kernel against
    its plain twin (on the card, on the halos the exchange gives), the
    sharded step against the single-device step, the mesh Engines' launch
    counts (every counter set to 0 just before them and read just after), the
    mesh frames and fused loop against the single-device Engine, each
    band's K1 or K4 + K2 with row0 > 0 against its plain twin, the port's
    ``dryrun_multichip``; then the times (CUDA events): on one card they are
    the cost of the decomposition, not a scaling."""
    from cellularautomatons3d_tpu_torch import engine as engine_mod
    from cellularautomatons3d_tpu_torch.ops import ca_reference
    from cellularautomatons3d_tpu_torch.render import renderer_fast as rfast
    from cellularautomatons3d_tpu_torch.utils.metrics import cuda_time_fn
    from cellularautomatons3d_tpu_torch.utils.profiling import profile_trace
    from cellularautomatons3d_tpu_torch.parallel import (
        dryrun_multichip, exchange_halos, make_mesh, make_sharded_step, shard_state)

    dev = torch.device("cuda", 0)
    one_card = [dev] * MESH_SHARDS
    out = {"slab_cases": 0, "launches": {}, "frames": {}, "bands": {}, "timings": {},
           "bounds": {}}
    fns = {"fires_slab_cuda": ca_step.fires_slab_cuda,
           "step_slab_multistate_cuda": ca_step.step_slab_multistate_cuda,
           "age_masks_cuda": ca_step.age_masks_cuda,
           "fires_plane_cuda": ca_step.fires_plane_cuda,
           "step_packed_multistate_cuda": ca_step.step_packed_multistate_cuda,
           "raytrace_cuda": rf.raytrace_cuda, "primary_sweep_cuda": rs.primary_sweep_cuda,
           "shadow_sweep_cuda": rs.shadow_sweep_cuda,
           "occupied_box_cuda": occupancy.occupied_box_cuda}

    def random_words(size, seed):
        g = torch.Generator(dev).manual_seed(seed)
        return torch.randint(-2**31, 2**31 - 1, (size // 32, size, size), dtype=torch.int32,
                             device=dev, generator=g)

    def ms_planes(size, seed, spec):
        g = torch.Generator(dev).manual_seed(seed)
        ages = torch.randint(1, spec.total_states, (size,) * 3, dtype=torch.uint8, device=dev,
                             generator=g)
        ages[torch.rand((size,) * 3, device=dev, generator=g) < 0.6] = 0
        return ca_reference.dense_to_planes(ages, spec.age_bits)

    def slab_check(state, spec, tag):
        """Every shard's slab kernel against its plain twin, on the card, on
        the halos the exchange gives."""
        alive, zh, yh = exchange_halos(state, spec)
        shards = state.shards.reshape(alive.shape)
        for pos in np.ndindex(alive.shape):
            args = (alive[pos], zh[pos], yh[pos], spec)
            if spec.total_states == 2:
                got, want = ca_step.fires_slab_cuda(*args), ca_step.fires_slab(*args)
            else:
                got = ca_step.step_slab_multistate_cuda(shards[pos], *args)
                want = ca_step.step_slab_multistate(shards[pos], *args)
            need(torch.equal(got, want), f"(l) slab kernel != plain: {tag} shard {pos}")
        out["slab_cases"] += 1

    # The slab kernel against its plain twin, bit for bit.
    t0 = time.perf_counter()
    states = {}
    for size, shape in MESH_SLAB_CASES:
        words = states.setdefault(size, random_words(size, size))
        mesh = make_mesh(MESH_SHARDS, devices=one_card, shape=shape)
        for rname, rule in MESH_RULES.items():
            for boundary in ct.BoundaryMode.ALL:
                spec = ct.AutomatonSpec.from_rule_strings(size, boundary=boundary, **rule)
                slab_check(shard_state(words, mesh), spec,
                           f"{size}^3 {shape or MESH_SHARDS} {rname} {boundary}")
    ms_spec = ct.AutomatonSpec.from_rule_strings(512, **{
        k: v for k, v in ct.PRESETS[MS_PRESET].items()})
    ms_state = ms_planes(512, 5, ms_spec)
    for shape in (None, (2, 2)):
        mesh = make_mesh(MESH_SHARDS, devices=one_card, shape=shape)
        slab_check(shard_state(ms_state, mesh), ms_spec, f"512^3 {MS_PRESET} {shape}")
    log(f"(l) slab kernel == plain twin, bit for bit: {out['slab_cases']} cases "
        f"(Moore and von Neumann x 3 boundary modes at 512^3 as 4 and (2, 2) shards, "
        f"1024^3 as 4; {MS_PRESET} at 512^3) in {time.perf_counter() - t0:.1f} s")

    # The sharded step against the single-device step over 20 generations.
    t0 = time.perf_counter()
    for shape in (None, (2, 2)):
        mesh = make_mesh(MESH_SHARDS, devices=one_card, shape=shape)
        for boundary in ct.BoundaryMode.ALL:
            spec = ct.AutomatonSpec.from_rule_strings(512, boundary=boundary,
                                                      **MESH_RULES["moore"])
            step = make_sharded_step(spec, mesh)
            st = shard_state(states[512], mesh)
            ref = states[512]
            for g in range(20):
                st, ref = step(st), ca_step.fires_plane_cuda(ref, spec)
            need(torch.equal(st.full(), ref),
                 f"(l) sharded step != single-device step: 512^3 {shape} {boundary}")
    log(f"(l) sharded step == single-device step over 20 generations at 512^3, "
        f"4 and (2, 2) shards x 3 boundary modes, in {time.perf_counter() - t0:.1f} s")

    # The main path: mesh Engines with every counter read around them.
    engines = {}
    for name, (over, gens, renders, fused) in MESH_ENGINES.items():
        over = dict(over)
        preset = over.pop("ct_preset", None)
        cfg = dict(width=WIDTH, height=HEIGHT, **(ct.PRESETS[preset] if preset else {}), **over)
        for fn in fns.values():
            fn.launches = 0
        t0 = time.perf_counter()
        em = ct.Engine(device="cuda", mesh_devices=MESH_SHARDS, mesh_device_list=one_card, **cfg)
        em.step(gens)
        frames = [em.render() for _ in range(renders)]
        hist_ids = [em.history.hit_idx.full()]
        if fused:
            frames.append(em.run_fused(fused))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: fns[k].launches for k in MESH_COUNTED}
        out["launches"][name] = counts
        slab = "step_slab_multistate_cuda" if preset else "fires_slab_cuda"
        need(counts[slab] == MESH_SHARDS * (gens + fused),
             f"(l) {name}: one slab launch a shard and generation: {counts}")
        need(counts["fires_plane_cuda"] == 0 and counts["step_packed_multistate_cuda"] == 0,
             f"(l) {name}: the mesh launched the whole-grid step: {counts}")
        frame_kernel = "raytrace_cuda" if cfg["grid_size"] <= GRID else "primary_sweep_cuda"
        need(counts[frame_kernel] == MESH_SHARDS * (renders + fused),
             f"(l) {name}: one frame kernel a shard and frame: {counts}")
        if cfg["grid_size"] > GRID:
            need(counts["shadow_sweep_cuda"] == counts["primary_sweep_cuda"],
                 f"(l) {name}: one hard-shadow K2 per K4: {counts}")
        for i, f in enumerate(frames):
            need(tuple(f.shape) == (HEIGHT, WIDTH, 3) and bool(torch.isfinite(f).all())
                 and float(f.max()) > 0.0, f"(l) {name} frame {i} is not a finite lit frame")
        engines[name] = (em, cfg, gens, renders, fused, frames, hist_ids)
        log(f"(l) {name}: Engine({cfg['grid_size']}, {WIDTH}x{HEIGHT}, 4 shards on {dev}) "
            f"step({gens}), render() x{renders}, run_fused({fused}) in {wall:.2f} s; launches "
            f"{ {k: v for k, v in counts.items() if v} }")

    # The mesh against the single-device Engine on the same calls.
    for name, (em, cfg, gens, renders, fused, frames, hist_ids) in engines.items():
        e1 = ct.Engine(device="cuda", **cfg)
        e1.step(gens)
        want = [e1.render() for _ in range(renders)]
        want_ids = [e1.history.hit_idx]
        if fused:
            want.append(e1.run_fused(fused))
        need(torch.equal(em.state.full(), e1.state),
             f"(l) {name}: mesh state != single-device state")
        need(all(torch.equal(a, b) for a, b in zip(hist_ids, want_ids)),
             f"(l) {name}: mesh hit ids != single-device hit ids")
        errs = []
        for i, (a, b) in enumerate(zip(frames, want)):
            errs.append(float((a - b).abs().max()))
            need(bool(torch.all((a - b).abs() <= RGB_ATOL + RGB_RTOL * b.abs())),
                 f"(l) {name} frame {i}: mesh vs single-device max err {errs[-1]}")
        out["frames"][name] = {"max_abs_err": errs, "hit_share": float(
            (want_ids[0] >= 0).float().mean())}
        log(f"(l) {name}: mesh == single-device (state, ids; rgb max err {errs})")
        del e1

    # Every band with row0 > 0 that a mesh frame launches a kernel on,
    # against the kernel's plain twin on the same band camera: K1 at 256³,
    # K4 and the hard-shadow K2 above it (with ages for the multi-state
    # rule), at the tolerances of phases (a), (f) and (h).
    for name, (em, *_) in engines.items():
        with recorded_frames(engine_mod) as calls:
            em.render()
        bands = [c for c in calls if c["kw"]["row0"] > 0]
        need(len(bands) == MESH_SHARDS - 1, f"(l) {name}: {len(bands)} bands with row0 > 0")
        hits = occluded = 0
        errs = []
        for c in bands:
            s, vol, kw = c["s"], c["packed"], c["kw"]
            n, w, rows, row0 = s.grid_size, s.width, s.height, kw["row0"]
            cam = rfast._cam_vec(c["params"], w, kw["full_height"], row0)
            ages, total_states = kw.get("ages"), kw.get("total_states", 2)
            coarse = occupancy.coarse_occupancy(vol)
            tag = f"(l) {name} rows {row0}-{row0 + rows} of {kw['full_height']}"
            ids = c["new"].hit_idx   # the band's ids in the frame: the camera is the frame's
            if n <= GRID:
                k1 = dict(grid_size=n, width=w, height=rows, ages=ages,
                          total_states=total_states, shadow=s.soft_shadow_samples <= 1)
                got = rf.raytrace_cuda(vol, coarse, cam, **k1)
                want = rf.raytrace(vol, coarse, cam, **k1)
                need(torch.equal(got[2], ids), f"{tag}: not the frame's band")
                errs.append(compare(f"{tag} K1", got, want)[0])
                hits += int((want[2] >= 0).sum())
                continue
            k4 = dict(grid_size=n, width=w, height=rows)
            got = rs.primary_sweep_cuda(vol, coarse, cam, ages, **k4)
            want = rs.primary_sweep(vol, cam, ages, **k4)
            errs.append(float((got[0] - want[0]).abs().max()))
            need(all(torch.equal(a, b) for a, b in zip(got[1:], want[1:])),
                 f"{tag} K4: ids or ages differ from the plain version")
            need(errs[-1] <= DEPTH_ATOL, f"{tag} K4: t error {errs[-1]} > {DEPTH_ATOL}")
            need(torch.equal(got[1], ids), f"{tag}: not the frame's band")
            q, origin, coords, found, _ = rs.hit_geometry(cam, got[1], got[0], **k4)
            queries, _, _ = rs.lighting_queries(cam, q, origin, coords, found, soft_k=1, **k4)
            k2 = rs.stack_occlusion_queries(queries, w, rows)
            k2_kw = dict(grid_size=n, cell_half=rs._cell_half(cam, n))
            flags = rs.shadow_sweep(vol, *k2, **k2_kw)
            need(torch.equal(rs.shadow_sweep_cuda(vol, coarse, *k2, **k2_kw), flags),
                 f"{tag} K2: flags differ from the plain version")
            hits += int((want[1] >= 0).sum())
            occluded += int(flags.sum())
        need(hits > 0, f"(l) {name}: no band with row0 > 0 hits anything")
        need(n <= GRID or occluded > 0, f"(l) {name}: nothing occluded in the bands")
        out["bands"][name] = {"max_abs_err": max(errs), "hits": hits, "occluded": occluded}
        kernels_run = "K1" if n <= GRID else "K4 + K2"
        log(f"(l) {name}: {kernels_run} == plain on the {len(bands)} bands with row0 > 0 "
            f"({hits} hits, {occluded} occluded; max err {max(errs):.3g})")

    line = dryrun_multichip(MESH_SHARDS, devices=one_card)
    out["dryrun"] = line
    out["placement"] = "one card"
    cards = torch.cuda.device_count()
    if cards > 1:
        k = min(cards, MESH_SHARDS)
        out["dryrun_cards"] = dryrun_multichip(k)
        mesh = make_mesh(k)
        spec = ct.AutomatonSpec.from_rule_strings(512, **MESH_RULES["moore"])
        st, ref = shard_state(states[512], mesh), states[512]
        step = make_sharded_step(spec, mesh)
        for _ in range(20):
            st, ref = step(st), ca_step.fires_plane_cuda(ref, spec)
        need(torch.equal(st.full(dev), ref), "(l) sharded step on distinct cards != single")
        out["placement"] = f"one card and {k} distinct cards"
    log(f"(l) ran with the shards on {out['placement']}")

    # Times: CUDA events around back-to-back calls (utils.metrics.cuda_time_fn),
    # and with queued=True the device's time alone (the stream sleeps until
    # every call is enqueued), which events around a host-bound call do not
    # show.
    tm = out["timings"]

    def device_ms(fn):
        return cuda_time_fn(fn, reps=20, warmup=3, queued=True)

    for size in (512, 1024):
        spec = ct.AutomatonSpec.from_rule_strings(size)
        mesh = make_mesh(MESH_SHARDS, devices=one_card)
        st = shard_state(states[size], mesh)
        step = make_sharded_step(spec, mesh)
        words = states[size]
        single = lambda: ca_step.fires_plane_cuda(words, spec)  # noqa: E731
        sharded = lambda: step(st)  # noqa: E731
        reads = [cuda_time_fn(fn, reps=50, warmup=3) for fn in (single, sharded, sharded, single)]
        tm[f"ca_step_single_{size}_ms"] = (reads[0] + reads[3]) / 2
        tm[f"ca_step_sharded_{size}_ms"] = (reads[1] + reads[2]) / 2
        tm[f"ca_step_single_sharded_sharded_single_{size}_ms"] = reads
        tm[f"halo_exchange_{size}_ms"] = cuda_time_fn(lambda: exchange_halos(st, spec),
                                                      reps=50, warmup=3)
        alive, zh, yh = exchange_halos(st, spec)
        slabs = [(alive[p], zh[p], yh[p], spec) for p in np.ndindex(alive.shape)]
        tm[f"ca_step_slab_{size}_ms"] = cuda_time_fn(
            lambda: [ca_step.fires_slab_cuda(*a) for a in slabs], reps=50, warmup=3)
        tm[f"ca_step_slab_{size}_device_ms"] = device_ms(
            lambda: [ca_step.fires_slab_cuda(*a) for a in slabs])
        tm[f"ca_step_single_{size}_device_ms"] = device_ms(single)
        tm[f"ca_step_sharded_{size}_device_ms"] = device_ms(sharded)
        tm[f"halo_exchange_{size}_device_ms"] = device_ms(lambda: exchange_halos(st, spec))
        if size == 512:
            tm["ca_step_slab_plain_ms"] = cuda_time_fn(
                lambda: [ca_step.fires_slab(*a) for a in slabs], reps=5, warmup=1)
        rule = ca_step._rule_arrays(spec)
        values = sum(bin(int(m)).count("1") for m in (*rule[3][:rule[0]], *rule[4][:rule[0]]))
        nw = size**3 // 32
        halo_bytes = sum(t.numel() * 4 for a in slabs for t in a[1])
        key = "ca_step_slab" if size == 512 else f"ca_step_slab_{size}"
        out["bounds"][key] = bound(8 * nw + halo_bytes, nw * (
            int(rule[1][:rule[0]].sum()) * OPS_CA_NEIGHBOUR + values * OPS_CA_RULE_VALUE))
    # The multi-state slab step (the alive planes from the exchange given).
    mesh = make_mesh(MESH_SHARDS, devices=one_card)
    st = shard_state(ms_state, mesh)
    alive, zh, yh = exchange_halos(st, ms_spec)
    shards = st.shards.reshape(alive.shape)
    slabs = [(shards[p], alive[p], zh[p], yh[p], ms_spec) for p in np.ndindex(alive.shape)]
    tm["ca_step_slab_multistate_512_ms"] = cuda_time_fn(
        lambda: [ca_step.step_slab_multistate_cuda(*a) for a in slabs], reps=50, warmup=3)
    tm["ca_step_slab_multistate_512_device_ms"] = device_ms(
        lambda: [ca_step.step_slab_multistate_cuda(*a) for a in slabs])
    tm["ca_step_slab_multistate_plain_ms"] = cuda_time_fn(
        lambda: [ca_step.step_slab_multistate(*a) for a in slabs], reps=5, warmup=1)
    ms_step = make_sharded_step(ms_spec, mesh)
    tm["ms_step_sharded_512_ms"] = cuda_time_fn(lambda: ms_step(st), reps=20, warmup=2)
    tm["ms_step_single_512_ms"] = cuda_time_fn(
        lambda: ca_step.step_packed_multistate_cuda(ms_state, ms_spec), reps=20, warmup=2)
    rule = ca_step._rule_arrays(ms_spec)
    values = sum(bin(int(m)).count("1") for m in (*rule[3][:rule[0]], *rule[4][:rule[0]]))
    nw, bits = 512**3 // 32, ms_spec.age_bits
    halo_bytes = sum(t.numel() * 4 for a in slabs for t in a[2])
    out["bounds"]["ca_step_slab_multistate"] = bound(
        4 * nw * (2 * bits + 1) + halo_bytes,
        nw * (int(rule[1][:rule[0]].sum()) * OPS_CA_NEIGHBOUR + values * OPS_CA_RULE_VALUE
              + bits * OPS_CA_DECAY))
    # Mesh frames and fused frames against the single-device Engine's,
    # alternated single, mesh, mesh, single; then one frame of each traced
    # (utils.profiling.profile_trace): kernels, device ms and the wall.
    for name in ("mesh_512", "mesh_256"):
        em, cfg, gens = engines[name][:3]
        e1 = ct.Engine(device="cuda", **cfg).step(gens)
        reads = [cuda_time_fn(e.render, reps=10, warmup=2) for e in (e1, em, em, e1)]
        tm[f"{name}_render_single_ms"] = (reads[0] + reads[3]) / 2
        tm[f"{name}_render_ms"] = (reads[1] + reads[2]) / 2
        tm[f"{name}_render_single_mesh_mesh_single_ms"] = reads
        reads = [cuda_time_fn(lambda e=e: e.run_fused(10, reset_every=10), reps=1, warmup=0) / 10
                 for e in (e1, em, em, e1)]
        tm[f"{name}_fused_frame_single_ms"] = (reads[0] + reads[3]) / 2
        tm[f"{name}_fused_frame_ms"] = (reads[1] + reads[2]) / 2
        tm[f"{name}_fused_frame_single_mesh_mesh_single_ms"] = reads
        for tag, e in (("single", e1), ("mesh", em)):
            t0 = time.perf_counter()
            with profile_trace() as prof:
                e.render()
            wall = (time.perf_counter() - t0) * 1e3
            ev = [x for x in prof.events() if x.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(x.time_range.elapsed_us() for x in ev) / 1e3
            tm[f"{name}_render_{tag}_profile"] = {"kernels": len(ev), "device_ms": busy,
                                                  "wall_ms": wall}
        del e1
    card = card_line()
    log(f"(l) timings on {card} (CUDA events; the 4 shards share one card, so these are the "
        f"cost of the decomposition, not a scaling):")
    for k, v in tm.items():
        log(f"  {k}: {v}")
    for k, b in out["bounds"].items():
        log(f"  bound {k}: {b['bound_ms']:.4f} ms ({b['bound_by']})")
    out["card"] = card
    return out


# ------------------------------------------------- (m) K1's descent options ---
# The scenes at full width: (name, Engine overrides, generations).
OPTION_SCENES = (
    ("gen-80", {}, 80),
    ("gen-230", {}, 230),
    ("pyroclastic gen-160", dict(random_initial_state=True), 160),
)
# K1's modes: (name, raytrace_cuda options; "mip1" is replaced by the plane mip).
K1_MODES = {
    "default": {},
    "mip1": dict(mip1=True),
    "slicegate": dict(slicegate=True),
    "mip1_prepass": dict(mip1=True, prepass=True),
    "slicegate_prepass": dict(slicegate=True, prepass=True),
    "noskip": dict(column_skip=False),
}
K1_OPTION_VARIABLES = {"mip1": "CA3D_MIP1", "slicegate": "CA3D_SLICEGATE"}


def k1_registers(log_text) -> dict:
    """ptxas's registers and spill bytes of each K1 instantiation,
    ``render_kernel<COMPOSE, MASK, NO_SWEEP, OPT>``, from the build log."""
    import re

    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?( for|$)",
                      line)
        if m:
            k = re.search(r"render_kernelILb(\d)ELi(\d)ELb(\d)ELi(\d)E", m.group(1))
            name = "render_kernel<%s,%s,%s,%s>" % k.groups() if k else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(name, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def options_phase(torch, np, ct, rf, ca_step, occupancy, scene_cam, views, compare) -> dict:
    """Phase (m): K1's descent options at full width, 256³ / 1920×1080 on the
    gen-80, gen-230 and ``pyroclastic`` gen-160 scenes of ``Engine(256)``:
    every mode (mip1, slicegate, each with the prepass, and the column skip
    off) in both modes of K1 bit for bit against the default kernel and within
    the contract of its plain twin; ``Engine.run_fused(10, reset_every=10)``
    under ``CA3D_MIP1=1`` and ``CA3D_SLICEGATE=1`` against the default Engine,
    every counter set to 0 just before each and read just after; the column
    skip's attribution run; then the times of each mode alternated with the
    default (default, mode, mode, default; CUDA events and the device's
    time); the plane mip's kernel against its plain twin ``plane_occupancy``,
    bit for bit, on every scene and on random volumes at 32³ to 1024³, and
    both timed.  (No torch.profiler trace here: a trace this early makes phase
    (g)'s later one drop kernel events.)"""
    from cellularautomatons3d_tpu_torch.ops.occupancy import (
        plane_occupancy, plane_occupancy_cuda)
    from cellularautomatons3d_tpu_torch.utils.metrics import cuda_time_fn

    dev = torch.device("cuda", 0)
    out = {"checks": {}, "launches": {}, "errors": {}, "timings": {}, "plain_ms": {}}
    counters = ("launches", "compose_launches", "prepass_launches", "mip1_launches",
                "slicegate_launches", "noskip_launches")

    def reset():
        for c in counters:
            setattr(rf.raytrace_cuda, c, 0)
        ca_step.fires_plane_cuda.launches = 0
        plane_occupancy_cuda.launches = 0

    def read():
        counts = {c: getattr(rf.raytrace_cuda, c) for c in counters}
        counts["plane_occupancy_cuda"] = plane_occupancy_cuda.launches
        return counts

    # The plane mip's kernel against its plain twin on random volumes (two
    # x-groups, the last partial, at 320³; four at 1024³).
    g = torch.Generator(dev).manual_seed(13)
    for size in (32, 96, 256, 320, 1024):
        for p_live in (0.0, 0.0005, 0.05, 1.0):
            shape = (size // 32, size, size)
            if p_live == 1.0:
                words = torch.full(shape, -1, dtype=torch.int32, device=dev)
            else:
                words = torch.zeros(shape, dtype=torch.int32, device=dev)
                for b in range(32):  # bit b of every word, live with p_live
                    live = torch.rand(shape, device=dev, generator=g) < p_live
                    words |= live.to(torch.int32) << b
            got, want = plane_occupancy_cuda(words), plane_occupancy(words)
            need(torch.equal(got, want), f"(m) plane_occupancy kernel != plain at {size}^3 "
                 f"density {p_live}")
            del words
    log("(m) the plane mip's kernel == plane_occupancy, bit for bit, at 32^3 to 1024^3")

    scenes = {}
    t0 = time.perf_counter()
    for name, overrides, steps in OPTION_SCENES:
        preset = ct.PRESETS["pyroclastic"] if "pyroclastic" in name else {}
        eng = ct.Engine(grid_size=GRID, width=WIDTH, height=HEIGHT, device="cuda",
                        **preset, **overrides)
        eng.step(steps)
        vis = ca_step.visibility_plane(eng.state, eng.spec)
        ages = eng.state if eng.spec.total_states > 2 else None
        scenes[name] = (vis, ages, eng.spec.total_states)
    cam = scene_cam(views["front"], WIDTH, HEIGHT)
    kw0 = dict(grid_size=GRID, width=WIDTH, height=HEIGHT, shadow=True)
    timed = {}
    for name, (vis, ages, states) in scenes.items():
        coarse, plane = occupancy.coarse_occupancy(vis), plane_occupancy(vis)
        need(torch.equal(plane_occupancy_cuda(vis), plane),
             f"(m) plane_occupancy kernel != plain on {name}")
        kw = dict(kw0, ages=ages, total_states=states)
        base = rf.raytrace_cuda(vis, coarse, cam, **kw)
        keep = torch.rand(base[2].shape, device=dev,
                          generator=torch.Generator(dev).manual_seed(7)) < 0.7
        hist = (torch.clamp(base[0] * 1.5 + 0.02, 0.0, 1.0).contiguous(),
                torch.where(keep, base[2], base[2] + 1).contiguous())
        mask = rf.prepass_mask(coarse, cam, grid_size=GRID, width=WIDTH, height=HEIGHT)
        plain = {}
        for history in (None, hist):
            mode_tag = "compose" if history is not None else "non-compose"
            ref = rf.raytrace_cuda(vis, coarse, cam, history, **kw)
            for mode, options in K1_MODES.items():
                if mode == "default":
                    continue
                opts = dict(options)
                if opts.pop("mip1", False):
                    opts["mip1"] = plane
                got = rf.raytrace_cuda(vis, coarse, cam, history, **opts, **kw)
                torch.cuda.synchronize()
                equal = all(torch.equal(a, b) for a, b in zip(got, ref))
                # The plain twin: with the plane mip for mip1, with the plain
                # prepass masks for the prepass modes.
                key = (history is not None, "mip1" in opts, bool(opts.get("prepass")))
                if key not in plain:
                    t1 = time.perf_counter()
                    plain[key] = rf.raytrace(vis, None, cam, history,
                                             colmask=mask if key[2] else None,
                                             mip1=plane if key[1] else None, **kw)
                    torch.cuda.synchronize()
                    out["plain_ms"][f"{name} {mode_tag} {key}"] = (time.perf_counter() - t1) * 1e3
                err, frac = compare(f"(m) {name} {mode_tag} {mode} vs plain", got, plain[key])
                need(equal, f"(m) {name} {mode_tag}: K1 {mode} != the default kernel")
                out["checks"][f"{name} {mode_tag} {mode}"] = dict(bit_equal=equal, err=err,
                                                                  id_mismatch=frac)
                out["errors"][mode] = max(out["errors"].get(mode, 0.0), err)
        timed[name] = (vis, coarse, plane, hist, kw)
    log(f"(m) K1's modes == the default kernel, bit for bit, on {len(scenes)} scenes x 2 modes "
        f"({time.perf_counter() - t0:.1f} s)")

    # The Engine under each variable against the default Engine: the fused
    # loop of 10 frames from gen-80, every counter set to 0 just before each
    # run and read just after.
    runs = {}
    for variable in (None, *K1_OPTION_VARIABLES.values()):
        with contextlib.ExitStack() as stack:
            if variable is not None:
                stack.enter_context(env_var(variable, "1"))
            eng = ct.Engine(grid_size=GRID, width=WIDTH, height=HEIGHT, device="cuda").step(80)
            torch.cuda.synchronize()
            reset()
            frame = eng.run_fused(10, reset_every=10)
            torch.cuda.synchronize()
            counts = read()
            counts["ca_step"] = ca_step.fires_plane_cuda.launches
        runs[variable or "default"] = (frame, eng.history.color, eng.history.hit_idx, eng.state)
        out["launches"][variable or "default"] = counts
        log(f"  Engine run_fused(10, reset_every=10) under {variable or 'no variable'}: "
            f"launches {counts}")
    for variable in K1_OPTION_VARIABLES.values():
        need(all(torch.equal(a, b) for a, b in zip(runs[variable], runs["default"])),
             f"(m) the Engine's fused frames under {variable} != without it")
    need(out["launches"]["default"]["launches"] == 10 and
         out["launches"]["default"]["mip1_launches"] == 0 and
         out["launches"]["default"]["slicegate_launches"] == 0,
         f"(m) the default Engine's K1 launches: {out['launches']['default']}")
    for mode, variable in K1_OPTION_VARIABLES.items():
        c = out["launches"][variable]
        need(c["launches"] == 10 and c[f"{mode}_launches"] == 10 and c["compose_launches"] == 10,
             f"(m) under {variable} the fused loop did not run K1's {mode} mode: {c}")
        need(c["plane_occupancy_cuda"] == (10 if mode == "mip1" else 0),
             f"(m) under {variable}: plane mip launches {c}")
    # The column skip's attribution run: K1 without it, composing 10 frames of
    # the gen-80 scene, as a timing split would.
    vis, coarse, plane, hist, kw = timed["gen-80"]
    reset()
    for _ in range(10):
        rf.raytrace_cuda(vis, coarse, cam, hist, column_skip=False, **kw)
    torch.cuda.synchronize()
    out["launches"]["column_skip_off"] = read()
    need(out["launches"]["column_skip_off"]["noskip_launches"] == 10,
         f"(m) the attribution run missed K1's noskip mode: {out['launches']['column_skip_off']}")
    log(f"  the column skip's attribution run: {out['launches']['column_skip_off']}")

    # Times, compose mode: each mode alternated with the default (default,
    # mode, mode, default), CUDA events and the device's time.
    tm = out["timings"]
    for name, (vis, coarse, plane, hist, kw) in timed.items():
        calls = {}
        for mode, options in K1_MODES.items():
            opts = dict(options)
            if opts.pop("mip1", False):
                opts["mip1"] = plane
            calls[mode] = (lambda o=opts: rf.raytrace_cuda(vis, coarse, cam, hist, **o, **kw))
        for mode in K1_MODES:
            if mode == "default":
                continue
            for label, queued in (("events", False), ("device", True)):
                reads = [cuda_time_fn(calls[m], reps=50, warmup=3, queued=queued)
                         for m in ("default", mode, mode, "default")]
                tm[f"k1_{mode}_{name}_{label}_reads_ms"] = reads
                tm[f"k1_{mode}_{name}_{label}_ms"] = (reads[1] + reads[2]) / 2
                tm[f"k1_default_vs_{mode}_{name}_{label}_ms"] = (reads[0] + reads[3]) / 2
        # The plane mip: the kernel alternated with its plain twin (50 calls:
        # queued, the twin's ~600 launches must fit the stream's queue while
        # it sleeps; 200 calls could not be enqueued).
        calls = {"kernel": lambda: plane_occupancy_cuda(vis), "plain": lambda: plane_occupancy(vis)}
        for label, queued in (("events", False), ("device", True)):
            reads = [cuda_time_fn(calls[m], reps=50, warmup=5, queued=queued)
                     for m in ("plain", "kernel", "kernel", "plain")]
            tm[f"plane_occupancy_{name}_{label}_reads_ms"] = reads
            tm[f"plane_occupancy_{name}_{label}_ms"] = (reads[1] + reads[2]) / 2
            tm[f"plane_occupancy_plain_{name}_{label}_ms"] = (reads[0] + reads[3]) / 2
    for k, v in tm.items():
        log(f"  {k}: {v}")
    return out


# ------------------------------------------------ (n) the attribution tools ---
# Each tool's short form, run in one child process: (module, argv).  A
# torch.profiler trace in this process would make later phases' traces drop
# kernel events (phase (g)'s trace did after one in (m)), so the tools trace in
# a process of their own.
TOOL_RUNS = (
    ("profile_trace", ["--mode", "headline", "--frames", "5", "--reps", "3"]),
    ("profile_trace", ["--mode", "multistate", "--grid", "1024", "--frames", "3", "--reps", "3"]),
    ("profile_trace", ["--mode", "moved", "--frames", "5", "--reps", "3"]),
    ("trace_summary", ["headline_256", "--frames", "5"]),
    ("profile_gi", ["--reps", "3", "--calls", "2"]),
    ("profile_frame", ["--reps", "3", "--calls", "5"]),
    ("bench_dense", ["230", "5", "--reps", "3"]),
    ("bench_scale", ["--frames", "3", "--reps", "3"]),
    ("bench_512_ablate", ["3", "--reps", "3", "--calls", "10"]),
)
TOOLS_TIMEOUT_S = 420


def not_positive(rec: dict, keys) -> list[str]:
    """The keys of ``keys`` whose values in ``rec`` are missing, or numbers
    that are not finite and positive."""
    import math

    return [k for k in keys if not isinstance(rec.get(k), (int, float))
            or isinstance(rec.get(k), bool) or not (math.isfinite(rec[k]) and rec[k] > 0)]


def tools_child() -> None:
    """The child of phase (n): each tool's short form in turn, in this
    process, its traces under build/traces/chip_smoke/; prints the tools'
    JSON lines and, after each tool, ``{"tool_done": name, "s": wall}``."""
    import importlib

    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    sys.path.insert(0, str(HERE))
    traces = HERE / "build" / "traces" / "chip_smoke"
    for name, argv in TOOL_RUNS:
        mod = importlib.import_module(f"cellularautomatons3d_tpu_torch.tools.{name}")
        if name == "profile_trace":
            argv = argv + ["--out", str(traces / argv[1])]
        elif name == "trace_summary":
            argv = [str(traces / "headline" / "trace.json"), *argv[1:]]
        elif name == "profile_gi":
            argv = argv + ["--out", str(traces / "profile_gi")]
        t0 = time.perf_counter()
        mod.main(argv)
        print(json.dumps({"tool_done": name, "s": time.perf_counter() - t0}), flush=True)


def tools_phase(torch, np, rs, sliced, noskip) -> dict:
    """Phase (n): K4 and K2 without the column skip on the 512³ gen-160 and
    1024³ gen-200 frames of (f), bit for bit against the default kernels
    and within the contract of the plain twins (the box-edge volumes were
    held in (i)); their attribution run (10 launches each, every counter
    set to 0 before it) and their times alternated with the defaults'; then
    the tools' short forms in a child process, each line's keys finite and
    positive, and the trace summary's launches per frame equal to the
    launch counters read around the traced frames."""
    from cellularautomatons3d_tpu_torch.utils.metrics import cuda_time_fn

    t_phase = time.perf_counter()
    out = {"checks": dict(noskip), "timings": {}, "launches": {}}
    for size, (vol, coarse, cam, k2) in sliced["timed"].items():
        kw = dict(grid_size=size, width=WIDTH, height=HEIGHT)
        k2kw = dict(grid_size=size, cell_half=rs._cell_half(cam, size))
        t_d, i_d = rs.primary_sweep_cuda(vol, coarse, cam, **kw)
        t_n, i_n = rs.primary_sweep_cuda(vol, coarse, cam, column_skip=False, **kw)
        t_p, i_p = rs.primary_sweep(vol, cam, **kw)
        need(torch.equal(t_n, t_d) and torch.equal(i_n, i_d),
             f"(n) K4 without the column skip != the default at {size}^3")
        err = float((t_n - t_p).abs().max())
        need(torch.equal(i_n, i_p) and err <= DEPTH_ATOL,
             f"(n) K4 without the column skip != plain at {size}^3 (t error {err})")
        o_d = rs.shadow_sweep_cuda(vol, coarse, *k2, **k2kw)
        o_n = rs.shadow_sweep_cuda(vol, coarse, *k2, column_skip=False, **k2kw)
        o_p = rs.shadow_sweep(vol, *k2, **k2kw)
        need(torch.equal(o_n, o_d) and torch.equal(o_n, o_p),
             f"(n) K2 without the column skip != the default or plain at {size}^3")
        out["checks"][f"{size}"] = dict(k4_depth_err=err, hits=int((i_n >= 0).sum()),
                                        k2_occluded=int(o_n.sum()))
        out["k4_max_abs_err"] = max(out.get("k4_max_abs_err", 0.0), err)
        del t_d, i_d, t_n, i_n, t_p, i_p, o_d, o_n, o_p
    log(f"(n) K4 and K2 without the column skip == the default kernels, bit for bit, and "
        f"== plain at 512^3 and 1024^3 and on the box-edge volumes ({noskip})")
    # The attribution run: 10 launches of each, 512³.
    vol, coarse, cam, k2 = sliced["timed"][512]
    kw = dict(grid_size=512, width=WIDTH, height=HEIGHT)
    k2kw = dict(grid_size=512, cell_half=rs._cell_half(cam, 512))
    for f in (rs.primary_sweep_cuda, rs.shadow_sweep_cuda):
        f.launches = f.noskip_launches = 0
    for _ in range(10):
        rs.primary_sweep_cuda(vol, coarse, cam, column_skip=False, **kw)
        rs.shadow_sweep_cuda(vol, coarse, *k2, column_skip=False, **k2kw)
    torch.cuda.synchronize()
    out["launches"] = {f"{f.__name__}.{c}": getattr(f, c)
                       for f in (rs.primary_sweep_cuda, rs.shadow_sweep_cuda)
                       for c in ("launches", "noskip_launches")}
    need(all(v == 10 for v in out["launches"].values()),
         f"(n) the attribution run's launches: {out['launches']}")
    # Times at 512³ and 1024³: default, off, off, default, by events and the
    # device's time.
    tm = out["timings"]
    for size, (vol, coarse, cam, k2) in sliced["timed"].items():
        kw = dict(grid_size=size, width=WIDTH, height=HEIGHT)
        k2kw = dict(grid_size=size, cell_half=rs._cell_half(cam, size))
        calls = {
            "k4": {s: (lambda skip=s == "on": rs.primary_sweep_cuda(
                vol, coarse, cam, column_skip=skip, **kw)) for s in ("on", "off")},
            "k2": {s: (lambda skip=s == "on": rs.shadow_sweep_cuda(
                vol, coarse, *k2, column_skip=skip, **k2kw)) for s in ("on", "off")},
        }
        for name, fns in calls.items():
            for label, queued in (("events", False), ("device", True)):
                reads = [cuda_time_fn(fns[m], reps=50, warmup=3, queued=queued)
                         for m in ("on", "off", "off", "on")]
                tm[f"{name}_{size}_{label}_reads_ms"] = reads
                tm[f"{name}_noskip_{size}_{label}_ms"] = (reads[1] + reads[2]) / 2
                tm[f"{name}_{size}_{label}_ms"] = (reads[0] + reads[3]) / 2
    for k, v in tm.items():
        if not k.endswith("reads_ms"):
            log(f"  {k}: {v:.4f}")

    # The tools, in a child process.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(HERE / "chip_smoke.py"), "--tools"], cwd=HERE,
                          capture_output=True, text=True, timeout=TOOLS_TIMEOUT_S)
    out["tools_s"] = time.perf_counter() - t0
    need(proc.returncode == 0, f"(n) the tools' child failed (exit {proc.returncode}): "
         f"{proc.stderr[-3000:]}")
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    (HERE / "chiprun_out").mkdir(exist_ok=True)
    (HERE / "chiprun_out" / "chip_smoke_tools.jsonl").write_text(
        "".join(json.dumps(x) + "\n" for x in lines))
    done = {x["tool_done"]: x["s"] for x in lines if "tool_done" in x}
    recs = [x for x in lines if "tool" in x]
    need(set(done) == {name for name, _ in TOOL_RUNS}, f"(n) tools that did not finish: "
         f"{sorted({name for name, _ in TOOL_RUNS} - set(done))}")
    import importlib

    card = card_line()
    for rec in recs:
        mod = importlib.import_module(f"cellularautomatons3d_tpu_torch.tools.{rec['tool']}")
        keys = getattr(mod, "KEYS", ("busy_ms", "busy_share", "idle_share", "launches_per_frame"))
        bad = not_positive(rec, keys)
        need(not bad, f"(n) {rec['tool']} {rec.get('mode', rec.get('part', ''))}: keys {bad} "
             f"missing or not finite and positive")
        if rec["tool"] != "trace_summary":
            need(rec.get("card") == card and rec.get("device") == torch.cuda.get_device_name(0),
                 f"(n) {rec['tool']}: card {rec.get('card')!r}, device {rec.get('device')!r}")
    by_mode = {r["mode"]: r for r in recs if r["tool"] == "profile_trace"}
    expect = {  # per frame: kernel family -> launches
        "headline": {"render_kernel": 1, "ca_step_kernel": 1},
        "multistate": {"ca_step_kernel": 1, "age_masks_kernel": 2, "primary_sweep_kernel": 1,
                       "shadow_sweep_kernel": 1, "occupied_box_kernel": 2},
        "moved": {"render_kernel": 1},
    }
    for mode, fams in expect.items():
        rec = by_mode[mode]
        need(rec["launches_match"], f"(n) {mode}: trace launches != counters: {rec['launches']}")
        for fam, n in fams.items():
            got = rec["launches"].get(fam, {})
            need(got.get("trace") == n and got.get("counters") == n,
                 f"(n) {mode}: {fam} launches a frame {got}, expected {n}")
        log(f"  (n) profile_trace {mode}: frame {rec['frame_ms']:.4f} ms, busy "
            f"{rec['busy_ms_per_frame']:.4f} ms a frame, idle {rec['idle_share']:.3f}, "
            f"{rec['launches_per_frame']:.1f} launches a frame; trace == counters "
            f"{rec['launches']}")
    summary = [r for r in recs if r["tool"] == "trace_summary"][0]
    need(abs(summary["busy_ms"] - by_mode["headline"]["busy_ms"]) < 1e-9,
         "(n) trace_summary's busy ms != profile_trace's on the same trace")
    ablate = {r["row"]: r for r in recs if r["tool"] == "bench_512_ablate"}
    need({"frame", "k4_column_skip", "k2_column_skip"} <= set(ablate),
         f"(n) bench_512_ablate rows: {sorted(ablate)}")
    out["tools"] = {name: s for name, s in done.items()}
    out["tool_lines"] = len(recs)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"(n) {len(recs)} tool lines from {len(done)} tools in {out['tools_s']:.1f} s; "
        f"phase (n) {out['wall_s']:.1f} s")
    return out


def main() -> dict:
    import numpy as np
    import torch

    need(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    sys.path.insert(0, str(HERE))
    try:
        import cellularautomatons3d_tpu_torch as ct
    except ImportError as e:
        raise SmokeFailure(f"cannot import the port from {HERE}: {e}") from e
    need(
        Path(ct.__file__).resolve().parent.parent == HERE,
        f"imported {ct.__file__}, not the package beside this script",
    )
    sys.path.insert(1, str(HERE / "tests"))  # the box-edge and query scenes
    from cellularautomatons3d_tpu_torch import kernels
    from cellularautomatons3d_tpu_torch.models.automaton import AutomatonSpec
    from cellularautomatons3d_tpu_torch.ops import ca_step, occupancy
    from cellularautomatons3d_tpu_torch.ops.occupancy import coarse_occupancy, dilate_occupancy
    from cellularautomatons3d_tpu_torch.render import render_fast as rf
    from cellularautomatons3d_tpu_torch.render import render_slab as rs
    from cellularautomatons3d_tpu_torch.utils import mat4
    from cellularautomatons3d_tpu_torch.utils.metrics import cuda_time_fn

    dev = torch.device("cuda", 0)
    report: dict = {"device": torch.cuda.get_device_name(0)}
    log(f"device: {report['device']}  torch {torch.__version__}  cuda {torch.version.cuda}")

    # ---------------------------------------------------------- build ---
    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.library()
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {lib_path.name} in {report['build_s']:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    report["k1_registers"] = k1_registers(lib_path.with_suffix(".log").read_text())
    log(f"  K1 instantiations <COMPOSE, MASK, NO_SWEEP, OPT>: {report['k1_registers']}")
    need(len(report["k1_registers"]) == 18, f"K1 has {len(report['k1_registers'])} instantiations "
         "in the build log, not 18")

    def to_dev(words):
        return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(dev)

    # ------------------------------------------- (a) CA kernel vs plain ---
    n = GRID
    rng = np.random.default_rng(2024)
    seeds = {
        "center": ct.pack_grid(ct.seed_center(n)),
        "random_block": ct.pack_grid(ct.seed_random_block(n, rng=rng)),
        "random_volume": ct.pack_grid((rng.random((n, n, n)) < 0.2).astype(np.uint8)),
    }
    cases = [("center", dict())]
    for seed_name in ("random_block", "random_volume"):
        for neigh in ct.NEIGHBOURHOOD_MAP:
            for boundary in ct.BoundaryMode.ALL:
                cases.append((seed_name, dict(neighbourhood=neigh, boundary=boundary)))
    cases.append(("random_volume", dict(
        born="2", survive="1-3", born_edges="2,5", survive_edges="3-6",
        born_corners="1", survive_corners="2-4",
    )))
    for seed_name, kw in cases:
        spec = AutomatonSpec.from_rule_strings(n, **kw)
        a = to_dev(seeds[seed_name])
        b = a.clone()
        for g in range(20):
            a = ca_step.fires_plane_cuda(a, spec)
            b = ca_step.fires_plane(b, spec)
            need(torch.equal(a, b), f"CA kernel != plain: {seed_name} {kw} generation {g + 1}")
            if seed_name == "center" and g == 0:
                pop = int(np.unpackbits(a.cpu().numpy().view(np.uint8)).sum())
                need(pop == 7, f"population after one step is {pop}, expected 7")
    log(f"(a) CA kernel == plain, bit-exact: {len(cases)} cases x 20 generations at {n}^3")
    report["ca_cases"] = len(cases)
    # The step kernel's tile edges: n = 32 (one word along x, which is its
    # own x-wrap) and n = 96 (three words, three y tiles), Moore and von
    # Neumann, every boundary mode, binary and 10 states, against the plain
    # step and the dense oracle over 5 generations.
    from cellularautomatons3d_tpu_torch.ops import ca_reference
    tile_cases = 0
    for size in (32, 96):
        for neigh in ("moore", "von neumann"):
            for boundary in ct.BoundaryMode.ALL:
                for states in (2, 10):
                    spec_t = AutomatonSpec.from_rule_strings(
                        size, neighbourhood=neigh, born="2,4", survive="1-4",
                        total_states=states, boundary=boundary)
                    g = torch.Generator(dev).manual_seed(size + tile_cases)
                    dense = torch.randint(1, states, (size,) * 3, dtype=torch.uint8,
                                          device=dev, generator=g)
                    dense[torch.rand((size,) * 3, device=dev, generator=g) < 0.6] = 0
                    a = ca_reference.dense_to_planes(dense, spec_t.age_bits)
                    if states == 2:
                        a = a[0]
                    plain = ca_step.fires_plane if states == 2 else ca_step.step_packed_multistate
                    b = a.clone()
                    for gen in range(5):
                        a, b = ca_step.step_packed(a, spec_t), plain(b, spec_t)
                        dense = ca_reference.step_dense(dense, spec_t)
                        got = ca_reference.planes_to_dense(a if states > 2 else a[None])
                        where = f"{size}^3 {neigh} {boundary} {states} states generation {gen + 1}"
                        need(torch.equal(a, b), f"CA kernel != plain: {where}")
                        need(torch.equal(got, dense), f"CA kernel != step_dense: {where}")
                    tile_cases += 1
    log(f"  CA kernel == plain == step_dense at 32^3 and 96^3: {tile_cases} cases x 5 generations")
    report["ca_tile_cases"] = tile_cases

    # ------------------------------------------ (b) K1 kernel vs plain ---
    defaults = ct.EngineConfig()

    def scene_cam(view, w, h, **kw):
        return rf.pack_cam(
            view, w, h, defaults.light.position, defaults.light.magnitude,
            defaults.cell_size, defaults.roughness, defaults.base_reflectivity,
            defaults.material_color, temporal_alpha=defaults.temporal_alpha,
            gamma=defaults.gamma, **kw,
        )

    def grown(size, steps=80):
        spec = AutomatonSpec.from_rule_strings(size)
        st = to_dev(ct.pack_grid(ct.seed_center(size)))
        for _ in range(steps):
            st = ca_step.fires_plane_cuda(st, spec)
        return st

    def compare(tag, got, want):
        idx_k, idx_p = got[2], want[2]
        bad = idx_k != idx_p
        frac = float(bad.float().mean())
        ok = ~bad
        d_err = float((got[1] - want[1])[ok].abs().max())
        rgb_err = float((got[0] - want[0])[ok].abs().max())
        rgb_ok = bool(torch.all(
            (got[0] - want[0]).abs()[ok] <= RGB_ATOL + RGB_RTOL * want[0].abs()[ok]
        ))
        hist = ""
        if len(got) == 4:
            h_ok = bool(torch.all(
                (got[3] - want[3]).abs()[ok] <= RGB_ATOL + RGB_RTOL * want[3].abs()[ok]
            ))
            rgb_ok = rgb_ok and h_ok
            hist = f" hist_err={float((got[3] - want[3])[ok].abs().max()):.3g}"
        hits = float((idx_p >= 0).float().mean())
        log(f"  {tag}: hit {hits:.3f} id_mismatch {frac:.3g} ({int(bad.sum())} px) "
            f"depth_err {d_err:.3g} rgb_err {rgb_err:.3g}{hist}")
        need(frac <= ID_MISMATCH_LIMIT, f"{tag}: id mismatch fraction {frac} > {ID_MISMATCH_LIMIT}")
        need(d_err <= DEPTH_ATOL, f"{tag}: depth error {d_err} > {DEPTH_ATOL}")
        need(rgb_ok, f"{tag}: rgb outside rtol {RGB_RTOL} / atol {RGB_ATOL}")
        return max(d_err, rgb_err), frac

    k1_err, k1_frac = 0.0, 0.0
    views = {
        "front": mat4.initial_view_matrix(),
        "reversed": mat4.translate(
            mat4.rotate(mat4.initial_view_matrix(), (0, 1, 0), np.pi), (0, 0, 1.6)
        ),
        "oblique": mat4.translate(
            mat4.rotate(mat4.initial_view_matrix(), (0, 1, 0), 1.1), (0, 0, 0.2)
        ),
    }
    # (size, width, height, scene, view): the main path's scene (80 steps
    # from the centre seed) and a sparse random volume, whose many partly
    # occupied blocks exercise the kernel's coarse column skip.
    k1_cases = [(64, 128, 64, "grown", v) for v in views]
    k1_cases += [(GRID, WIDTH, HEIGHT, "grown", "front"),
                 (GRID, WIDTH, HEIGHT, "random", "oblique")]
    volumes = {}
    for size, w, h, scene, name in k1_cases:
        if (size, scene) not in volumes:
            vol = grown(size) if scene == "grown" else to_dev(ct.pack_grid(
                (np.random.default_rng(5).random((size,) * 3) < 0.01).astype(np.uint8)))
            volumes[size, scene] = (vol, coarse_occupancy(vol))
        vol, coarse = volumes[size, scene]
        cam = scene_cam(views[name], w, h)
        kw = dict(grid_size=size, width=w, height=h, shadow=True)
        tag = f"{size}^3 {w}x{h} {scene} {name}"
        got = rf.raytrace_cuda(vol, coarse, cam, **kw)
        want = rf.raytrace(vol, coarse, cam, **kw)
        torch.cuda.synchronize()
        e, f = compare(f"{tag} non-compose", got, want)
        k1_err, k1_frac = max(k1_err, e), max(k1_frac, f)
        # Compose against a history that keeps ~70% of the ids.
        keep = torch.rand(want[2].shape, device=dev,
                          generator=torch.Generator(dev).manual_seed(7)) < 0.7
        hist = (
            torch.clamp(want[0] * 1.5 + 0.02, 0.0, 1.0).contiguous(),
            torch.where(keep, want[2], want[2] + 1).contiguous(),
        )
        got = rf.raytrace_cuda(vol, coarse, cam, hist, **kw)
        want = rf.raytrace(vol, coarse, cam, hist, **kw)
        torch.cuda.synchronize()
        e, f = compare(f"{tag} compose", got, want)
        k1_err, k1_frac = max(k1_err, e), max(k1_frac, f)
        if (size, scene, name) == (GRID, "grown", "front"):
            timed_k1 = (vol, coarse, cam, hist, kw)
    report["k1_max_abs_err"] = k1_err
    report["k1_id_mismatch"] = k1_frac
    # K1 with no_sweep (the timing split's floor) is the kernel's frame of an
    # empty volume, bit for bit, and the plain K1's within the contract.
    vol, coarse, cam, hist, kw = timed_k1
    empty = torch.zeros_like(vol)
    got = rf.raytrace_cuda(vol, coarse, cam, hist, no_sweep=True, **kw)
    same = rf.raytrace_cuda(empty, coarse_occupancy(empty), cam, hist, **kw)
    need(all(torch.equal(x, y) for x, y in zip(got, same)),
         "K1 no_sweep != K1 on an empty volume")
    compare("K1 no_sweep vs plain K1 on an empty volume", got,
            rf.raytrace(empty, None, cam, hist, **kw))
    need(bool((got[2] == -1).all()), "K1 no_sweep hit a cell")
    del empty, got, same

    # The whole slice on the card against the plain path on the CPU.
    small = dict(grid_size=64, width=256, height=128)
    engines = [ct.Engine(device=d, **small) for d in ("cuda", "cpu")]
    frames = []
    for eng in engines:
        eng.step(30)
        eng.render()
        fr = [eng.render(), eng.run_fused(5, reset_every=2)]
        frames.append([f.cpu() for f in fr] + [eng.history.hit_idx.cpu(), eng.state.cpu()])
    gpu, cpu = frames
    need(torch.equal(gpu[3], cpu[3]), "Engine state on cuda != on cpu")
    id_frac = float((gpu[2] != cpu[2]).float().mean())
    need(id_frac <= ID_MISMATCH_LIMIT, f"Engine history ids cuda vs cpu mismatch {id_frac}")
    for a, b in zip(gpu[:2], cpu[:2]):
        need(bool(torch.all((a - b).abs() <= RGB_ATOL + RGB_RTOL * b.abs())),
             f"Engine frame cuda vs cpu: max err {float((a - b).abs().max())}")
    log(f"(b) K1 kernel == plain within contract (max abs err {k1_err:.3g}, "
        f"id mismatch {k1_frac:.3g}); Engine cuda == cpu at 64^3 (id mismatch {id_frac:.3g})")

    # -------------------------------------- (c) the main path, real size ---
    ca_step.fires_plane_cuda.launches = 0
    rf.raytrace_cuda.launches = 0
    t0 = time.perf_counter()
    eng = ct.Engine(grid_size=GRID, width=WIDTH, height=HEIGHT, device="cuda")
    eng.step(80)
    f1 = eng.render()
    f2 = eng.render()
    f3 = eng.run_fused(150, reset_every=10)
    torch.cuda.synchronize()
    launches = {
        "ca_step": ca_step.fires_plane_cuda.launches,
        "render_fast": rf.raytrace_cuda.launches,
    }
    main_s = time.perf_counter() - t0
    for i, f in enumerate((f1, f2, f3)):
        need(tuple(f.shape) == (HEIGHT, WIDTH, 3), f"frame {i} shape {tuple(f.shape)}")
        need(bool(torch.isfinite(f).all()), f"frame {i} has non-finite values")
        need(float(f.max()) > 0.0, f"frame {i} is black")
    need(launches["ca_step"] > 0 and launches["render_fast"] > 0,
         f"main path missed a kernel: {launches}")
    # The 80-step state against the plain step on the same device.
    spec = eng.spec
    ref = to_dev(ct.pack_grid(ct.seed_center(GRID)))
    for _ in range(80):
        ref = ca_step.fires_plane(ref, spec)
    eng80 = ct.Engine(grid_size=GRID, width=WIDTH, height=HEIGHT, device="cuda").step(80)
    need(torch.equal(eng80.state, ref), "Engine state after 80 steps != plain steps")
    hits = float((eng.history.hit_idx >= 0).float().mean())
    log(f"(c) main path: step(80), render() x2, run_fused(150, reset_every=10) "
        f"in {main_s:.2f} s; launches {launches}; hit fraction {hits:.3f}")
    report["launches"] = launches

    # ------------------------------------------- (m) K1's descent options ---
    options = options_phase(torch, np, ct, rf, ca_step, occupancy, scene_cam, views, compare)
    report["k1_options"] = options

    # --------------------------------- (e) extended lighting: K2 and K3 ---
    def lighting_operands(size, w, h, steps=80, vol=None):
        """The occlusion queries and GI lookups of a full-quality frame, as
        the port builds them: 4 soft-shadow samples + 4 GI slots, 4 GI
        lookups; of the centre seed after ``steps`` generations, or of
        ``vol``.  Returns (vol, coarse, cam, geo, K2's stacked operands, the
        plain K3's stacked operands, the queries, the lookups)."""
        vol = grown(size, steps) if vol is None else vol
        coarse = coarse_occupancy(vol)
        cam = scene_cam(views["front"], w, h, light_radius=LIGHTING["light_radius"],
                        elapsed_time=0.37)
        if size <= GRID:
            _, depth, idx = rf.raytrace_cuda(vol, coarse, cam, grid_size=size,
                                             width=w, height=h, shadow=False)
        else:
            depth, idx = rs.primary_sweep_cuda(vol, coarse, cam, grid_size=size,
                                               width=w, height=h)
        q, origin, coords, found, _ = rs.hit_geometry(
            cam, idx, depth, grid_size=size, width=w, height=h)
        queries, slots, _ = rs.lighting_queries(
            cam, q, origin, coords, found, grid_size=size, width=w, height=h,
            soft_k=LIGHTING["soft_shadow_samples"], gi=True)
        lookups = [(sl[0], sl[3]) for sl in slots]
        k2 = rs.stack_occlusion_queries(queries, w, h)
        k3 = rs.stack_cell_queries(lookups, w, h)
        return vol, coarse, cam, (q, origin, coords, found), k2, k3, queries, lookups

    for size, w, h in ((64, 128, 64), (GRID, WIDTH, HEIGHT)):
        vol, coarse, cam, geo, k2, k3, _, lookups = lighting_operands(size, w, h)
        kw = dict(grid_size=size, cell_half=rs._cell_half(cam, size))
        got = rs.shadow_sweep_cuda(vol, coarse, *k2, **kw)
        want = rs.shadow_sweep(vol, *k2, **kw)
        got3 = rs.cell_state_cuda(vol, *zip(*lookups), grid_size=size)
        want3 = rs.cell_state(vol, *k3, grid_size=size)
        torch.cuda.synchronize()
        k2_bad, k3_bad = int((got != want).sum()), int((got3 != want3).sum())
        log(f"  {size}^3 {w}x{h}: K2 {k2[0].shape[0]} queries, "
            f"{int(k2[3].sum())} active, {int(want.sum())} occluded, {k2_bad} differ; "
            f"K3 {k3[0].shape[0]} queries, {int(k3[1].sum())} active, "
            f"{int(want3.sum())} live, {k3_bad} differ")
        need(k2_bad == 0, f"K2 kernel != plain at {size}^3: {k2_bad} flags differ")
        need(k3_bad == 0, f"K3 kernel != plain at {size}^3: {k3_bad} states differ")
        need(int(want.sum()) > 0 and int(want3.sum()) > 0,
             f"{size}^3: the lighting queries never occlude or find a live cell")
    timed_k23 = (vol, coarse, cam, geo, k2, k3, lookups, kw)

    # The Engine on the card against the Engine on the CPU.
    small = dict(grid_size=64, width=128, height=64, **LIGHTING)
    engine_frames = {"full_quality": 2, "gi_temporal": 4, "two_bounces": 2}
    for name, variant in LIGHTING_VARIANTS.items():
        t0 = time.perf_counter()
        out = []
        for d in ("cuda", "cpu"):
            e_small = ct.Engine(device=d, **small, **variant)
            e_small.step(30)
            fr = [e_small.render() for _ in range(engine_frames[name])]
            fr.append(e_small.run_fused(2, reset_every=1))
            out.append(([f.cpu() for f in fr], e_small.history.hit_idx.cpu()))
        (gpu, gidx), (cpu, cidx) = out
        need(torch.equal(gidx, cidx), f"{name}: Engine ids cuda != cpu")
        for a, b in zip(gpu, cpu):
            need(bool(torch.all((a - b).abs() <= RGB_ATOL + RGB_RTOL * b.abs())),
                 f"{name}: Engine frame cuda vs cpu: max err {float((a - b).abs().max())}")
        log(f"  Engine {name} cuda == cpu at 64^3 ({len(gpu)} frames, "
            f"{time.perf_counter() - t0:.1f} s)")

    # The three lighting configurations at real size.
    counted = (ca_step.fires_plane_cuda, rf.raytrace_cuda, rs.shadow_sweep_cuda,
               rs.cell_state_cuda, occupancy.occupied_box_cuda)
    lighting_launches, lighting_engines = {}, {}
    for name, variant in LIGHTING_VARIANTS.items():
        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        eng_l = ct.Engine(grid_size=GRID, width=WIDTH, height=HEIGHT, device="cuda",
                          **LIGHTING, **variant)
        eng_l.step(80)
        fr = [eng_l.render(), eng_l.run_fused(50, reset_every=10)]
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in counted}
        for i, f in enumerate(fr):
            need(tuple(f.shape) == (HEIGHT, WIDTH, 3), f"{name} frame {i} shape {tuple(f.shape)}")
            need(bool(torch.isfinite(f).all()), f"{name} frame {i} has non-finite values")
            need(float(f.max()) > 0.0, f"{name} frame {i} is black")
        need(all(v > 0 for v in counts.values()), f"{name} missed a kernel: {counts}")
        need(counts["occupied_box_cuda"] == counts["shadow_sweep_cuda"],
             f"{name}: one box launch per K2 launch: {counts}")
        log(f"(e) {name}: step(80), render(), run_fused(50, reset_every=10) in "
            f"{time.perf_counter() - t0:.2f} s; launches {counts}")
        lighting_launches[name] = counts
        lighting_engines[name] = eng_l
    report["lighting_launches"] = lighting_launches

    # ------------------------------------------- (f) the >256³ path ---
    sliced = sliced_phase(torch, np, ct, rf, rs, ca_step, AutomatonSpec,
                          coarse_occupancy, to_dev, grown, scene_cam, views,
                          lighting_operands)
    report["sliced"] = {k: sliced[k] for k in ("k4_max_abs_err", "plain_ms", "launches")}

    # ------------------------------- (g) K5, K6 and K1's column-mask gate ---
    multi = multi_phase(torch, np, ct, rf, rs, coarse_occupancy, dilate_occupancy, grown,
                        scene_cam, views, lighting_operands, compare, to_dev)
    report["multi"] = {k: multi[k] for k in ("k1_mask_id_mismatch", "k6_launches",
                                             "prepass_launches", "prepass_frame_kernels",
                                             "launches")}

    # ---------------------------------------- (h) the multi-state path ---
    ms = multistate_phase(torch, np, ct, rf, rs, ca_step, AutomatonSpec, coarse_occupancy,
                          scene_cam, views, lighting_operands, compare)
    report["multistate"] = {k: ms[k] for k in ("ms_cases", "k1_max_abs_err", "k1_id_mismatch",
                                               "k4_max_abs_err", "plain_ms", "launches")}

    # ------------------------------------------------ (i) the occupied box ---
    # The whole-box scenes: gen-230 at 256³ (K2) and gen-260 at 512³ (K4),
    # where the structure reaches every face of the volume.
    full_512 = grown(512, 260)
    scenes = {
        f"{GRID}^3 gen-80": (timed_k1[0], timed_k1[1], GRID),
        f"{GRID}^3 gen-230": (multi["k1_timed"][230][0], multi["k1_timed"][230][1], GRID),
        "512^3 gen-160": (*sliced["timed"][512][:2], 512),
        "512^3 gen-260": (full_512, coarse_occupancy(full_512), 512),
        "1024^3 gen-200": (*sliced["timed"][1024][:2], 1024),
    }
    noskip = {}
    boxes = box_phase(torch, np, rs, occupancy, scene_cam, views, to_dev, scenes, noskip)
    for tag in (f"{GRID}^3 gen-230", "512^3 gen-260"):
        need(boxes[tag]["full"] == 1, f"the box of {tag} is not the whole volume: {boxes[tag]}")
    for tag in (f"{GRID}^3 gen-80", "512^3 gen-160", "1024^3 gen-200"):
        need(boxes[tag]["full"] == 0 and boxes[tag]["empty"] == 0,
             f"the box of {tag} clips nothing: {boxes[tag]}")
    report["boxes"] = boxes

    # ----------------------------------------------- (n) the attribution tools ---
    tools = tools_phase(torch, np, rs, sliced, noskip)
    report["tools"] = tools

    # ------------------------------------------- (j) the interactive path ---
    inter = interactive_phase(torch, np, ct, rf, rs, ca_step, occupancy)
    report["interactive"] = {k: inter[k] for k in (
        "launches", "valid_px", "valid_share_of_hits", "walls_s", "small_id_mismatch",
        "checkpoint_ms",
        "frame_png_ms", "have_native", "native_build_error")}

    # ------------------------------------- (k) the reference pipeline ---
    refp = reference_phase(torch, np, ct, rf, rs, ca_step, occupancy)
    report["reference"] = refp

    # ------------------------------------------------------------ (l) the mesh ---
    mesh = mesh_phase(torch, np, ct, rf, rs, ca_step, occupancy, compare)
    report["mesh"] = {k: mesh[k] for k in ("slab_cases", "launches", "frames", "timings",
                                           "placement", "dryrun")}

    # -------------------------------------------------- (d) timings ---
    card = card_line()
    st = eng80.state
    ca_ms = cuda_time_fn(lambda: ca_step.fires_plane_cuda(st, spec), reps=1000, warmup=20)
    ca_plain_ms = cuda_time_fn(lambda: ca_step.fires_plane(st, spec), reps=20, warmup=2)
    vol, coarse, cam, hist, kw = timed_k1
    k1_ms = cuda_time_fn(lambda: rf.raytrace_cuda(vol, coarse, cam, hist, **kw), reps=50, warmup=3)
    k1_nc_ms = cuda_time_fn(lambda: rf.raytrace_cuda(vol, coarse, cam, **kw), reps=50, warmup=3)
    k1_plain_ms = cuda_time_fn(lambda: rf.raytrace(vol, coarse, cam, hist, **kw), reps=3, warmup=1)
    occ_ms = cuda_time_fn(lambda: coarse_occupancy(vol), reps=200, warmup=5)
    eng.run_fused(10, reset_every=10)
    fused_ms = cuda_time_fn(lambda: eng.run_fused(100, reset_every=10), reps=1, warmup=0) / 100
    render_ms = cuda_time_fn(eng.render, reps=20, warmup=2)
    vol, coarse, cam, geo, k2, k3, lookups, kw = timed_k23
    k2_ms = cuda_time_fn(lambda: rs.shadow_sweep_cuda(vol, coarse, *k2, **kw), reps=20, warmup=2)
    k2_plain_ms = cuda_time_fn(lambda: rs.shadow_sweep(vol, *k2, **kw), reps=1, warmup=0)
    k3_ms = cuda_time_fn(lambda: rs.cell_state_cuda(vol, *zip(*lookups), grid_size=GRID),
                         reps=50, warmup=2)
    k3_plain_ms = cuda_time_fn(lambda: rs.cell_state(vol, *k3, grid_size=GRID), reps=10, warmup=1)
    passes_ms = cuda_time_fn(lambda: rs.lighting_passes(
        cam, *geo, rs.prep_volume(vol, coarse), grid_size=GRID, width=WIDTH,
        height=HEIGHT, soft_k=LIGHTING["soft_shadow_samples"], gi=True), reps=5, warmup=1)
    lighting_ms = {
        f"{name}_step_plus_frame_ms": cuda_time_fn(
            lambda e=e: e.run_fused(20, reset_every=10), reps=1, warmup=0) / 20
        for name, e in lighting_engines.items()
    }
    sliced_ms = {
        f"{name}_step_plus_frame_ms": cuda_time_fn(
            lambda e=e, fr=fr: e.run_fused(fr, reset_every=fr), reps=1, warmup=0) / fr
        for name, (e, fr) in sliced["engines"].items()
    }
    for size, (vol, coarse, cam, k2) in sliced["timed"].items():
        kw = dict(grid_size=size, width=WIDTH, height=HEIGHT)
        sliced_ms[f"k4_{size}_ms"] = cuda_time_fn(
            lambda: rs.primary_sweep_cuda(vol, coarse, cam, **kw), reps=20, warmup=2)
        sliced_ms[f"k2_hard_{size}_ms"] = cuda_time_fn(lambda: rs.shadow_sweep_cuda(
            vol, coarse, *k2, grid_size=size, cell_half=rs._cell_half(cam, size)),
            reps=20, warmup=2)
    sliced_ms.update(sliced["plain_ms"])
    # The box kernel alone; the floors of K4 (an empty volume: ray set-up and
    # stores) and of K2 (every lane inactive); K4 and K2 where the box is the
    # whole volume.
    box_ms = {}
    for tag, size in ((f"{GRID}^3 gen-80", GRID), ("512^3 gen-160", 512),
                      ("1024^3 gen-200", 1024)):
        c = scenes[tag][1]
        box_ms[f"occupied_box_{size}_ms"] = cuda_time_fn(
            lambda: occupancy.occupied_box_cuda(c, size), reps=200, warmup=5)
        box_ms[f"occupied_box_{size}_plain_ms"] = cuda_time_fn(
            lambda: occupancy.occupied_box(c, size), reps=5, warmup=1)
    for size in (512, 1024):
        empty = torch.zeros((size // 32, size, size), dtype=torch.int32, device=dev)
        empty_coarse = coarse_occupancy(empty)
        cam = sliced["timed"][size][2]
        box_ms[f"k4_empty_{size}_ms"] = cuda_time_fn(lambda: rs.primary_sweep_cuda(
            empty, empty_coarse, cam, grid_size=size, width=WIDTH, height=HEIGHT),
            reps=50, warmup=3)
        del empty
    vol_f, coarse_f = scenes["512^3 gen-260"][:2]
    cam = sliced["timed"][512][2]
    t4f, i4f = rs.primary_sweep_cuda(vol_f, coarse_f, cam, grid_size=512, width=WIDTH,
                                     height=HEIGHT)
    t4p, i4p = rs.primary_sweep(vol_f, cam, grid_size=512, width=WIDTH, height=HEIGHT)
    need(torch.equal(i4f, i4p) and float((t4f - t4p).abs().max()) <= DEPTH_ATOL,
         "K4 != plain on the 512^3 gen-260 scene")
    box_ms["k4_full_box_512_ms"] = cuda_time_fn(lambda: rs.primary_sweep_cuda(
        vol_f, coarse_f, cam, grid_size=512, width=WIDTH, height=HEIGHT), reps=20, warmup=2)
    vol, coarse, cam, geo, k2, k3, lookups, kw = timed_k23
    idle_ops = (*k2[:3], torch.zeros_like(k2[3]))
    need(int(rs.shadow_sweep_cuda(vol, coarse, *idle_ops, **kw).abs().sum()) == 0,
         "K2 with every lane inactive is not all 0")
    box_ms["k2_idle_ms"] = cuda_time_fn(
        lambda: rs.shadow_sweep_cuda(vol, coarse, *idle_ops, **kw), reps=50, warmup=2)
    vol_230, coarse_230 = scenes[f"{GRID}^3 gen-230"][:2]
    _, _, cam_230, _, k2_230, _, q_230, l_230 = lighting_operands(GRID, WIDTH, HEIGHT,
                                                                  vol=vol_230)
    kw_230 = dict(grid_size=GRID, cell_half=rs._cell_half(cam_230, GRID))
    need(torch.equal(rs.shadow_sweep_cuda(vol_230, coarse_230, *k2_230, **kw_230),
                     rs.shadow_sweep(vol_230, *k2_230, **kw_230)),
         "K2 != plain on the gen-230 scene's 8 queries")
    k5_check(torch, rs, f"{GRID}^3 gen-230 full quality", vol_230, coarse_230, GRID, q_230,
             kw_230["cell_half"])
    k3_check(torch, rs, f"{GRID}^3 gen-230 full quality", vol_230, GRID, l_230)
    box_ms["k2_full_box_ms"] = cuda_time_fn(lambda: rs.shadow_sweep_cuda(
        vol_230, coarse_230, *k2_230, **kw_230), reps=20, warmup=2)
    box_ms["k5_full_box_ms"] = cuda_time_fn(lambda: [rs.shadow_sweep_multi_cuda(
        vol_230, coarse_230, *zip(*q_230[i:i + 4]), **kw_230) for i in (0, 4)], reps=20, warmup=2)
    for size in (512, 1024):
        st_big = sliced["timed"][size][0]
        spec_big = AutomatonSpec.from_rule_strings(size)
        sliced_ms[f"ca_step_{size}_ms"] = cuda_time_fn(
            lambda: ca_step.fires_plane_cuda(st_big, spec_big), reps=50, warmup=3)

    # K5 against K2 on a full-quality frame's 8 queries, alternated K2, K5,
    # K5, K2 (K5 as the dispatch runs it: two launches of 4 queries).
    multi_ms = {}
    for size, (vol, coarse, cam, k2, queries, plain_ms) in multi["k5_timed"].items():
        kw = dict(grid_size=size, cell_half=rs._cell_half(cam, size))

        def run_k2():
            rs.shadow_sweep_cuda(vol, coarse, *k2, **kw)

        def run_k5(queries=queries):
            for i in (0, 4):
                rs.shadow_sweep_multi_cuda(vol, coarse, *zip(*queries[i:i + 4]), **kw)

        reads = [cuda_time_fn(fn, reps=20, warmup=2) for fn in (run_k2, run_k5, run_k5, run_k2)]
        multi_ms[f"k2_{size}_ms"] = (reads[0] + reads[3]) / 2
        multi_ms[f"k5_{size}_ms"] = (reads[1] + reads[2]) / 2
        multi_ms[f"k2_k5_k5_k2_{size}_ms"] = reads
        multi_ms[f"k5_{size}_plain_ms"] = plain_ms
        if size == GRID:
            idle = [(s_, t_, e_, torch.zeros_like(a_)) for s_, t_, e_, a_ in queries]
            multi_ms["k5_idle_ms"] = cuda_time_fn(lambda: run_k5(idle), reps=50, warmup=2)
    # K6 and K1 with and without the prepass mask, alternated, on gen-80
    # and gen-230: K1 alone with a given mask, K1 computing its own masks,
    # and the whole prepass frame.  K6 inside K1 costs the difference of
    # the second and the first.
    for steps, (vol, coarse, cam, hist, mask, kw, k6_plain_ms) in multi["k1_timed"].items():
        if steps == 80:
            multi_ms["k6_ms"] = cuda_time_fn(lambda: rf.prepass_cuda(
                coarse, cam, grid_size=GRID, width=WIDTH, height=HEIGHT), reps=200, warmup=5)
            multi_ms["k6_plain_ms"] = k6_plain_ms
        runs = {
            "k1_compose": lambda: rf.raytrace_cuda(vol, coarse, cam, hist, **kw),
            "k1_compose_masked": lambda: rf.raytrace_cuda(vol, coarse, cam, hist,
                                                          colmask=mask, **kw),
            "k1_compose_inline": lambda: rf.raytrace_cuda(vol, coarse, cam, hist,
                                                          prepass=True, **kw),
            "k1_compose_prepass_frame": lambda: rf.raytrace_tiles(
                vol, coarse, cam, hist, use_prepass=True, **kw),
        }
        order = ["k1_compose", "k1_compose_masked", "k1_compose_inline",
                 "k1_compose_prepass_frame", "k1_compose_prepass_frame",
                 "k1_compose_inline", "k1_compose_masked", "k1_compose"]
        reads = {k: [] for k in runs}
        for k in order:
            reads[k].append(cuda_time_fn(runs[k], reps=50, warmup=3))
        for k, v in reads.items():
            multi_ms[f"{k}_gen{steps}_ms"] = sum(v) / len(v)
            multi_ms[f"{k}_gen{steps}_reads_ms"] = v
        multi_ms[f"k6_inline_gen{steps}_ms"] = (multi_ms[f"k1_compose_inline_gen{steps}_ms"]
                                                - multi_ms[f"k1_compose_masked_gen{steps}_ms"])
        # K1's split in compose mode: no sweep (ray set-up, composition,
        # stores), then the primary sweep (shadow=False), then both sweeps.
        kw0 = dict(kw, shadow=False)
        multi_ms[f"k1_split_gen{steps}_ms"] = {
            "no_sweep": cuda_time_fn(lambda: rf.raytrace_cuda(
                vol, coarse, cam, hist, no_sweep=True, **kw), reps=50, warmup=3),
            "primary": cuda_time_fn(lambda: rf.raytrace_cuda(vol, coarse, cam, hist, **kw0),
                               reps=50, warmup=3),
            "full": cuda_time_fn(lambda: rf.raytrace_cuda(vol, coarse, cam, hist, **kw), reps=50,
                            warmup=3),
        }
    # Full-quality step + frame with K5 against K2 (the same Engine; the
    # variable is read per call), alternated K2, K5, K5, K2.
    eng_fq = lighting_engines["full_quality"]
    reads = []
    for k5 in (False, True, True, False):
        with env_var("CA3D_OCC_SWEEP", "0" if k5 else "1"):
            reads.append(cuda_time_fn(lambda: eng_fq.run_fused(10, reset_every=10),
                                 reps=1, warmup=0) / 10)
    multi_ms["full_quality_step_plus_frame_k2_ms"] = (reads[0] + reads[3]) / 2
    multi_ms["full_quality_step_plus_frame_k5_ms"] = (reads[1] + reads[2]) / 2
    multi_ms["full_quality_step_plus_frame_k2_k5_k5_k2_ms"] = reads
    ms_ms, ms_specs, ms_states = multistate_timings(torch, ct, rf, rs, ca_step, AutomatonSpec, ms)
    inter_ms = interactive_timings(torch, inter)
    timings = {
        "ca_step_ms": ca_ms, "ca_step_plain_ms": ca_plain_ms,
        "k1_compose_ms": k1_ms, "k1_noncompose_ms": k1_nc_ms,
        "k1_plain_compose_ms": k1_plain_ms, "coarse_occupancy_ms": occ_ms,
        "pinned_step_plus_frame_ms": fused_ms, "render_call_ms": render_ms,
        "k2_ms": k2_ms, "k2_plain_ms": k2_plain_ms,
        "k3_ms": k3_ms, "k3_plain_ms": k3_plain_ms,
        "lighting_passes_ms": passes_ms, **lighting_ms, **sliced_ms, **multi_ms, **ms_ms,
        **box_ms, **inter_ms,
    }
    report["timings"] = timings
    report["card"] = card
    log(f"(d) timings on {card} (CUDA events, {WIDTH}x{HEIGHT}; {GRID}^3 unless named):")
    for k, v in timings.items():
        log(f"  {k}: {v}")

    sliced_launches = sliced["launches"]

    def total(fn_name, *runs):
        return sum(r.get(fn_name, 0) for r in runs)

    # Each kernel's bound from this run's inputs at the shapes it was timed.
    dev = torch.device("cuda", 0)
    nw = GRID**3 // 32
    n_groups, lens, _, born, survive = ca_step._rule_arrays(spec)
    rule_values = sum(bin(int(m)).count("1") for m in (*born[:n_groups], *survive[:n_groups]))
    bounds = {"ca_step": bound(8 * nw, nw * (int(lens[:n_groups].sum()) * OPS_CA_NEIGHBOUR
                                             + rule_values * OPS_CA_RULE_VALUE))}
    vol, coarse, cam, hist, kw = timed_k1
    _, depth, idx, _ = rf.raytrace_cuda(vol, coarse, cam, hist, **kw)
    box = occupancy.occupied_box(coarse, GRID)
    act, cols = primary_work(torch, rf, cam, GRID, WIDTH, HEIGHT, depth, idx, dev, box)
    _, dx, dy, dz = rf._pixel_rays(cam, WIDTH, HEIGHT, dev)
    q = torch.stack([dx, dy, dz]) * depth + torch.tensor(
        cam[rf.P_O:rf.P_O + 3], device=dev)[:, None, None]
    light = torch.tensor(cam[rf.P_LIGHT:rf.P_LIGHT + 3], device=dev)[:, None, None]
    _, shadow_ops = occlusion_work(torch, q[None], light.expand_as(q)[None],
                                   (idx >= 0)[None], GRID, 0, box)
    hits, px = int((idx >= 0).sum()), WIDTH * HEIGHT
    bounds["render_fast"] = bound(
        mip_bytes(GRID) + px * 48,
        act * OPS_RAY + cols * OPS_COLUMN + hits * OPS_SHADE + shadow_ops)
    vol, coarse, cam, geo, k2, k3, lookups, kw = timed_k23
    bounds["shadow_sweep"] = bound(*occlusion_work(torch, k2[0], k2[1], k2[3], GRID, 36,
                                                   occupancy.occupied_box(coarse, GRID)))
    bounds["cell_state"] = bound(*lookup_work(lookups))
    for size, b in multi["k3_bounds"].items():
        bounds[f"cell_state_{size}"] = b
    vol, coarse, cam, _ = sliced["timed"][512]
    t4, i4 = rs.primary_sweep_cuda(vol, coarse, cam, grid_size=512, width=WIDTH, height=HEIGHT)
    act, cols = primary_work(torch, rf, cam, 512, WIDTH, HEIGHT, t4, i4, dev,
                             occupancy.occupied_box(coarse, 512))
    bounds["primary_sweep"] = bound(mip_bytes(512) + px * 8, act * OPS_RAY + cols * OPS_COLUMN)
    def k5_work(k2_ops, queries, n, box):
        nbytes, ops = occlusion_work(torch, k2_ops[0], k2_ops[1], k2_ops[3], n, 0, box)
        return nbytes + in_place_bytes(queries), ops

    _, coarse, _, k2_256, q_256, _ = multi["k5_timed"][GRID]
    bounds["shadow_multi"] = bound(*k5_work(k2_256, q_256, GRID,
                                            occupancy.occupied_box(coarse, GRID)))
    bounds["shadow_multi_idle"] = bound(k2_256[3].numel() * 5, 0)
    bounds["shadow_multi_full_box"] = bound(*k5_work(k2_230, q_230, GRID,
                                                     occupancy.occupied_box(coarse_230, GRID)))
    _, _, _, _, mask, _, _ = multi["k1_timed"][80]
    live = int(((mask != 0) & (mask != -1)).sum())
    k6_ops = (mask.numel() * OPS_PATCH + live * (GRID // 8) * OPS_PATCH_COLUMN
              + (GRID // 8)**2 * OPS_DILATE)
    bounds["prepass"] = bound(mip_bytes(GRID) + mask.numel() * 4, k6_ops)
    # Inside K1 the masks stay in shared memory: the mip is the only traffic.
    bounds["prepass_inline"] = bound(mip_bytes(GRID), k6_ops)
    # The same counts at the other sizes PERF.md's kernel table names.
    for size in (512, 1024):
        words = size**3 // 32
        bounds[f"ca_step_{size}"] = bound(8 * words, words / nw * bounds["ca_step"]["ops"])
    vol, coarse, cam, k2_512, q_512, _ = multi["k5_timed"][512]
    box = occupancy.occupied_box(coarse, 512)
    bounds["shadow_sweep_512"] = bound(*occlusion_work(torch, k2_512[0], k2_512[1],
                                                       k2_512[3], 512, 36, box))
    bounds["shadow_multi_512"] = bound(*k5_work(k2_512, q_512, 512, box))
    vol, coarse, cam, _ = sliced["timed"][1024]
    t4, i4 = rs.primary_sweep_cuda(vol, coarse, cam, grid_size=1024, width=WIDTH, height=HEIGHT)
    act, cols = primary_work(torch, rf, cam, 1024, WIDTH, HEIGHT, t4, i4, dev,
                             occupancy.occupied_box(coarse, 1024))
    bounds["primary_sweep_1024"] = bound(mip_bytes(1024) + px * 8,
                                         act * OPS_RAY + cols * OPS_COLUMN)
    bounds.update(multistate_bounds(torch, rf, rs, ca_step, ms, ms_specs, ms_states))
    # K2's hard-shadow query at 512³ and 1024³; the floors; the whole-box
    # scenes; the box kernel (the mip read once, a few operations a word).
    for size in (512, 1024):
        _, coarse, _, hard = sliced["timed"][size]
        bounds[f"shadow_sweep_hard_{size}"] = bound(*occlusion_work(
            torch, hard[0], hard[1], hard[3], size, 36, occupancy.occupied_box(coarse, size)))
        bounds[f"primary_sweep_empty_{size}"] = bound(px * 8, px * OPS_RAY)
    for size in (GRID, 512, 1024):
        bounds[f"occupied_box_{size}"] = bound(mip_bytes(size) + 32, mip_bytes(size) * 2)
    bounds["occupied_box"] = bounds["occupied_box_512"]  # the row of the kernels line
    bounds["shadow_sweep_idle"] = bound(k2[3].numel() * 5, 0)
    bounds["shadow_sweep_full_box"] = bound(*occlusion_work(
        torch, k2_230[0], k2_230[1], k2_230[3], GRID, 36, occupancy.occupied_box(coarse_230, GRID)))
    act, cols = primary_work(torch, rf, sliced["timed"][512][2], 512, WIDTH, HEIGHT, t4f,
                             i4f, dev, occupancy.occupied_box(coarse_f, 512))
    bounds["primary_sweep_full_box_512"] = bound(mip_bytes(512) + px * 8,
                                                 act * OPS_RAY + cols * OPS_COLUMN)
    bounds.update(mesh["bounds"])
    # The plane mip at 256³: the volume read once, the mip written once; an
    # OR a word and a byte test a word and byte.
    bounds["plane_occupancy"] = bound(GRID**3 // 8 + GRID * (GRID // 8) * 4,
                                      GRID**3 // 32 * 5)
    report["bounds"] = bounds

    def entry(name, source, replaces, launches, err, ms, plain, bound_name=None):
        b = bounds[bound_name or name]
        return {"name": name, "route": "cuda",
                "source": f"cellularautomatons3d_tpu_torch/csrc/{source}",
                "replaces": f"cellularautomatons3d_tpu/{replaces}",
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "library_ms": None}  # no single PyTorch call computes any of them

    k5_launches = total("shadow_sweep_multi_cuda", *multi["launches"].values())
    mesh_launches = list(mesh["launches"].values())
    ms_launches = [*ms["launches"].values(), *inter["launches"].values(),
                   *refp["launches"].values(), *mesh_launches]
    report["kernels"] = [
        entry("ca_step", "ca_step.cu", "ops/ca_step.py:118",
              launches["ca_step"] + total("fires_plane_cuda", *sliced_launches.values(),
                                          *inter["launches"].values(),
                                          *refp["launches"].values()),
              0.0, ca_ms, ca_plain_ms),
        entry("ca_step_multistate", "ca_step.cu", "ops/ca_step.py:178",
              total("step_packed_multistate_cuda", *ms_launches), 0.0,
              ms_ms[f"ms_step_{GRID}_ms"], ms_ms["ms_step_plain_ms"]),
        entry("age_masks", "ca_step.cu", "ops/ca_step.py:185",
              total("age_masks_cuda", *ms_launches), 0.0,
              ms_ms[f"age_masks_{GRID}_ms"], ms_ms["age_masks_plain_ms"]),
        entry("render_fast", "render_fast.cu", "render/render_fast.py:1018",
              launches["render_fast"] + total("raytrace_cuda", *ms_launches),
              max(k1_err, ms["k1_max_abs_err"]), k1_ms, k1_plain_ms),
        # K1's opt-in descents (phase (m), gen-80, compose): the launches of
        # the fused loop under CA3D_MIP1 / CA3D_SLICEGATE and of the column
        # skip's attribution run; plain = the twin (with the plane mip for
        # mip1) on the same frame; the bound is K1's, the same work.
        entry("render_fast_mip1", "render_fast.cu", "render/render_fast.py:726",
              options["launches"]["CA3D_MIP1"]["mip1_launches"],
              max(options["errors"]["mip1"], options["errors"]["mip1_prepass"]),
              options["timings"]["k1_mip1_gen-80_events_ms"],
              options["plain_ms"]["gen-80 compose (True, True, False)"], bound_name="render_fast"),
        entry("render_fast_slicegate", "render_fast.cu", "render/render_fast.py:632",
              options["launches"]["CA3D_SLICEGATE"]["slicegate_launches"],
              max(options["errors"]["slicegate"], options["errors"]["slicegate_prepass"]),
              options["timings"]["k1_slicegate_gen-80_events_ms"],
              options["plain_ms"]["gen-80 compose (True, False, False)"], bound_name="render_fast"),
        entry("plane_occupancy", "plane_occupancy.cu", "ops/occupancy.py:72",
              options["launches"]["CA3D_MIP1"]["plane_occupancy_cuda"], 0.0,
              options["timings"]["plane_occupancy_gen-80_events_ms"],
              options["timings"]["plane_occupancy_plain_gen-80_events_ms"]),
        entry("render_fast_noskip", "render_fast.cu", "render/render_fast.py:1420",
              options["launches"]["column_skip_off"]["noskip_launches"],
              options["errors"]["noskip"], options["timings"]["k1_noskip_gen-80_events_ms"],
              options["plain_ms"]["gen-80 compose (True, False, False)"], bound_name="render_fast"),
        entry("shadow_sweep", "shadow_sweep.cu", "render/render_slab.py:354",
              total("shadow_sweep_cuda", *lighting_launches.values(),
                    *sliced_launches.values(), *ms_launches),
              0.0, k2_ms, k2_plain_ms),
        entry("cell_state", "cell_state.cu", "render/render_slab.py:687",
              total("cell_state_cuda", *lighting_launches.values(),
                    *sliced_launches.values(), *ms_launches),
              0.0, k3_ms, k3_plain_ms),
        entry("primary_sweep", "primary_sweep.cu", "render/render_slab.py:279",
              total("primary_sweep_cuda", *sliced_launches.values(), *ms_launches),
              max(sliced["k4_max_abs_err"], ms["k4_max_abs_err"]),
              sliced_ms["k4_512_ms"], sliced_ms["k4_512_plain_ms"]),
        # K4 and K2 without the coarse column skip (phase (n)'s attribution
        # run at 512³; no frame path launches them): plain = the twin, which
        # has no skip; the bound is the default kernel's, the same work.
        entry("primary_sweep_noskip", "primary_sweep.cu", "render/render_slab.py:279",
              tools["launches"]["primary_sweep_cuda.noskip_launches"], tools["k4_max_abs_err"],
              tools["timings"]["k4_noskip_512_events_ms"], sliced_ms["k4_512_plain_ms"],
              bound_name="primary_sweep"),
        entry("shadow_sweep_noskip", "shadow_sweep.cu", "render/render_slab.py:354",
              tools["launches"]["shadow_sweep_cuda.noskip_launches"], 0.0,
              tools["timings"]["k2_noskip_512_events_ms"], sliced_ms["k2_hard_512_plain_ms"],
              bound_name="shadow_sweep_hard_512"),
        entry("occupied_box", "occupied_box.cu", "render/render_fast.py:1514",
              total("occupied_box_cuda", *lighting_launches.values(),
                    *sliced_launches.values(), *ms_launches),
              0.0, box_ms["occupied_box_512_ms"], box_ms["occupied_box_512_plain_ms"]),
        entry("shadow_multi", "shadow_multi.cu", "render/render_slab.py:402", k5_launches,
              0.0, multi_ms[f"k5_{GRID}_ms"], multi_ms[f"k5_{GRID}_plain_ms"]),
        # K6 alone (prepass.cu, through prepass_mask), and K6 inside K1 on
        # the prepass frame (prepass.cuh's device function, K1's kMaskInline
        # form): its ms is K1 with its own masks less K1 given them.
        entry("prepass", "prepass.cu", "render/render_fast.py:889", multi["k6_launches"],
              0.0, multi_ms["k6_ms"], multi_ms["k6_plain_ms"]),
        entry("prepass_inline", "render_fast.cu", "render/render_fast.py:889",
              multi["prepass_launches"]["raytrace_cuda_prepass"], 0.0,
              multi_ms["k6_inline_gen80_ms"], multi_ms["k6_plain_ms"]),
        # The slab mode of the step kernel: one generation of the 512³ grid as
        # 4 z shards (4 launches on the exchange's halos), binary and
        # pyroclastic; the XLA of _local_step_binary / _multistate in JAX.
        entry("ca_step_slab", "ca_step.cu", "parallel/sharded.py:175",
              total("fires_slab_cuda", *mesh_launches), 0.0,
              mesh["timings"]["ca_step_slab_512_ms"], mesh["timings"]["ca_step_slab_plain_ms"]),
        entry("ca_step_slab_multistate", "ca_step.cu", "parallel/sharded.py:180",
              total("step_slab_multistate_cuda", *mesh_launches), 0.0,
              mesh["timings"]["ca_step_slab_multistate_512_ms"],
              mesh["timings"]["ca_step_slab_multistate_plain_ms"]),
    ]
    need("jax" not in {m.split(".")[0] for m, v in sys.modules.items() if v is not None},
         "JAX was imported")
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    if sys.argv[1:] == ["--tools"]:  # phase (n)'s child process
        try:
            tools_child()
        except SmokeFailure as e:
            print(f"chip_smoke --tools FAILED: {e}", file=sys.stderr, flush=True)
            sys.exit(1)
        sys.exit(0)
    try:
        rep = main()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
    import torch

    print(json.dumps({"kernels": rep["kernels"]}))
    print(rep["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
