#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Builds the hand-written kernels from ``cellularautomatons3d_tpu_torch/csrc``
(nvcc, ``sm_90a``) and runs, each phase fatal on failure:

  (a) CA step kernel vs its plain torch version, bit-exact, at 256³ for
      20 generations: every neighbourhood × boundary mode on a random 5³
      block and on a random volume (whose cells reach the boundary), the
      default rule on the centre seed, a mixed-group rule; the population
      after one step from the centre seed is 7.
  (b) K1 (render kernel) vs its plain torch version in both modes at
      64³ / 128×64 and 256³ / 1920×1080 on the scene after 80 steps: ids
      equal, depth within atol 3e-5, rgb within rtol 3e-3 / atol 3e-4;
      then the whole Engine on the card vs on the CPU at 64³.
  (c) the main path at real size: Engine(grid_size=256, 1920×1080,
      device="cuda"): step(80), render() twice, run_fused(150,
      reset_every=10), with both kernels' launch counters read around it.
  (d) timings with CUDA events (kernel vs plain, CA step, step + composed
      frame; K2 and K3 vs plain, the lighting passes, and step + frame of
      the three lighting configurations; K4 and K2's hard-shadow query vs
      plain and step + frame at 512³ and 1024³), beside the card's name and
      power limit.  It runs last, after (e) and (f).
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
      K3 on its 4 GI lookups, and the CA step at 512³ (gen-160) and 1024³
      (gen-200) and on random words at both, over 5 generations, all
      equal; the Engine on the card vs on the CPU at 320³ / 64×32 for
      hard shadows and gi_temporal; then Engine(512, 1920×1080): step(160),
      render(), run_fused(20, reset_every=10), Engine(1024, 1920×1080):
      step(200), render(), run_fused(5), and Engine(512) with soft shadows
      ×4, GI, light_radius 0.08 and gi_temporal, with every kernel's launch
      counter read around each.

The last two lines of standard output are the card (``nvidia-smi
--query-gpu=name,power.limit``) and ``{"ok": true, "device": {...}}``; the
line before them is the kernels' JSON summary.  Exits non-zero, printing no
result, without a CUDA device or outside a checkout of the repository.
Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import subprocess
import sys
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


def cuda_ms(torch, fn, iters, warmup=2):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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
    vol, coarse, cam, _, k2, k3 = lighting_operands(512, WIDTH, HEIGHT, steps=160)
    k2_check("512^3 full quality", vol, coarse, cam, 512, k2)
    got3 = rs.cell_state_cuda(vol, *k3, grid_size=512)
    want3 = rs.cell_state(vol, *k3, grid_size=512)
    k3_bad = int((got3 != want3).sum())
    log(f"  K3 512^3 full quality: {k3[0].shape[0]} queries, {int(k3[1].sum())} active, "
        f"{int(want3.sum())} live, {k3_bad} differ")
    need(k3_bad == 0, f"K3 512^3: {k3_bad} states differ from the plain version")
    need(int(want3.sum()) > 0, "K3 512^3: no live neighbour found")
    del k2, k3, got3, want3
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
               rs.shadow_sweep_cuda, rs.cell_state_cuda)
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
        needed = ["fires_plane_cuda", "primary_sweep_cuda", "shadow_sweep_cuda"]
        if cfg.get("indirect_lighting"):
            needed.append("cell_state_cuda")
        need(all(counts[k] > 0 for k in needed), f"{name} missed a kernel: {counts}")
        need(counts["raytrace_cuda"] == 0, f"{name} launched K1: {counts}")
        hits = float((eng.history.hit_idx >= 0).float().mean())
        log(f"(f) {name}: step({steps}), render(), run_fused({fused}) in "
            f"{time.perf_counter() - t0:.2f} s; launches {counts}; hit fraction {hits:.3f}")
        launches[name] = counts
        engines[name] = (eng, frames)
    return dict(k4_max_abs_err=k4_err, plain_ms=plain_ms, launches=launches,
                engines=engines, timed=timed_ops)


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
    from cellularautomatons3d_tpu_torch import kernels
    from cellularautomatons3d_tpu_torch.models.automaton import AutomatonSpec
    from cellularautomatons3d_tpu_torch.ops import ca_step
    from cellularautomatons3d_tpu_torch.ops.occupancy import coarse_occupancy
    from cellularautomatons3d_tpu_torch.render import render_fast as rf
    from cellularautomatons3d_tpu_torch.render import render_slab as rs
    from cellularautomatons3d_tpu_torch.utils import mat4

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

    # --------------------------------- (e) extended lighting: K2 and K3 ---
    def lighting_operands(size, w, h, steps=80):
        """K2's and K3's operands of a full-quality frame, as the port
        builds them: 4 soft-shadow samples + 4 GI slots, 4 GI lookups."""
        vol = grown(size, steps)
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
        k2 = rs.stack_occlusion_queries(queries, w, h)
        k3 = rs.stack_cell_queries([(sl[0], sl[3]) for sl in slots], w, h)
        return vol, coarse, cam, (q, origin, coords, found), k2, k3

    for size, w, h in ((64, 128, 64), (GRID, WIDTH, HEIGHT)):
        vol, coarse, cam, geo, k2, k3 = lighting_operands(size, w, h)
        kw = dict(grid_size=size, cell_half=rs._cell_half(cam, size))
        got = rs.shadow_sweep_cuda(vol, coarse, *k2, **kw)
        want = rs.shadow_sweep(vol, *k2, **kw)
        got3 = rs.cell_state_cuda(vol, *k3, grid_size=size)
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
    timed_k23 = (vol, coarse, cam, geo, k2, k3, kw)

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
               rs.cell_state_cuda)
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

    # -------------------------------------------------- (d) timings ---
    card = card_line()
    st = eng80.state
    ca_ms = cuda_ms(torch, lambda: ca_step.fires_plane_cuda(st, spec), 1000, warmup=20)
    ca_plain_ms = cuda_ms(torch, lambda: ca_step.fires_plane(st, spec), 20, warmup=2)
    vol, coarse, cam, hist, kw = timed_k1
    k1_ms = cuda_ms(torch, lambda: rf.raytrace_cuda(vol, coarse, cam, hist, **kw), 50, warmup=3)
    k1_nc_ms = cuda_ms(torch, lambda: rf.raytrace_cuda(vol, coarse, cam, **kw), 50, warmup=3)
    k1_plain_ms = cuda_ms(torch, lambda: rf.raytrace(vol, coarse, cam, hist, **kw), 3, warmup=1)
    occ_ms = cuda_ms(torch, lambda: coarse_occupancy(vol), 200, warmup=5)
    eng.run_fused(10, reset_every=10)
    fused_ms = cuda_ms(torch, lambda: eng.run_fused(100, reset_every=10), 1, warmup=0) / 100
    render_ms = cuda_ms(torch, eng.render, 20, warmup=2)
    vol, coarse, cam, geo, k2, k3, kw = timed_k23
    k2_ms = cuda_ms(torch, lambda: rs.shadow_sweep_cuda(vol, coarse, *k2, **kw), 20, warmup=2)
    k2_plain_ms = cuda_ms(torch, lambda: rs.shadow_sweep(vol, *k2, **kw), 1, warmup=0)
    k3_ms = cuda_ms(torch, lambda: rs.cell_state_cuda(vol, *k3, grid_size=GRID), 50, warmup=2)
    k3_plain_ms = cuda_ms(torch, lambda: rs.cell_state(vol, *k3, grid_size=GRID), 10, warmup=1)
    passes_ms = cuda_ms(torch, lambda: rs.lighting_passes(
        cam, *geo, rs.prep_volume(vol, coarse), grid_size=GRID, width=WIDTH,
        height=HEIGHT, soft_k=LIGHTING["soft_shadow_samples"], gi=True), 5, warmup=1)
    lighting_ms = {
        f"{name}_step_plus_frame_ms": cuda_ms(
            torch, lambda e=e: e.run_fused(20, reset_every=10), 1, warmup=0) / 20
        for name, e in lighting_engines.items()
    }
    sliced_ms = {
        f"{name}_step_plus_frame_ms": cuda_ms(
            torch, lambda e=e, fr=fr: e.run_fused(fr, reset_every=fr), 1, warmup=0) / fr
        for name, (e, fr) in sliced["engines"].items()
    }
    for size, (vol, coarse, cam, k2) in sliced["timed"].items():
        kw = dict(grid_size=size, width=WIDTH, height=HEIGHT)
        sliced_ms[f"k4_{size}_ms"] = cuda_ms(
            torch, lambda: rs.primary_sweep_cuda(vol, coarse, cam, **kw), 20, warmup=2)
        sliced_ms[f"k2_hard_{size}_ms"] = cuda_ms(torch, lambda: rs.shadow_sweep_cuda(
            vol, coarse, *k2, grid_size=size, cell_half=rs._cell_half(cam, size)),
            20, warmup=2)
    sliced_ms.update(sliced["plain_ms"])
    timings = {
        "ca_step_ms": ca_ms, "ca_step_plain_ms": ca_plain_ms,
        "k1_compose_ms": k1_ms, "k1_noncompose_ms": k1_nc_ms,
        "k1_plain_compose_ms": k1_plain_ms, "coarse_occupancy_ms": occ_ms,
        "pinned_step_plus_frame_ms": fused_ms, "render_call_ms": render_ms,
        "k2_ms": k2_ms, "k2_plain_ms": k2_plain_ms,
        "k3_ms": k3_ms, "k3_plain_ms": k3_plain_ms,
        "lighting_passes_ms": passes_ms, **lighting_ms, **sliced_ms,
    }
    report["timings"] = timings
    report["card"] = card
    log(f"(d) timings on {card} (CUDA events, {WIDTH}x{HEIGHT}; {GRID}^3 unless named):")
    for k, v in timings.items():
        log(f"  {k}: {v:.4f}")

    sliced_launches = sliced["launches"]

    def total(fn_name, *runs):
        return sum(r[fn_name] for r in runs)

    report["kernels"] = [
        {"name": "ca_step", "route": "cuda",
         "source": "cellularautomatons3d_tpu_torch/csrc/ca_step.cu",
         "replaces": "cellularautomatons3d_tpu/ops/ca_step.py:118",
         "launches": launches["ca_step"] + total(
             "fires_plane_cuda", *sliced_launches.values()), "max_abs_err": 0.0,
         "ms": ca_ms, "plain_ms": ca_plain_ms},
        {"name": "render_fast", "route": "cuda",
         "source": "cellularautomatons3d_tpu_torch/csrc/render_fast.cu",
         "replaces": "cellularautomatons3d_tpu/render/render_fast.py:1018",
         "launches": launches["render_fast"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "shadow_sweep", "route": "cuda",
         "source": "cellularautomatons3d_tpu_torch/csrc/shadow_sweep.cu",
         "replaces": "cellularautomatons3d_tpu/render/render_slab.py:354",
         "launches": total("shadow_sweep_cuda", *lighting_launches.values(),
                           *sliced_launches.values()),
         "max_abs_err": 0.0, "ms": k2_ms, "plain_ms": k2_plain_ms},
        {"name": "cell_state", "route": "cuda",
         "source": "cellularautomatons3d_tpu_torch/csrc/cell_state.cu",
         "replaces": "cellularautomatons3d_tpu/render/render_slab.py:687",
         "launches": total("cell_state_cuda", *lighting_launches.values(),
                           *sliced_launches.values()),
         "max_abs_err": 0.0, "ms": k3_ms, "plain_ms": k3_plain_ms},
        {"name": "primary_sweep", "route": "cuda",
         "source": "cellularautomatons3d_tpu_torch/csrc/primary_sweep.cu",
         "replaces": "cellularautomatons3d_tpu/render/render_slab.py:279",
         "launches": total("primary_sweep_cuda", *sliced_launches.values()),
         "max_abs_err": sliced["k4_max_abs_err"], "ms": sliced_ms["k4_512_ms"],
         "plain_ms": sliced_ms["k4_512_plain_ms"]},
    ]
    need("jax" not in {m.split(".")[0] for m, v in sys.modules.items() if v is not None},
         "JAX was imported")
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
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
