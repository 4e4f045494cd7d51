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
      frame), beside the card's name and power limit.

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

    def scene_cam(view, w, h):
        return rf.pack_cam(
            view, w, h, defaults.light.position, defaults.light.magnitude,
            defaults.cell_size, defaults.roughness, defaults.base_reflectivity,
            defaults.material_color, temporal_alpha=defaults.temporal_alpha,
            gamma=defaults.gamma,
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
    timings = {
        "ca_step_ms": ca_ms, "ca_step_plain_ms": ca_plain_ms,
        "k1_compose_ms": k1_ms, "k1_noncompose_ms": k1_nc_ms,
        "k1_plain_compose_ms": k1_plain_ms, "coarse_occupancy_ms": occ_ms,
        "pinned_step_plus_frame_ms": fused_ms, "render_call_ms": render_ms,
    }
    report["timings"] = timings
    report["card"] = card
    log(f"(d) timings on {card} (CUDA events, {GRID}^3, {WIDTH}x{HEIGHT}):")
    for k, v in timings.items():
        log(f"  {k}: {v:.4f}")

    report["kernels"] = [
        {"name": "ca_step", "route": "cuda",
         "source": "cellularautomatons3d_tpu_torch/csrc/ca_step.cu",
         "replaces": "cellularautomatons3d_tpu/ops/ca_step.py:118",
         "launches": launches["ca_step"], "max_abs_err": 0.0,
         "ms": ca_ms, "plain_ms": ca_plain_ms},
        {"name": "render_fast", "route": "cuda",
         "source": "cellularautomatons3d_tpu_torch/csrc/render_fast.cu",
         "replaces": "cellularautomatons3d_tpu/render/render_fast.py:1018",
         "launches": launches["render_fast"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
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
