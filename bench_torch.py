#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: the counterpart of ``bench.py``.

    python3 bench_torch.py                      # on the card: 256³, 1920×1080
    python3 bench_torch.py --device cpu --grid 32 --width 64 --height 32 \\
        --frames 4 --steps 10 --warmup-gens 8 --repeats 2   # small, on the CPU

Measures what ``bench.py`` measures, on the same scene and loop: the fused
production loop (``renderer_fast.make_fused_loop``: one CA generation plus
one fully composed frame per iteration, K1 in compose mode) over ``--frames``
frames (K = 150) from the centre seed after ``--warmup-gens`` generations (80)
at 256³ / 1920×1080, with the scene restored every 10 frames (the pinned
headline, ``value``) and without (the dense line, generation 80 to 230,
``dense_scene_ms``); then the CA step alone over ``--steps`` generations
(1000, ``step_ms``).  One loop serves both frame lines: the reset period is
its runtime argument.

Timing: for each line one warm-up call (on the card the first call builds the
kernels into ``build/``), then ``--repeats`` timed calls (5), each from a
fresh history and from the scene (the loop never modifies the state it is
handed), through ``tools/common.timed``.  A timed call is what a user
gets: one pair of CUDA events around the whole host loop and one synchronise
after it, none per frame.  Unlike the reference's single jitted dispatch, the
port's loop is driven by the host (3.3 launches a frame: the CA step, the
occupancy rebuild, K1 composing, and the call's few torch launches over its
frames), so the host's launch time is inside every number.  The lines are the medians; ``spread``
holds the least and the most read of each.  On the CPU the host's clock.
One more call of each loop, untimed, checks that the pinned run's final
state is the scene stepped ``frames % 10`` times (the scene itself at
K = 150), the dense run's the scene stepped ``frames`` times, and the frames
finite.

Standard output carries exactly one JSON line: the keys of ``bench.py``'s
line (``metric``, ``value``, ``unit``, ``vs_baseline``, ``dense_scene_ms``,
``step_ms``, ``frame_ms``, ``ca_steps_per_sec``, ``fps``, ``device``), with
``device`` the card's name and power limit as ``nvidia-smi`` gives them, and
``repeats`` and ``spread``.  Progress, and the CA step's device time without
the host's launches, go to standard error.  Without CUDA and without
``--device cpu`` it exits non-zero with nothing on standard output.
"""

from __future__ import annotations

import time

_T0 = time.time()  # before the heavy imports, so the stages read the wall clock

import argparse
import ast
import json
import statistics
import sys
from pathlib import Path

import torch

from cellularautomatons3d_tpu_torch.ops.loop import make_multi_step
from cellularautomatons3d_tpu_torch.render import renderer_fast
from cellularautomatons3d_tpu_torch.render.renderer import RenderStatic
from cellularautomatons3d_tpu_torch.tools import common
from cellularautomatons3d_tpu_torch.utils.metrics import cuda_time_fn, device_sync

GRID, WIDTH, HEIGHT = 256, 1920, 1080
FRAMES = 150         # bench.py's K
STEPS = 1000
WARMUP_GENS = 80
REPEATS = 5
RESET_PERIOD = 10    # the pinned headline keeps the scene in the gen-81..90 band
TARGET_MS = 16.0     # bench.py's baseline: 60 FPS


def _stage(msg: str) -> None:
    """Progress marker on stderr (stdout carries exactly one JSON line)."""
    print(f"[bench_torch +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def bench_py_keys() -> set:
    """The keys of the JSON line the reference's ``bench.py`` prints: the dict
    literal with a ``metric`` key in its source (read, not imported: it
    imports JAX)."""
    tree = ast.parse((Path(__file__).resolve().parent / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if "metric" in keys:
                return keys
    raise RuntimeError("bench.py prints no dict with a 'metric' key")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"bench_torch: {msg}")


def scene_and_loop(grid: int, width: int, height: int, frames: int, warmup_gens: int, dev):
    """The bench's automaton, scene and loop on ``dev``: (spec, the centre
    seed after ``warmup_gens`` generations, the fused loop over ``frames``
    frames ``run(state, params, history, reset_period)``, its params)."""
    spec = common.spec_of(grid)
    s = RenderStatic(width=width, height=height, grid_size=grid, depth_samples=35,
                     shadow_samples=30)
    run = renderer_fast.make_fused_loop(s, spec, frames, reset_every=RESET_PERIOD)
    return spec, common.scene(grid, warmup_gens, dev), run, common.render_params(width, height)


def measure(grid: int = GRID, width: int = WIDTH, height: int = HEIGHT, frames: int = FRAMES,
            steps: int = STEPS, warmup_gens: int = WARMUP_GENS, repeats: int = REPEATS,
            device="cuda"):
    """The bench's lines on ``device``: (the JSON record, the pinned run's
    final state, its last frame [height, width, 3])."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_torch measures the card and torch.cuda.is_available() is "
                           "false; --device cpu runs it on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    _check(min(frames, steps, repeats) >= 1 and warmup_gens >= 0,
           f"frames {frames}, steps {steps}, repeats {repeats} must be >= 1 and "
           f"warmup_gens {warmup_gens} >= 0")
    _stage(f"{grid}^3 scene: {warmup_gens} generations on {dev}"
           + (" (the first call builds the kernels)..." if dev.type == "cuda" else "..."))
    spec, scene, loop, params = scene_and_loop(grid, width, height, frames, warmup_gens, dev)
    device_sync(scene)

    run = common.Run(argparse.Namespace(  # the CPU runs at the caller's size, not --small's
        device=str(dev), small=dev.type == "cpu", reps=repeats))

    def fresh_history():  # the loop never modifies the scene it is handed
        return (renderer_fast.init_fast_history(width, height, dev),)

    def line(reset_period):
        ms = common.timed(run, lambda hist: loop(scene, params, hist, reset_period), calls=1,
                          warmup=1, prepare=fresh_history)
        st, _, frame = loop(scene, params, *fresh_history(), reset_period)
        _check(tuple(frame.shape) == (height, width, 3) and bool(torch.isfinite(frame).all()),
               f"reset period {reset_period}: frame {tuple(frame.shape)} not finite")
        stepped = frames % reset_period if reset_period > 0 else frames
        _check(torch.equal(st, make_multi_step(spec, stepped)(scene)),
               f"reset period {reset_period}: the final state is not the scene stepped "
               f"{stepped} times")
        return [r / frames for r in ms["reads_ms"]], st, frame

    _stage(f"pinned loop: {frames} frames at {width}x{height}, reset every {RESET_PERIOD}...")
    pinned, state, frame = line(RESET_PERIOD)
    _stage(f"pinned = {statistics.median(pinned):.4f} ms/frame; dense loop (no reset)...")
    dense, _, _ = line(0)
    _stage(f"dense = {statistics.median(dense):.4f} ms/frame; CA step alone, {steps} steps...")
    run_steps = make_multi_step(spec, steps)
    later = run_steps(scene)
    reads = common.timed(run, lambda: run_steps(later), calls=1, warmup=1)["reads_ms"]
    stepped = [r / steps for r in reads]
    if dev.type == "cuda":
        one = make_multi_step(spec, 1)
        dev_ms = cuda_time_fn(one, later, reps=400, warmup=10, device=dev, queued=True)
        _stage(f"step = {statistics.median(stepped):.4f} ms by events, {dev_ms:.4f} ms of "
               "device time (cuda_time_fn queued: the host's launches excluded)")

    value, dense_ms, step_ms = (statistics.median(x) for x in (pinned, dense, stepped))
    rec = {
        "metric": f"{grid}^3 CA step + composed {height}p path-traced frame",
        "value": value,
        "unit": "ms",
        "vs_baseline": TARGET_MS / value,
        "dense_scene_ms": dense_ms,
        "step_ms": step_ms,
        "frame_ms": value - step_ms,
        "ca_steps_per_sec": 1000.0 / step_ms,
        "fps": 1000.0 / value,
        "device": common.card() if dev.type == "cuda" else "cpu",
        "repeats": repeats,
        "spread": {k: {"min": min(x), "max": max(x)} for k, x in
                   (("value", pinned), ("dense_scene_ms", dense), ("step_ms", stepped))},
    }
    return rec, state, frame


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits non-zero without a card) or cpu")
    ap.add_argument("--grid", type=int, default=GRID)
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--height", type=int, default=HEIGHT)
    ap.add_argument("--frames", type=int, default=FRAMES, help="frames a timed loop call")
    ap.add_argument("--steps", type=int, default=STEPS, help="generations a timed step call")
    ap.add_argument("--warmup-gens", type=int, default=WARMUP_GENS,
                    help="generations from the centre seed to the scene")
    ap.add_argument("--repeats", type=int, default=REPEATS, help="timed calls a line")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        sys.exit("bench_torch: torch.cuda.is_available() is false; the bench measures the "
                 "card (--device cpu runs it on the CPU)")
    rec, _, _ = measure(args.grid, args.width, args.height, args.frames, args.steps,
                        args.warmup_gens, args.repeats, args.device)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
