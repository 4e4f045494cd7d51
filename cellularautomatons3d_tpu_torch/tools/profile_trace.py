"""A ``torch.profiler`` trace of one frame path of the port on the card, and
its summary (the port's counterpart of ``tools/profile_trace.py``)::

    python -m cellularautomatons3d_tpu_torch.tools.profile_trace \\
        [--mode MODE] [--grid N] [--frames K] [--out DIR] [--reps R]
    python -m cellularautomatons3d_tpu_torch.tools.profile_trace --device cpu --small

The Engine at 1920×1080 (``--small``: 64×32, grids cut to 32³ / 64³) runs
its frames once to warm up, then ``--reps`` times under CUDA events (the
step + frame ms: median and spread), then once more under
``utils.profiling.profile_trace``, which writes ``DIR/trace.json`` (default
``build/traces/<mode>_<grid>/``).  The launch counters of the port's kernels
are read around the traced frames.  Modes:

* ``headline``: 256³ gen-80, ``run_fused(K, reset_every=10)`` (the JAX
  ``bench.py`` headline loop: one CA step and one K1 compose launch a frame);
* ``dense``: 256³ gen-230, ``run_fused(K)`` without a reset;
* ``gi``, ``gi_temporal``, ``two_bounces``: 256³ gen-80 with soft shadows
  ×4, GI and light radius 0.08, full quality, its temporal form and two
  bounces, ``run_fused(K, reset_every=10)``;
* ``sliced``: ``--grid 512`` (gen-160, the default) or ``1024`` (gen-200),
  ``run_fused(K, reset_every=K)`` (K4 + K2 a frame);
* ``multistate``: the ``pyroclastic`` preset from its random seed at
  ``--grid 256`` (gen-160, the default), ``512`` (gen-320) or ``1024``
  (gen-560), ``run_fused(K, reset_every=min(K, 10))``;
* ``moved``: 256³ gen-80 (``--grid 512``: gen-160), K ``render()`` calls each
  after a camera move (a translate, a rotate and a mouse look), beside K
  static ones; ``renderer_fast.reproject_history`` runs inside a
  ``record_function`` range of its own, so the trace splits what a moved
  frame adds by kernel: the reprojection against the rest;
* ``mesh``: ``Engine(mesh_devices=4, mesh_device_list=[cuda:0] * 4)`` at
  ``--grid 512`` (gen-160, the default) or ``256`` (gen-80),
  ``run_fused(K, reset_every=K)``.

Prints one JSON line: the step + frame ms by events, the trace's summary
(``trace_summary.summarize``: device ms and launches by kernel per frame,
the busy and idle share, the longest idle gaps with their host operations),
``events_busy_share`` (the device ms a frame over the untraced events ms a
frame: the tracer slows the host, so the traced idle share overstates the
untraced one) and, per kernel family, the launches per frame in the trace
beside the launch counters' (``launches_match``: equal for every family).  The JAX
tool chains K frames in one ``jit`` and keeps a compile cache; eager torch
needs neither, and the Engine's own calls are what is traced.
"""

from __future__ import annotations

import contextlib
import functools
import time
from pathlib import Path

import torch

from ..engine import Engine
from ..models import PRESETS
from ..render import renderer_fast
from ..utils.profiling import profile_trace
from . import common, trace_summary

MODES = ("headline", "dense", "gi", "gi_temporal", "two_bounces", "sliced", "multistate",
         "moved", "mesh")
# mode: {grid: generations}, the first grid the default.
GENERATIONS = {
    "headline": {256: 80}, "dense": {256: 230}, "gi": {256: 80}, "gi_temporal": {256: 80},
    "two_bounces": {256: 80}, "sliced": {512: 160, 1024: 200},
    "multistate": {256: 160, 512: 320, 1024: 560}, "moved": {256: 80, 512: 160},
    "mesh": {512: 160, 256: 80},
}
KEYS = ("frame_ms", "window_ms_per_frame", "busy_ms_per_frame", "busy_share", "idle_share",
        "launches_per_frame")


def move_camera(rig, i: int):
    """The viewer's three inputs in one frame: a WASD translate, an arrow
    rotate and a mouse look, to alternate sides so the scene stays in view."""
    s = 1 if i % 2 == 0 else -1
    rig.translate((s, 0, -1), 0.016)
    rig.rotate((0, 1, 0), 0.004 * s)
    rig.mouse_look(6.0 * s, -3.0 * s)


@contextlib.contextmanager
def attributed(module, name: str, label: str):
    """Put ``module.name`` inside a ``record_function(label)`` range for the
    block, so a trace can attribute its kernels; restored on exit."""
    real = getattr(module, name)

    @functools.wraps(real)
    def wrapped(*a, **kw):
        with torch.profiler.record_function(label):
            return real(*a, **kw)

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, real)


def make_engine(run: common.Run, mode: str, grid: int) -> Engine:
    w, h = run.window
    kw = dict(grid_size=run.grid(grid), width=w, height=h)
    if mode in ("gi", "gi_temporal", "two_bounces"):
        kw.update(common.LIGHTING, gi_temporal=mode == "gi_temporal",
                  indirect_bounces=2 if mode == "two_bounces" else 1)
    if mode == "multistate":
        kw.update(PRESETS["pyroclastic"], random_initial_state=True)
    extra = {}
    if mode == "mesh":
        kw.update(mesh_devices=4)
        if run.cuda:
            extra["mesh_device_list"] = [run.dev] * 4
    return Engine(device=run.dev, **extra, **kw)


def frames_call(eng: Engine, mode: str, k: int):
    """The K frames of a mode, as one call."""
    if mode == "moved":
        def moved():
            for i in range(k):
                move_camera(eng.camera, i)
                eng.render()
        return moved
    reset = {"headline": 10, "gi": 10, "gi_temporal": 10, "two_bounces": 10,
             "dense": 0, "sliced": k, "mesh": k, "multistate": min(k, 10)}[mode]
    return lambda: eng.run_fused(k, reset_every=reset)


def trace_frames(run: common.Run, eng: Engine, mode: str, k: int, out_dir) -> dict:
    """Trace the K frames (a moved mode also K static ones, in ranges of
    their own) and read the launch counters around them."""
    call = frames_call(eng, mode, k)
    with common.counted() as launched, profile_trace(str(out_dir)):
        if mode == "moved":
            with attributed(renderer_fast, "reproject_history", "reproject_history"):
                with torch.profiler.record_function("moved render"):
                    call()
                with torch.profiler.record_function("static render"):
                    for _ in range(k):
                        eng.render()
        else:
            call()
        run.sync()
    return launched


def profile(run: common.Run, mode: str, grid: int, k: int, out_dir=None) -> dict:
    gens = GENERATIONS[mode]
    grid = grid or next(iter(gens))
    if grid not in gens:
        raise ValueError(f"--grid of mode {mode} is one of {sorted(gens)}")
    out_dir = out_dir or common.TRACE_ROOT / f"{mode}_{grid}{'_small' if run.small else ''}"
    t0 = time.perf_counter()
    eng = make_engine(run, mode, grid)
    eng.step(gens[grid])
    if mode == "moved":
        eng.render()
    call = frames_call(eng, mode, k)
    call()  # warm-up
    run.sync()
    setup_s = time.perf_counter() - t0
    ms = common.timed(run, call, calls=1, warmup=0)
    launched = trace_frames(run, eng, mode, k, out_dir)
    path = out_dir / "trace.json"
    n_frames = 2 * k if mode == "moved" else k
    summary = trace_summary.summarize(str(path), frames=n_frames)
    by_name = summary.pop("launches_by_name")
    summary["traced_frames"] = summary.pop("frames")
    traced = common.families(by_name)
    launches = {f: {"trace": traced.get(f, 0) / n_frames, "counters": launched.get(f, 0) / n_frames}
                for f in sorted(set(traced) | set(launched))}
    w, h = run.window
    rec = dict(mode=mode, grid=run.grid(grid), generations=gens[grid], frames=k,
               width=w, height=h, setup_s=setup_s,
               frame_ms=ms["ms"] / k, frame_min_ms=ms["min_ms"] / k,
               frame_max_ms=ms["max_ms"] / k, trace=str(path), **summary,
               launches=launches,
               launches_match=all(v["trace"] == v["counters"] for v in launches.values()))
    if mode == "moved":
        ranges = trace_summary.by_range(str(path))
        rec["ranges"] = {name: dict(r, device_ms_per_frame=r["device_ms"] / k,
                                    launches_per_frame=r["launches"] / k)
                         for name, r in ranges.items() if name is not None}
        moved = [rec["ranges"].get(n, {}) for n in ("moved render", "reproject_history")]
        static = rec["ranges"].get("static render", {})
        rec["moved_extra_launches_per_frame"] = (
            sum(r.get("launches", 0) for r in moved) - static.get("launches", 0)) / k
        rec["moved_extra_device_ms_per_frame"] = (
            sum(r.get("device_ms", 0.0) for r in moved) - static.get("device_ms", 0.0)) / k
        busy = sum(r.get("device_ms", 0.0) for r in moved) / k
    else:
        busy = rec["busy_ms_per_frame"]
    # The tracer slows the host, so the traced window overstates the idle
    # time: the device ms a frame over the untraced events ms a frame is
    # the busy share without it.
    rec["events_busy_share"] = min(1.0, busy / rec["frame_ms"])
    return rec


def main(argv=None) -> list[dict]:
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=MODES, default="headline")
    ap.add_argument("--grid", type=int, default=None,
                    help="the grid of the sliced, multistate, moved and mesh modes")
    ap.add_argument("--frames", type=int, default=10, help="frames traced (K)")
    ap.add_argument("--out", default=None, help="directory of trace.json")
    args = ap.parse_args(argv)
    run = common.Run(args)
    rec = profile(run, args.mode, args.grid, max(1, args.frames),
                  Path(args.out) if args.out else None)
    return [common.emit("profile_trace", run, **rec)]


if __name__ == "__main__":
    main()
