"""The scale and lighting lines on the card (the port's counterpart of
``tools/bench_scale.py``)::

    python -m cellularautomatons3d_tpu_torch.tools.bench_scale [names...] [--reps R] [--frames K]
    python -m cellularautomatons3d_tpu_torch.tools.bench_scale --device cpu --small

The JAX tool's five scenarios, under its names (all by default), at
1920×1080 with its ``RenderParams`` (static initial view):

* ``512``: 512³ gen-160, one CA step (50 back to back, per step) + one sliced
  frame (``renderer_fast.render_frame_fast``, K4 + K2 + torch shading, the
  history carried; 5 frames);
* ``1024``: the 1024³ gen-200 frame (3 frames);
* ``gi``: 256³ gen-80, ``make_fused_loop(20, reset_every=10)`` with soft
  shadows ×4 and one-bounce GI at full quality (every sample every frame);
* ``gi_temporal``: its temporal form's frame, ``render_frame_fast`` with the
  frame counter as the sample index (20 frames);
* ``gi_temporal_loop``: the temporal form's fused loop
  (``make_fused_loop(50, reset_every=10)``).

``--small`` cuts the grids to 32³ / 64³ and the window to 64×32 and sends
the 512 / 1024 frames through the sliced path all the same
(``RenderStatic.force_sliced``); ``--frames K`` sets every scenario's frame
count.  One JSON line per scenario: ms by CUDA events (median and spread
over ``--reps`` reads), device ms (``cuda_time_fn(queued=True)``, None where
one read holds more launches than the stream queues).  The JAX tool chains
k frames in one ``jit`` behind a 1-element readback and keeps a compile
cache, workarounds for the TPU transport's dispatch latency that eager
torch does not need.
"""

from __future__ import annotations

import numpy as np

from ..ops.ca_step import visibility_plane
from ..ops.loop import make_multi_step
from ..render.renderer import RenderParams, RenderStatic
from ..render.renderer_fast import init_fast_history, make_fused_loop, render_frame_fast
from ..utils import mat4
from . import common

KEYS = ("value",)
NAMES = ("512", "1024", "gi", "gi_temporal", "gi_temporal_loop")


def _params(width: int, height: int) -> RenderParams:
    """The JAX tools' ``RenderParams``: the initial view, static."""
    view = mat4.initial_view_matrix()
    proj_view = mat4.multiply(mat4.initial_projection_matrix(width, height), mat4.inverse(view))
    f32 = np.float32
    return RenderParams(
        view_mat=np.asarray(view, f32), prev_view_mat=np.asarray(view, f32),
        prev_proj_view=np.asarray(proj_view, f32), elapsed_time=f32(common.ELAPSED),
        cell_size=f32(common.CELL_SIZE), temporal_alpha=f32(0.1), gamma=f32(2.0),
        roughness=f32(common.ROUGHNESS), base_reflectivity=np.asarray(common.REFLECTIVITY, f32),
        material_color=np.asarray(common.MATERIAL, f32),
        light_pos=np.asarray(common.LIGHT_POS, f32),
        light_magnitude=f32(common.LIGHT_MAGNITUDE), show_depth_overlay=f32(0.0),
    )


def _static(run, grid, **kw) -> RenderStatic:
    w, h = run.window
    sliced = kw.pop("sliced", False)
    return RenderStatic(width=w, height=h, grid_size=grid, depth_samples=35, shadow_samples=30,
                        force_sliced=sliced and grid <= 256, **kw)


def _frames(run, s: RenderStatic, state, k: int):
    """k frames of render_frame_fast (static camera, the history carried;
    the frame counter as the sample index with gi_temporal), as one call."""
    params = _params(s.width, s.height)
    vis = visibility_plane(state, common.spec_of(s.grid_size))

    def frames():
        hist = init_fast_history(s.width, s.height, run.dev)
        for i in range(k):
            _, _, hist = render_frame_fast(s, vis, params, hist, True,
                                           i if s.gi_temporal else None)
        return hist
    return frames


def _loop(run, s: RenderStatic, state, k: int):
    run_loop = make_fused_loop(s, common.spec_of(s.grid_size), k, reset_every=10)
    params = _params(s.width, s.height)
    return lambda: run_loop(state, params, init_fast_history(s.width, s.height, run.dev))


def _per_frame(run, make, k: int) -> dict:
    """ms a frame of ``make(k)`` (k frames as one call) by events, and the
    device ms of ``make(1)``."""
    ms = common.timed(run, make(k), calls=1, warmup=1)
    return dict(ms=ms["ms"] / k, min_ms=ms["min_ms"] / k, max_ms=ms["max_ms"] / k,
                device_ms=common.device_ms(run, make(1), calls=5), frames=k)


def scenario(run: common.Run, name: str, frames: int | None) -> dict:
    w, h = run.window
    if name in ("512", "1024"):
        grid, gens, k = (512, 160, 5) if name == "512" else (1024, 200, 3)
        k = frames or k
        n = run.grid(grid)
        state = common.scene(n, gens, run.dev)
        s = _static(run, n, sliced=True)
        frame = _per_frame(run, lambda j: _frames(run, s, state, j), k)
        out = dict(grid=n, generations=gens, frame_ms=frame["ms"], frame_min_ms=frame["min_ms"],
                   frame_max_ms=frame["max_ms"], frame_device_ms=frame["device_ms"], frames=k)
        if name == "1024":
            return dict(metric=f"{n}^3 sliced {w}x{h} frame", value=frame["ms"], unit="ms", **out)
        steps = 50
        step = _per_frame(run, lambda j: (lambda: make_multi_step(common.spec_of(n), j)(state)),
                          steps)
        return dict(metric=f"{n}^3 CA step + sliced {w}x{h} frame",
                    value=frame["ms"] + step["ms"], unit="ms", step_ms=step["ms"],
                    step_min_ms=step["min_ms"], step_max_ms=step["max_ms"],
                    step_device_ms=step["device_ms"], **out)
    n = run.grid(256)
    state = common.scene(n, 80, run.dev)
    lighting = dict(indirect_lighting=True, soft_shadow_samples=4)
    if name == "gi":
        k = frames or 20
        s = _static(run, n, **lighting)
        r = _per_frame(run, lambda j: _loop(run, s, state, j), k)
        metric = f"{n}^3 step + GI(1-bounce)+soft(4) composed {w}x{h} frame (fused loop)"
        target = 33.3
    elif name == "gi_temporal":
        k = frames or 20
        s = _static(run, n, gi_temporal=True, **lighting)
        r = _per_frame(run, lambda j: _frames(run, s, state, j), k)
        metric = f"{n}^3 GI temporal (1 rotating sample/frame) {w}x{h} frame"
        target = 33.3
    else:
        k = frames or 50
        s = _static(run, n, gi_temporal=True, **lighting)
        r = _per_frame(run, lambda j: _loop(run, s, state, j), k)
        metric = f"{n}^3 step + GI-temporal composed {w}x{h} frame (fused loop)"
        target = 16.7
    return dict(metric=metric, value=r["ms"], unit="ms", min_ms=r["min_ms"], max_ms=r["max_ms"],
                device_ms=r["device_ms"], frames=k, grid=n, generations=80, target_ms=target)


def main(argv=None) -> list[dict]:
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", help=f"of {', '.join(NAMES)} (default: all)")
    ap.add_argument("--frames", type=int, default=None, help="frames of every scenario")
    args = ap.parse_args(argv)
    unknown = set(args.names) - set(NAMES)
    if unknown:
        ap.error(f"unknown scenarios {sorted(unknown)}: choose from {NAMES}")
    run = common.Run(args)
    return [common.emit("bench_scale", run, scenario=name, **scenario(run, name, args.frames))
            for name in args.names or NAMES]


if __name__ == "__main__":
    main()
