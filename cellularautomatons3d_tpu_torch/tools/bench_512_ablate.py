"""The 512³ sliced frame with and without its occlusion pass, and K4 and K2
with the coarse column skip on and off (the port's counterpart of
``tools/bench_512_ablate.py``)::

    python -m cellularautomatons3d_tpu_torch.tools.bench_512_ablate [k] [--grid 512|1024] [--reps R]
    python -m cellularautomatons3d_tpu_torch.tools.bench_512_ablate --device cpu --small

The centre seed after 160 generations at 512³ (``--grid 1024``: 200 at
1024³) and 1920×1080 (``--small``: 64³, 64×32):

* ``frame``: ``k`` (default 5) frames of ``render_slab.raytrace_sliced``
  alone (no composition), with the hard-shadow occlusion pass (``shadow``
  true) and without it (false), alternated with, without, without, with
  (the JAX tool's ``CA3D_BD_SHADOW``);
* ``k4_column_skip``: on that frame's own inputs, K4
  (``primary_sweep_cuda``) with the coarse column skip (the default) and
  without it (``column_skip=False``: every column of the occupied box
  descends), alternated on, off, off, on, by CUDA events and device time;
* ``k2_column_skip``: the same for K2 (``shadow_sweep_cuda``) on the frame's
  hard-shadow query.

The skip-off run is the counterpart of the JAX tool's ``CA3D_BRICK_SKIP=0``
(``render_slab.py:195-218`` there): the per-brick conds are TPU brick
machinery, and the coarse column skip is what the card's sweeps skip with.
Before timing, each kernel without the skip is checked bit for bit against
the default.  On the CPU the kernels are out of reach: the plain twins (K4's
and K2's, which have no skip) time both rows.  One JSON line per row; ms by
events are medians of ``--reps`` reads (the frame) or means of each side's
two alternated reads.  The JAX tool's ``fori_loop`` and compile cache are
TPU transport workarounds and are not carried over.
"""

from __future__ import annotations

import torch

from ..render import render_slab
from ..render.render_fast import P_LIGHT
from ..render.intersect import device_vec
from . import common

KEYS = ("on_ms", "off_ms")
GENERATIONS = {512: 160, 1024: 200}


def alternated(run: common.Run, fns: dict, calls: int = 20, device: bool = True) -> dict:
    """Two calls ``fns = {a: fn, b: fn}`` timed in turns a, b, b, a by
    events and, with ``device``, by device time: each one's mean of its two
    reads, and the reads."""
    (a, fa), (b, fb) = fns.items()
    order = (fa, fb, fb, fa)
    ev = [common.timed(run, f, calls=calls, reps=1, warmup=1)["ms"] for f in order]
    out = {"events_reads_ms": ev, f"{a}_ms": (ev[0] + ev[3]) / 2, f"{b}_ms": (ev[1] + ev[2]) / 2}
    if device:
        dv = [common.device_ms(run, f, calls) for f in order]
        both = None not in dv
        out.update({"device_reads_ms": dv,
                    f"{a}_device_ms": (dv[0] + dv[3]) / 2 if both else None,
                    f"{b}_device_ms": (dv[1] + dv[2]) / 2 if both else None})
    return out


def sweeps(run: common.Run, vol, cam, grid: int) -> dict:
    """K4 and K2's hard-shadow query of the frame, each as {on, off} calls
    (the plain twin for both on the CPU)."""
    w, h = run.window
    kw = dict(grid_size=grid, width=w, height=h)
    prepped = render_slab.prep_volume(vol)
    t_img, idx = render_slab.primary_hits(cam, prepped, **kw)
    q, _, coords, found, _ = render_slab.hit_geometry(cam, idx, t_img, **kw)
    light = device_vec(cam[P_LIGHT : P_LIGHT + 3], q.device)
    ops = render_slab.stack_occlusion_queries([(q, light, coords, found)], w, h)
    k2 = dict(grid_size=grid, cell_half=render_slab._cell_half(cam, grid))
    if not run.cuda:
        return {
            "k4": {s: (lambda: render_slab.primary_sweep(vol, cam, **kw)) for s in ("on", "off")},
            "k2": {s: (lambda: render_slab.shadow_sweep(vol, *ops, **k2)) for s in ("on", "off")},
        }
    coarse = prepped.coarse
    return {
        "k4": {s: (lambda skip=s == "on": render_slab.primary_sweep_cuda(
            vol, coarse, cam, column_skip=skip, **kw)) for s in ("on", "off")},
        "k2": {s: (lambda skip=s == "on": render_slab.shadow_sweep_cuda(
            vol, coarse, *ops, column_skip=skip, **k2)) for s in ("on", "off")},
    }


def main(argv=None) -> list[dict]:
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("k", nargs="?", type=int, default=5, help="frames a timed read")
    ap.add_argument("--grid", type=int, choices=sorted(GENERATIONS), default=512)
    ap.add_argument("--calls", type=int, default=20, help="kernel calls a timed read")
    args = ap.parse_args(argv)
    run = common.Run(args)
    w, h = run.window
    grid, gens = run.grid(args.grid), GENERATIONS[args.grid]
    vol = common.scene(grid, gens, run.dev)
    cam = common.cam(w, h)
    kw = dict(grid_size=grid, width=w, height=h)
    base = dict(grid=grid, generations=gens, width=w, height=h)
    out = []

    def frames(shadow):
        def call():
            for _ in range(args.k):
                render_slab.raytrace_sliced(vol, cam, shadow=shadow, **kw)
        return call

    r = alternated(run, {"on": frames(True), "off": frames(False)}, calls=1, device=False)
    dev1 = {s: common.device_ms(run, lambda s=s: render_slab.raytrace_sliced(
        vol, cam, shadow=s == "on", **kw), calls=5) for s in ("on", "off")}
    out.append(common.emit(
        "bench_512_ablate", run, row="frame", frames=args.k,
        on_ms=r["on_ms"] / args.k, off_ms=r["off_ms"] / args.k,
        on_device_ms=dev1["on"], off_device_ms=dev1["off"],
        occlusion_pass_ms=(r["on_ms"] - r["off_ms"]) / args.k,
        events_reads_ms=[x / args.k for x in r["events_reads_ms"]], **base))

    calls = sweeps(run, vol, cam, grid)
    for name, fns in calls.items():
        if run.cuda:
            on, off = fns["on"](), fns["off"]()
            torch.cuda.synchronize(run.dev)
            if isinstance(on, torch.Tensor):
                on, off = (on,), (off,)
            if not all(torch.equal(a, b) for a, b in zip(on, off)):
                raise RuntimeError(f"{name} without the column skip differs from the default")
        r = alternated(run, fns, calls=args.calls)
        saved = None
        if r["on_device_ms"] is not None and r["off_device_ms"]:
            saved = 1.0 - r["on_device_ms"] / r["off_device_ms"]
        out.append(common.emit(
            "bench_512_ablate", run, row=f"{name}_column_skip", **r,
            device_share_saved_by_skip=saved, **base))
    return out


if __name__ == "__main__":
    main()
