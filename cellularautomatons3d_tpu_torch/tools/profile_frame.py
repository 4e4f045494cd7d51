"""K1's variants on the card (the port's counterpart of
``tools/profile_frame.py``)::

    python -m cellularautomatons3d_tpu_torch.tools.profile_frame [variants...] [--reps R]
    python -m cellularautomatons3d_tpu_torch.tools.profile_frame --device cpu --small

One frame of K1 through ``render_fast.raytrace_tiles`` (non-compose, as the
JAX tool times it) on 256³ gen-80 at 1920×1080 (``--small``: 32³, 64×32),
the coarse mip made once outside the timed call.  Variants (all by
default):

* ``full``: the default frame (the hard shadow on);
* ``noshadow``: ``shadow=False`` (the primary sweep alone);
* ``nosweep``: no sweep at all, the floor of the split (ray set-up, shading
  and stores; ``raytrace_cuda(..., no_sweep=True)``, on the CPU the plain
  ``raytrace``);
* ``prepass``: ``use_prepass=True`` (K1 computing its blocks' patch masks);
* ``empty``: the default frame of an empty volume.

One JSON line per variant: ms by CUDA events (median and spread over
``--reps`` reads of ``--calls`` back-to-back frames), device ms
(``cuda_time_fn(queued=True)``), K1 launches a frame (its counter) and the
hit share.  The JAX tool's ``fori_loop`` of perturbed calls and its compile
cache are TPU transport workarounds and are not carried over.
"""

from __future__ import annotations

import torch

from ..ops.occupancy import coarse_occupancy
from ..render import render_fast
from . import common

VARIANTS = ("full", "noshadow", "nosweep", "prepass", "empty")
KEYS = ("ms", "device_ms", "k1_launches_per_frame")


def frame_call(run: common.Run, variant: str, vol, coarse, cam, grid: int):
    w, h = run.window
    kw = dict(grid_size=grid, width=w, height=h)
    if variant == "nosweep":
        trace = render_fast.raytrace_cuda if run.cuda else render_fast.raytrace
        return lambda: trace(vol, coarse, cam, no_sweep=True, **kw)
    opts = {"noshadow": dict(shadow=False), "prepass": dict(use_prepass=True)}.get(variant, {})
    return lambda: render_fast.raytrace_tiles(vol, coarse, cam, **opts, **kw)


def main(argv=None) -> list[dict]:
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help=f"of {', '.join(VARIANTS)} (default: all)")
    ap.add_argument("--calls", type=int, default=20, help="back-to-back frames a timed read")
    args = ap.parse_args(argv)
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}: choose from {VARIANTS}")
    run = common.Run(args)
    w, h = run.window
    grid = run.grid(256)
    vol = common.scene(grid, 80, run.dev)
    empty = torch.zeros_like(vol)
    volumes = {"scene": (vol, coarse_occupancy(vol)), "empty": (empty, coarse_occupancy(empty))}
    cam = common.cam(w, h)
    out = []
    for variant in args.variants or VARIANTS:
        v, coarse = volumes["empty" if variant == "empty" else "scene"]
        fn = frame_call(run, variant, v, coarse, cam, grid)
        with common.counted() as launched:
            idx = fn()[2]
        ms = common.timed(run, fn, calls=args.calls)
        out.append(common.emit(
            "profile_frame", run, variant=variant, grid=grid, generations=80, width=w, height=h,
            ms=ms["ms"], min_ms=ms["min_ms"], max_ms=ms["max_ms"],
            device_ms=common.device_ms(run, fn, calls=args.calls),
            k1_launches_per_frame=launched.get("render_kernel", 0),
            launches=launched, hit_share=float((idx >= 0).float().mean())))
    return out


if __name__ == "__main__":
    main()
