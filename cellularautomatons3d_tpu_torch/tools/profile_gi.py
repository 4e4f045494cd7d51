"""The one-bounce GI frame of the port cut into its parts, on the card (the
port's counterpart of ``tools/profile_gi.py`` and ``tools/profile_gi2.py``)::

    python -m cellularautomatons3d_tpu_torch.tools.profile_gi [--reps R]
    python -m cellularautomatons3d_tpu_torch.tools.profile_gi --device cpu --small

256³ gen-80 at 1920×1080 (``--small``: 32³, 64×32), full quality: soft
shadows ×4, GI, light radius 0.08, as ``render_slab.lighting_passes`` runs
it on K1's unshadowed frame (the queries kernel, one K2 launch for the 8
occlusion queries, one K3 launch for the 4 lookups, the shade kernel).  The
parts, each called on the same inputs:

* ``primary``: K1 without its hard shadow (``render_fast.raytrace_tiles(...,
  shadow=False)``, as the lighting frame calls it);
* ``queries``: the 8 occlusion queries and the 4 slots' geometry as K2's
  stacked operands (``render_slab.lighting_queries_cuda``, the queries
  kernel: the hit geometry, the soft-shadow jitter, the neighbour cells and
  their points), and ``queries_plain`` its twin
  (``lighting_queries_stacked``, eager torch);
* ``lookups``: the 4 neighbour-state lookups (``render_slab.slot_states``:
  K3 on the queries' slot rows in place);
* ``occlusion``: the 8 queries' occlusion flags
  (``render_slab.occlusion_flags``: K2 on the stacked operands), and
  ``occlusion_k5`` the same under ``CA3D_OCC_SWEEP=0`` (K5, two launches
  of 4 queries read in place);
* ``brdf``: the shading (``render_slab.lighting_shade_cuda``, the shade
  kernel: the soft occlusion quotient, each slot's reflected light and its
  bounce to the pixel, on K1's rgb), and ``brdf_plain`` its twin
  (``lighting_shade``, eager torch);
* ``lighting_passes``: the whole of it (queries, K2, K3, shade).

On the CPU (``--small``) the kernels' parts run their twins.

Each part: its ms by CUDA events (median and spread over ``--reps``), its
device ms (``cuda_time_fn(queued=True)``) and, from one ``torch.profiler``
trace in which each part runs once inside a ``record_function`` range of
the tool's own, its device ms, launches and kernels by name
(``trace_summary.by_range``).  One JSON line per part.

``tools/profile_gi2.py`` exists because XLA's common-subexpression
elimination collapsed the repeated identical calls of ``profile_gi.py``;
eager torch has no such pass, so every call here runs, and one module does
both.  The JAX tools' ``fori_loop`` perturbations and compile cache are TPU
transport workarounds and are not carried over.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import torch

from ..render import render_fast, render_slab
from ..utils.profiling import profile_trace
from . import common, trace_summary

KEYS = ("ms", "trace_device_ms", "trace_launches")
SOFT = 4


@contextlib.contextmanager
def occ_sweep(value):
    saved = os.environ.get("CA3D_OCC_SWEEP")
    os.environ["CA3D_OCC_SWEEP"] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("CA3D_OCC_SWEEP", None)
        else:
            os.environ["CA3D_OCC_SWEEP"] = saved


def parts(run: common.Run, vol, cam, grid: int) -> dict:
    """The GI frame's parts as calls on the same inputs."""
    w, h = run.window
    kw = dict(grid_size=grid, width=w, height=h)
    prepped = render_slab.prep_volume(vol)
    coarse = prepped.coarse
    light = render_slab.Lighting(soft_k=SOFT, gi=True)

    def primary():
        return render_fast.raytrace_tiles(vol, coarse, cam, shadow=False, **kw)

    rgb, depth, idx = primary()
    queries_fn = render_slab.lighting_queries_cuda if run.cuda else (
        render_slab.lighting_queries_stacked)
    shade_fn = render_slab.lighting_shade_cuda if run.cuda else render_slab.lighting_shade

    def queries():
        return queries_fn(cam, idx, depth, light, **kw)

    def queries_plain():
        return render_slab.lighting_queries_stacked(cam, idx, depth, light, **kw)

    ops = queries()

    def lookups():
        return render_slab.slot_states(ops, SOFT, prepped, grid_size=grid)

    def occlusion():
        return render_slab.occlusion_flags(cam, ops, prepped, grid_size=grid)

    def occlusion_k5():
        with occ_sweep("0"):
            return render_slab.occlusion_flags(cam, ops, prepped, grid_size=grid)

    states = lookups()
    flags = occlusion()

    def brdf():
        return shade_fn(cam, idx, depth, flags, states, light, rgb=rgb, **kw)

    def brdf_plain():
        return render_slab.lighting_shade(cam, idx, depth, flags, states, light, rgb=rgb, **kw)

    def lighting_passes():
        return render_slab.lighting_passes(cam, idx, depth, prepped, light, rgb=rgb, **kw)

    return {"primary": primary, "queries": queries, "queries_plain": queries_plain,
            "lookups": lookups, "occlusion": occlusion, "occlusion_k5": occlusion_k5,
            "brdf": brdf, "brdf_plain": brdf_plain, "lighting_passes": lighting_passes}


def main(argv=None) -> list[dict]:
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=5, help="back-to-back calls a timed read")
    ap.add_argument("--out", default=None,
                    help="directory of trace.json (default build/traces/profile_gi)")
    args = ap.parse_args(argv)
    run = common.Run(args)
    w, h = run.window
    grid = run.grid(256)
    t0 = time.perf_counter()
    vol = common.scene(grid, 80, run.dev)
    cam = common.cam(w, h, light_radius=common.LIGHTING["light_radius"])
    calls = parts(run, vol, cam, grid)
    run.sync()
    setup_s = time.perf_counter() - t0
    for fn in calls.values():  # warm-up
        fn()
    run.sync()
    out_dir = Path(args.out) if args.out else common.TRACE_ROOT / (
        "profile_gi_small" if run.small else "profile_gi")
    with profile_trace(str(out_dir)):
        for name, fn in calls.items():
            with torch.profiler.record_function(name):
                fn()
    ranges = trace_summary.by_range(str(out_dir / "trace.json"), names=set(calls))
    out = []
    for name, fn in calls.items():
        ms = common.timed(run, fn, calls=args.calls)
        r = ranges.get(name, {"device_ms": 0.0, "launches": 0, "kernels": {}})
        kernels = sorted(({"name": k, "device_ms": v[0], "launches": v[1]}
                          for k, v in r["kernels"].items()), key=lambda x: -x["device_ms"])
        out.append(common.emit(
            "profile_gi", run, part=name, grid=grid, generations=80, width=w, height=h,
            setup_s=setup_s, ms=ms["ms"], min_ms=ms["min_ms"], max_ms=ms["max_ms"],
            device_ms=common.device_ms(run, fn, calls=max(1, common.QUEUED_LAUNCHES
                                                          // max(1, r["launches"]))),
            trace_device_ms=r["device_ms"], trace_launches=r["launches"], kernels=kernels,
            unattributed_launches=ranges.get("unattributed", {}).get("launches", 0)))
    return out


if __name__ == "__main__":
    main()
