"""The one-bounce GI frame of the port cut into its parts, on the card (the
port's counterpart of ``tools/profile_gi.py`` and ``tools/profile_gi2.py``)::

    python -m cellularautomatons3d_tpu_torch.tools.profile_gi [--reps R]
    python -m cellularautomatons3d_tpu_torch.tools.profile_gi --device cpu --small

256³ gen-80 at 1920×1080 (``--small``: 32³, 64×32), full quality: soft
shadows ×4, GI, light radius 0.08, as ``render_slab.lighting_passes`` runs
it (one K2 launch for the 8 occlusion queries, one K3 launch for the 4
lookups).  The parts, each called on the same inputs:

* ``primary``: K1 without its hard shadow (``render_fast.raytrace_tiles(...,
  shadow=False)``, as the lighting frame calls it) and the hit geometry;
* ``queries``: the 8 occlusion queries and the 4 slots' geometry
  (``render_slab.lighting_queries``: the soft-shadow jitter, the neighbour
  cells and their points);
* ``lookups``: the 4 neighbour-state lookups (``render_slab.cell_state_batch``:
  K3 with its operands);
* ``occlusion``: the 8 queries' occlusion batch
  (``render_slab.shadow_occlusion_batch``: K2 with
  ``stack_occlusion_queries``), and ``occlusion_k5`` the same batch under
  ``CA3D_OCC_SWEEP=0`` (K5, two launches of 4 queries read in place);
* ``brdf``: the double BRDF of the 4 slots (the torch shading of
  ``lighting_passes``: each slot's reflected light and its bounce to the
  pixel);
* ``lighting_passes``: the whole of it (queries, K2, K3, the BRDF).

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

from ..ops.occupancy import coarse_occupancy
from ..render import render_fast, render_slab
from ..render.render_fast import P_LIGHT, P_LMAG, P_O
from ..render.intersect import device_vec
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
    coarse = coarse_occupancy(vol)
    prepped = render_slab.prep_volume(vol, coarse)

    def primary():
        rgb, depth, idx = render_fast.raytrace_tiles(vol, coarse, cam, shadow=False, **kw)
        return render_slab._hit_geometry(cam, idx, depth, grid, w, h)

    q, origin, coords, found, _ = primary()
    lq = dict(soft_k=SOFT, gi=True, **kw)

    def queries():
        return render_slab.lighting_queries(cam, q, origin, coords, found, **lq)

    qs, slots, _ = queries()
    lookups_in = [(n_cl, ok) for n_cl, _, _, ok in slots]

    def lookups():
        return render_slab.cell_state_batch(lookups_in, prepped, **kw)

    def occlusion():
        return render_slab.shadow_occlusion_batch(cam, qs, prepped, **kw)

    def occlusion_k5():
        with occ_sweep("0"):
            return render_slab.shadow_occlusion_batch(cam, qs, prepped, **kw)

    states = lookups()
    occs = occlusion()
    dev = q.device
    light = device_vec(cam[P_LIGHT : P_LIGHT + 3], dev)
    o = device_vec(cam[P_O : P_O + 3], dev)
    shade = render_slab._shader(cam, grid)

    def brdf():
        lmag3 = torch.full_like(q, float(cam[P_LMAG]))
        total = torch.zeros_like(q)
        for (n_cl, n_origin, n_point, ok_geo), st, occluded in zip(slots, states, occs[SOFT:]):
            ok = ok_geo & (st == 1)
            reflected = render_slab._occlusion_quotient(occluded)[..., None] * shade(
                n_point, n_origin, n_cl, q, lmag3, light)
            bounce = shade(q, origin, coords, o, reflected, n_point)
            total = total + torch.where(ok[..., None], bounce, 0.0)
        return total

    def lighting_passes():
        return render_slab.lighting_passes(cam, q, origin, coords, found, prepped, **lq)

    return {"primary": primary, "queries": queries, "lookups": lookups,
            "occlusion": occlusion, "occlusion_k5": occlusion_k5, "brdf": brdf,
            "lighting_passes": lighting_passes}


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
    ranges = trace_summary.by_range(str(out_dir / "trace.json"))
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
