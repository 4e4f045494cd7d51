"""Composed 1080p frames on a dense scene, without the CA step (the port's
counterpart of ``tools/bench_dense.py``)::

    [CA3D_SLICEGATE=1 | CA3D_MIP1=1] python -m cellularautomatons3d_tpu_torch.tools.bench_dense \\
        [gen] [k] [--reps R]
    python -m cellularautomatons3d_tpu_torch.tools.bench_dense --device cpu --small

The centre seed after ``gen`` generations (default 230, the dense line's
scene) at 256³ / 1920×1080 (``--small``: 32³, 64×32); ``k`` (default 20)
composed frames back to back through ``render_fast.raytrace_tiles`` with the
history carried (K1 in compose mode, the coarse mip rebuilt each frame as the
fused loop does), no CA step.  ``raytrace_tiles`` reads ``CA3D_SLICEGATE``
and ``CA3D_MIP1`` at every call, so K1's descents compare without a code
change.  The JAX tool's ``CA3D_BD_SHADOW``, ``CA3D_BD_NOSWEEP`` and
``CA3D_PREPASS`` splits are ``profile_frame``'s variants here.

Prints one JSON line: ms a frame by CUDA events (median and spread over
``--reps`` reads of ``k`` frames), device ms a frame
(``cuda_time_fn(queued=True)``), the population, the variables.  The JAX
tool chains the k frames in one ``jit`` and keeps a compile cache; eager
torch needs neither.
"""

from __future__ import annotations

import os

import torch

from ..ops.occupancy import coarse_occupancy
from ..render import render_fast
from . import common

KEYS = ("value", "device_ms", "population")


def main(argv=None) -> list[dict]:
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("gen", nargs="?", type=int, default=230, help="generations of the scene")
    ap.add_argument("k", nargs="?", type=int, default=20, help="frames a timed read")
    args = ap.parse_args(argv)
    run = common.Run(args)
    w, h = run.window
    grid = run.grid(256)
    vol = common.scene(grid, args.gen, run.dev)
    cam = common.cam(w, h)
    kw = dict(grid_size=grid, width=w, height=h)
    hist = [(torch.zeros((h, w, 3), device=run.dev),
             torch.full((h, w), -1, dtype=torch.int32, device=run.dev))]

    def frame():
        out = render_fast.raytrace_tiles(vol, coarse_occupancy(vol), cam, hist[0], **kw)
        hist[0] = (out[3], out[2])

    def frames():
        for _ in range(args.k):
            frame()

    ms = common.timed(run, frames, calls=1)
    k = args.k
    dev_ms = common.device_ms(run, frames, calls=1)
    rec = common.emit(
        "bench_dense", run,
        metric=f"{grid}^3 composed {w}x{h} frame, generation-{args.gen} scene",
        value=ms["ms"] / k, unit="ms", min_ms=ms["min_ms"] / k, max_ms=ms["max_ms"] / k,
        device_ms=None if dev_ms is None else dev_ms / k,
        frames=k, population=common.population(vol),
        slicegate=os.environ.get("CA3D_SLICEGATE", "0"), mip1=os.environ.get("CA3D_MIP1", "0"))
    return [rec]


if __name__ == "__main__":
    main()
