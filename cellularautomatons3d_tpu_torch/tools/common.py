"""What the attribution tools share: their options, scenes, camera, timers,
the kernels' launch counters and the JSON lines they print.

The scenes are the JAX tools' own: the centre seed under the default rule
(von Neumann B1,3/S0-6) after ``generations`` steps, seen from the initial
view at 1920×1080 with the light at (0.721, 1, 1), magnitude 5, cell size
0.85, roughness 0.29, base reflectivity 0.17, the position rainbow and
elapsed time 0.1 (:func:`cam`).

Times: :func:`timed` takes CUDA events around ``calls`` back-to-back calls
after a warm-up, ``reps`` times, and gives the median and the spread;
:func:`device_ms` the device's own time (``utils.metrics.cuda_time_fn`` with
``queued=True``: the host's enqueue excluded).  On the CPU (``--device cpu
--small``) the first reads the host's clock and the second is None: a CPU
run measures no device.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from .. import kernels
from ..models.automaton import AutomatonSpec
from ..ops import ca_step
from ..ops.loop import make_multi_step
from ..ops.occupancy import (
    coarse_occupancy_box_cuda, coarse_occupancy_cuda, coarse_occupancy_plane_cuda,
    occupied_box_cuda, plane_occupancy_cuda)
from ..ops.packing import pack_grid, seed_center
from ..render import render_fast, render_slab, renderer_fast
from ..render.renderer import RenderParams
from ..utils import mat4
from ..utils.config import EngineConfig
from ..utils.metrics import cuda_time_fn

WIDTH, HEIGHT = 1920, 1080
TRACE_ROOT = kernels.BUILD_DIR.parent / "traces"   # build/traces: traces by default
SMALL_WIDTH, SMALL_HEIGHT = 64, 32
SMALL_GRID = {256: 32, 512: 64, 1024: 64}   # the test size of each grid

LIGHT_POS = (0.721, 1.0, 1.0)
LIGHT_MAGNITUDE = 5.0
CELL_SIZE = 0.85
ROUGHNESS = 0.29
REFLECTIVITY = (0.17, 0.17, 0.17)
MATERIAL = (0.0, 0.0, 0.0)
ELAPSED = 0.1
# The extended lighting of PERF.md's lighting lines: soft shadows x4, GI.
LIGHTING = dict(soft_shadow_samples=4, indirect_lighting=True, light_radius=0.08)

# The launches one queued device-time read may hold: the stream sleeps while
# the host enqueues, and a call that queues more than the stream takes
# (600 launches did, 2,400 did not on an H100) cannot be read that way.
QUEUED_LAUNCHES = 400

# Each kernel's name in a trace (a substring of its demangled name) and the
# wrappers whose ``.launches`` count its launches.
FAMILIES = {
    "render_kernel": (render_fast.raytrace_cuda,),
    "ca_step_kernel": (ca_step.fires_plane_cuda, ca_step.step_packed_multistate_cuda,
                       ca_step.fires_slab_cuda, ca_step.step_slab_multistate_cuda),
    "age_masks_kernel": (ca_step.age_masks_cuda,),
    "primary_sweep_kernel": (render_slab.primary_sweep_cuda,),
    "shadow_sweep_kernel": (render_slab.shadow_sweep_cuda,),
    "shadow_multi_kernel": (render_slab.shadow_sweep_multi_cuda,),
    "cell_state_kernel": (render_slab.cell_state_cuda,),
    "occupied_box_kernel": (occupied_box_cuda,),
    "coarse_occupancy_kernel": (coarse_occupancy_cuda, coarse_occupancy_box_cuda,
                                coarse_occupancy_plane_cuda, plane_occupancy_cuda),
    "compose_kernel": (renderer_fast.compose_frame_cuda, renderer_fast.reproject_history_cuda),
    "prepass_kernel": (render_fast.prepass_cuda,),
    "lighting_queries_kernel": (render_slab.lighting_queries_cuda,),
    "lighting_level_kernel": (render_slab.lighting_level_cuda,),
    "lighting_shade_kernel": (render_slab.lighting_shade_cuda,),
}


def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu, with --small")
    ap.add_argument("--small", action="store_true",
                    help="test size: 32³ to 64³ grids, 64×32 pixels, the plain twins on the CPU")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed repeats, whose median and spread are reported")
    return ap


class Run:
    """A tool's device and size: ``grid(n)`` and ``window`` map the
    full-size scenario to the test size under ``--small``."""

    def __init__(self, args):
        self.dev = torch.device(args.device)
        if self.dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "the tools measure the card and torch.cuda.is_available() is false; "
                "--device cpu --small runs a tool at a test size on the plain twins")
        if self.dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.dev}")
        if self.dev.type == "cpu" and not args.small:
            raise ValueError("--device cpu runs only at the test size: add --small")
        self.small = bool(args.small)
        self.reps = max(1, int(args.reps))
        self.cuda = self.dev.type == "cuda"
        self.window = (SMALL_WIDTH, SMALL_HEIGHT) if self.small else (WIDTH, HEIGHT)

    def grid(self, n: int) -> int:
        return SMALL_GRID.get(n, n) if self.small else n

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.dev)


@functools.lru_cache(maxsize=1)
def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _jsonable(x):
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    raise TypeError(f"not JSON: {type(x)}")


def emit(tool: str, run: Run, **fields) -> dict:
    """Print one JSON line: the tool, its fields, the device and the card
    (None on the CPU), and the clock its times were read on."""
    rec = {"tool": tool, **fields,
           "device": torch.cuda.get_device_name(run.dev) if run.cuda else "cpu",
           "card": card() if run.cuda else None,
           "clock": "cuda events" if run.cuda else "host"}
    print(json.dumps(rec, default=_jsonable), flush=True)
    return rec


# --------------------------------------------------------------- scenes ---


def spec_of(grid: int) -> AutomatonSpec:
    return AutomatonSpec.from_config(EngineConfig(grid_size=grid))


def scene(grid: int, generations: int, device) -> torch.Tensor:
    """The centre seed after ``generations`` steps of the default rule:
    packed words int32 [n/32, n, n] on ``device``."""
    words = torch.from_numpy(pack_grid(seed_center(grid)).view(np.int32)).to(device)
    return make_multi_step(spec_of(grid), generations)(words)


def population(state: torch.Tensor) -> int:
    return int(np.unpackbits(state.cpu().numpy().view(np.uint8)).sum())


def cam(width: int, height: int, view=None, **kw) -> np.ndarray:
    """The kernels' camera vector of the JAX tools' scene (``pack_cam``)."""
    return render_fast.pack_cam(
        mat4.initial_view_matrix() if view is None else view, width, height, LIGHT_POS,
        LIGHT_MAGNITUDE, CELL_SIZE, ROUGHNESS, REFLECTIVITY, MATERIAL,
        elapsed_time=ELAPSED, **kw)


def render_params(width: int, height: int) -> RenderParams:
    """The JAX tools' and ``bench.py``'s ``RenderParams``: the initial view,
    static, gamma 2, temporal alpha 0.1."""
    view = mat4.initial_view_matrix()
    proj_view = mat4.multiply(mat4.initial_projection_matrix(width, height), mat4.inverse(view))
    f32 = np.float32
    return RenderParams(
        view_mat=np.asarray(view, f32), prev_view_mat=np.asarray(view, f32),
        prev_proj_view=np.asarray(proj_view, f32), elapsed_time=f32(ELAPSED),
        cell_size=f32(CELL_SIZE), temporal_alpha=f32(0.1), gamma=f32(2.0),
        roughness=f32(ROUGHNESS), base_reflectivity=np.asarray(REFLECTIVITY, f32),
        material_color=np.asarray(MATERIAL, f32), light_pos=np.asarray(LIGHT_POS, f32),
        light_magnitude=f32(LIGHT_MAGNITUDE), show_depth_overlay=f32(0.0),
    )


# --------------------------------------------------------------- timing ---


def timed(run: Run, fn, calls: int = 10, reps: int | None = None, warmup: int = 2,
          prepare=None) -> dict:
    """ms per call of ``calls`` back-to-back calls, ``reps`` times after
    ``warmup`` calls: the median, the least and the most, and every read.
    With ``prepare``, each warm-up call and each rep first makes the calls'
    arguments, ``fn(*prepare())``, outside the timed window."""
    def args():
        return () if prepare is None else prepare()

    for _ in range(warmup):
        fn(*args())
    run.sync()
    reads = []
    for _ in range(run.reps if reps is None else reps):
        a = args()
        run.sync()
        if run.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn(*a)
            end.record()
            end.synchronize()
            reads.append(start.elapsed_time(end) / calls)
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(*a)
            reads.append((time.perf_counter() - t0) * 1e3 / calls)
    return {"ms": statistics.median(reads), "min_ms": min(reads), "max_ms": max(reads),
            "reads_ms": reads}


def device_ms(run: Run, fn, calls: int = 20) -> float | None:
    """The device's ms per call, the host's enqueue excluded, or None on
    the CPU and for a call that queues more launches than the stream holds
    while it sleeps (then fewer calls are tried, down to one)."""
    if not run.cuda:
        return None
    while calls >= 1:
        try:
            return cuda_time_fn(fn, reps=calls, warmup=1, device=run.dev, queued=True)
        except RuntimeError:
            calls //= 4
    return None


# ------------------------------------------------------------- counters ---


def counts() -> dict:
    """Every kernel family's launches so far, by its wrappers' counters."""
    return {name: sum(w.launches for w in wrappers) for name, wrappers in FAMILIES.items()}


@contextlib.contextmanager
def counted():
    """The launches of each kernel family inside the block (a dict filled
    on exit, families with none left out)."""
    before = counts()
    out: dict = {}
    try:
        yield out
    finally:
        after = counts()
        out.update({k: after[k] - before[k] for k in after if after[k] != before[k]})


def families(kernels: dict) -> dict:
    """Launches by kernel family of a trace's ``{name: launches}``."""
    out = {}
    for fam in FAMILIES:
        n = sum(c for name, c in kernels.items() if fam in name)
        if n:
            out[fam] = n
    return out
