"""The benchmark of the PyTorch and CUDA port: one cell, one run.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
the Engine's settings, the guarantees, the limits of the comparison) and a
traffic mix (``traffic/<name>.json``: the window's loop and its
parameters).  Per-layer metrics are ``metrics/<name>.json`` (each names its
reader in ``readers/``), kernel families ``kernels/<name>.json`` (a
substring of the kernels' names in a trace and the wrappers whose
``.launches`` count them).  Everything is found by name, so a later cell,
mix, metric or family is a new file and a new entry.

A run: the Engine from the seed (the reference's random 5³ start), the
mix's start generation grown on the card, a warm-up of every shape the
window uses, then ``seconds`` of the mix's loop back to back:

* ``fused``: ``Engine.run_fused(frames_per_call, reset_every)`` calls, the
  camera static;
* ``tick``: ``Engine.tick()`` once a frame at the Engine's cadence, the
  camera set before each tick to the next pose of an orbit about the
  volume's centre, the start scene restored every ``restore_every`` ticks,
  a CUDA event recorded after each tick.

Then the check (:func:`check`): the plain reference of ``reference/``
recomputes sampled answers of the timed path from the inputs the harness
made (the seed, the poses, the clock) and, for the temporal history that
each frame carries, from the program's history before that answer.  With
``trace`` a bounded stretch after the warm-up runs under ``torch.profiler``
first, and the cell's per-layer metrics are read from it.
"""

from __future__ import annotations

import importlib
import json
import math
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

import trace_arith
from readers import Context
from reference import ca, frozen

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cellularautomatons3d_tpu")
CHECK_KEYS = ("state_words_differ", "hit_ids_differ", "frame_max_rel_diff",
              "history_max_rel_diff")


class HarnessError(RuntimeError):
    """A run that cannot report: no card, a forbidden import, a trace that
    lost kernel events.  ``code`` is the process's exit code."""

    def __init__(self, msg, code):
        super().__init__(msg)
        self.code = code


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# -------------------------------------------------------------- cells ---


class Cell(NamedTuple):
    name: str
    entry: dict
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str, bench_path: Path | None = None) -> Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, mix and the
    metrics it reports."""
    bench = load_json(bench_path or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(ROOT / cfg["file"])
    mix = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if name in m.get("workloads", [name] if m["moves"] in names else [])]
    return Cell(name, w, config, mix, e2e, per)


def engine_settings(config: dict, mix: dict, seed: int, small: dict | None) -> dict:
    """The Engine's settings of a run: the configuration's, the mix's start
    (``scene``: ``random``, the reference's random 5³ block from the seed,
    or ``centre``, its one live centre cell), the seed, and at a test size
    the grid and window of ``small``."""
    e = dict(config["engine"], seed=int(seed),
             random_initial_state=mix["scene"] == "random")
    if small:
        e.update(grid_size=small["grid"], width=small["width"], height=small["height"])
    return e


# ------------------------------------------------------------ inputs ---


def orbit_pose(degrees: float, radius: float, height: float) -> np.ndarray:
    """The camera-to-world view of a camera on a circle of ``radius`` about
    the volume's centre at ``height``, ``degrees`` round from the initial
    view's side (+z), looking at the axis: float32 [4, 4]."""
    a = math.radians(degrees)
    c, s = math.cos(a), math.sin(a)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float32)
    m[:3, 3] = np.array([radius * s, height, radius * c], np.float32)
    return m


def poses(mix: dict) -> list:
    step = float(mix.get("orbit_degrees_per_frame", 0.0))
    n = int(mix.get("orbit_poses", 1))
    r, h = float(mix.get("orbit_radius", 0.75)), float(mix.get("orbit_height", 0.0))
    return [orbit_pose(step * k, r, h) for k in range(n)]


def render_params(e: dict, view, prev_view, t_ms: float) -> frozen.Params:
    """The frame's parameters as the reference works them out from the
    configuration, the pose, the previous pose (None: the camera's first
    frame, whose previous view-projection is the identity) and the clock."""
    f32 = np.float32
    light = e["light"]
    if light.get("animate"):
        raise ValueError("an animated light is not in the reference")
    ppv = (np.eye(4, dtype=f32) if prev_view is None
           else frozen.proj_view(prev_view, e["width"], e["height"]))
    return frozen.Params(
        view_mat=np.asarray(view, f32), prev_proj_view=ppv, elapsed_time=f32(t_ms * 1e-4),
        cell_size=f32(e["cell_size"]), temporal_alpha=f32(e["temporal_alpha"]),
        gamma=f32(e["gamma"]), roughness=f32(e["roughness"]),
        base_reflectivity=np.asarray(e["base_reflectivity"], f32),
        material_color=np.asarray(e["material_color"], f32),
        light_pos=np.asarray(light["position"], f32), light_magnitude=f32(light["magnitude"]),
        show_depth_overlay=f32(1.0 if e["show_depth_overlay"] else 0.0),
        light_radius=f32(e["light_radius"]), emissive_color=np.asarray(e["emissive_color"], f32),
        emissive_strength=f32(e["emissive_strength"]))


# ------------------------------------------------------------- loops ---


class Sample(NamedTuple):
    """One answer of the timed path, kept for the check: what went in
    (the state, the history, the clock, the pose) and what came out."""
    index: int
    state_before: torch.Tensor
    history_before: tuple | None    # None: the Engine's first frame
    t_ms: float
    view: np.ndarray
    prev_view: np.ndarray | None
    state_after: torch.Tensor
    history_after: tuple
    frame: torch.Tensor


class Fused:
    """``Engine.run_fused`` calls: ``frames_per_call`` frames, the state
    restored every ``reset_every``, the camera static."""

    def __init__(self, eng, mix, seed):
        self.eng, self.mix = eng, mix
        self.frames = int(mix["frames_per_call"])
        self.reset = int(mix["reset_every"])
        self.dt = 16.667
        self.calls = 0
        self.t_ms = 0.0
        self.view = poses(mix)[0]  # the orbit's first pose: the Engine's initial view

    def warmup_units(self):
        return int(self.mix["warmup_calls"])

    def trace_units(self):
        return int(self.mix["trace_calls"])

    def frames_of(self, units):
        return units * self.frames

    def unit(self, keep=False):
        eng = self.eng
        before = (eng.state, eng.history, self.t_ms, self.calls == 0)
        frame = eng.run_fused(self.frames, reset_every=self.reset)
        self.t_ms += self.frames * self.dt
        self.calls += 1
        if not keep:
            return None
        state, hist, t_ms, first = before
        return Sample(self.calls - 1, state, None if first else tuple(hist), t_ms, self.view,
                      self.view, eng.state, tuple(eng.history), frame)


class Tick:
    """``Engine.tick`` once a frame along an orbit of poses, the start
    scene restored every ``restore_every`` ticks.  The seed picks the pose
    the orbit starts from, in steps of ``restore_every``: every seed runs
    the same pairs of pose and scene, in another order."""

    def __init__(self, eng, mix, seed):
        self.eng, self.mix = eng, mix
        self.dt = float(mix["dt_ms"])
        self.restore = int(mix["restore_every"])
        self.poses = poses(mix)
        self.phase = self.restore * int(np.random.default_rng([seed, 1]).integers(
            len(self.poses) // self.restore))
        self.scene = eng.state
        self.j = 0
        self.t_ms = 0.0

    def warmup_units(self):
        return int(self.mix["warmup_ticks"])

    def trace_units(self):
        return int(self.mix["trace_ticks"])

    def frames_of(self, units):
        return units

    def pose(self, j: int) -> np.ndarray:
        return self.poses[(self.phase + j) % len(self.poses)]

    def unit(self, keep=False):
        eng, j = self.eng, self.j
        view = self.pose(j)
        eng.camera.view_mat = view
        if j % self.restore == 0:
            eng.state = self.scene
        before = (eng.state, eng.history)
        frame = eng.tick(self.dt)
        self.t_ms += self.dt
        self.j += 1
        if not keep:
            return None
        prev = None if j == 0 else self.pose(j - 1)
        return Sample(j, before[0], None if j == 0 else tuple(before[1]), self.t_ms, view, prev,
                      eng.state, tuple(eng.history), frame)


LOOPS = {"fused": Fused, "tick": Tick}


# ------------------------------------------------------------ window ---


class Window(NamedTuple):
    frames: int
    frame_ms: float
    frame_p95_ms: float | None
    sample: Sample
    quarters: list    # frame ms over each quarter of the window's units


def run_window(loop, seconds: float, pick: int, cuda: bool) -> Window:
    """The loop's units back to back until ``seconds`` have passed on the
    host clock.  Keeps the answer of unit ``pick`` (the last unit where the
    window ends before it).  Frame times are taken from CUDA events: from
    one before the first unit to the completion of the last, and between
    consecutive units' completions (per frame for the tick loop); on the
    CPU from the host clock."""
    per_unit_frames = loop.frames_of(1)
    marks = []
    sample = last = None
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    else:
        start = time.perf_counter()
    t_end = time.perf_counter() + seconds
    i = 0
    while time.perf_counter() < t_end:
        got = loop.unit(keep=True)
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())
        if i == pick:
            sample = got
        last = got
        i += 1
    if cuda:
        marks[-1].synchronize()
        ends = [start.elapsed_time(m) for m in marks]
    else:
        ends = [(m - start) * 1e3 for m in marks]
    frames = i * per_unit_frames
    gaps = [b - a for a, b in zip([0.0] + ends[:-1], ends)]
    p95 = None
    if per_unit_frames == 1 and len(gaps) >= 20:
        p95 = statistics.quantiles(gaps, n=20, method="inclusive")[18]
    cuts = [0.0] + [ends[(len(ends) * q) // 4 - 1] for q in (1, 2, 3, 4)]
    unit_counts = [(len(ends) * q) // 4 - (len(ends) * (q - 1)) // 4 for q in (1, 2, 3, 4)]
    quarters = [(b - a) / max(1, n * per_unit_frames)
                for a, b, n in zip(cuts[:-1], cuts[1:], unit_counts)]
    return Window(frames, ends[-1] / frames, p95, sample if sample is not None else last,
                  quarters)


# --------------------------------------------------------- the trace ---


def counters() -> dict:
    """Each kernel family's launches so far, by its wrappers' counters."""
    out = {}
    for path in sorted((HERE / "kernels").glob("*.json")):
        fam = load_json(path)
        n = 0
        for ref in fam["counters"]:
            mod, attr = ref.split(":")
            n += getattr(importlib.import_module(mod), attr).launches
        out[fam["match"]] = n
    return out


def lost_launches(launches_by_name: dict, launched: dict) -> dict:
    """The kernel families whose launches in a trace (``{kernel name:
    launches}``) fall short of the launches their counters saw: {family:
    (traced, launched)}."""
    lost = {}
    for fam, n in launched.items():
        seen = sum(c for name, c in launches_by_name.items() if fam in name)
        if seen < n:
            lost[fam] = (seen, n)
    return lost


def per_layer_metrics(cell: Cell, summary: dict, frames: int, engine: dict, peaks) -> dict:
    """The cell's per-layer metrics that their readers find in the
    summary of a traced stretch of ``frames`` frames."""
    ctx = Context(summary, frames, engine, peaks)
    metrics = {}
    for m in cell.per_layer:
        spec = load_json(HERE / "metrics" / f"{m['name']}.json")
        v = importlib.import_module(f"readers.{spec['reader']}").read(ctx, spec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return metrics


def traced_stretch(loop, units: int, cell: Cell, engine: dict, cuda: bool):
    """Trace ``units`` of the loop under ``torch.profiler``; check the
    trace against the launch counters and read the cell's per-layer
    metrics.  Returns (metrics, busy_s, window_s, breakdown)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    before = counters()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(units):
            loop.unit()
        if cuda:
            torch.cuda.synchronize()
    after = counters()
    tmp = Path(tempfile.mkdtemp(prefix="ca3d_trace_"))
    try:
        path = tmp / "trace.json"
        prof.export_chrome_trace(str(path))
        frames = loop.frames_of(units)
        summary = trace_arith.summarize(str(path), frames=frames, top=1 << 30, gaps=10)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lost = lost_launches(summary["launches_by_name"],
                         {k: after[k] - before[k] for k in after})
    if lost:
        raise HarnessError("the trace holds fewer launches than the counters "
                           f"(family: traced, launched): {lost}", 4)
    peaks = load_json(HERE / "peaks.json").get(torch.cuda.get_device_name(0)) if cuda else None
    metrics = per_layer_metrics(cell, summary, frames, engine, peaks)
    breakdown = {
        "device_ops": [[k["name"], k["device_ms"] / 1e3] for k in summary["kernels"][:10]],
        "idle_gaps": [[g["host_op"] or "none", g["ms"] / 1e3] for g in summary["gaps"][:10]],
    }
    return metrics, summary["busy_ms"] / 1e3, summary["window_ms"] / 1e3, breakdown


# --------------------------------------------------------- the check ---


class NotInReference(NotImplementedError):
    """A configuration whose frames take a path the reference does not
    replay: raised by :func:`frame_path` when the run starts, before the
    Engine is built."""


K1_MAX_GRID = 256   # render_fast.MAX_GRID: above it every frame takes the sliced path


def frame_path(e: dict, loop: str) -> str:
    """The frame path a configuration's timed loop runs, as
    ``renderer_fast.make_fused_loop`` (``fused``) and ``render_frame_fast``
    (``tick``) choose it from the settings: ``k1`` (the fused loop's K1
    compose branch), ``k1_lit`` (K1, then the lighting passes where the
    configuration has them, then the composition) or ``sliced`` (K4 and the
    lighting passes, then the composition).  Raises :class:`NotInReference`
    for what the reference leaves out: the temporal lighting mode, the fused
    loop's extended frame (soft shadows or one-bounce GI at ≤ 256³, composed
    in the shade kernel), an animated light, and the rules
    :func:`reference.ca.rule_of` does not hold."""
    if e["gi_temporal"]:
        raise NotInReference("the temporal lighting mode (gi_temporal) is not in the reference")
    if e["light"].get("animate"):
        raise NotInReference("an animated light is not in the reference")
    try:
        ca.rule_of(e)
    except NotImplementedError as err:
        raise NotInReference(str(err)) from err
    if int(e["grid_size"]) > K1_MAX_GRID:
        return "sliced"
    soft, gi = int(e["soft_shadow_samples"]) > 1, bool(e["indirect_lighting"])
    if loop == "tick":
        return "k1_lit"
    if not soft and not gi:
        return "k1"
    if gi and int(e["indirect_bounces"]) > 1:
        return "k1_lit"
    raise NotInReference("the fused loop's extended frame (renderer_fast._ext_frame: soft "
                         "shadows or one-bounce GI at 256^3 and below) is not in the reference")


def _lighting(e: dict, sliced: bool = False):
    """The lighting passes a configuration's frames run, or None for K1's
    hard-shadowed frame alone.  The sliced frame always runs them, with the
    hard shadow as its one direct-shadow query where there are no soft
    shadows."""
    soft = int(e["soft_shadow_samples"])
    if sliced:
        return frozen.Lighting(soft_k=soft, gi=bool(e["indirect_lighting"]),
                               bounces=max(1, int(e["indirect_bounces"])))
    if soft <= 1 and not e["indirect_lighting"]:
        return None
    return frozen.Lighting(soft_k=soft if soft > 1 else None, gi=bool(e["indirect_lighting"]),
                           bounces=max(1, int(e["indirect_bounces"])))


def _zero_history(e: dict, device):
    return (torch.zeros((e["height"], e["width"], 3), dtype=torch.float16, device=device),
            torch.full((e["height"], e["width"]), -1, dtype=torch.int32, device=device))


class Reference:
    """The reference's answers: the states from the seed, each frame from
    its state, parameters and the history before it."""

    def __init__(self, engine: dict, mix: dict, seed: int, device):
        self.e, self.mix, self.dev = engine, mix, device
        self.rule = ca.rule_of(engine)
        self.path = frame_path(engine, mix["loop"])
        period = int(mix.get("reset_every") or mix.get("restore_every"))
        start = ca.seed_block(engine["grid_size"], seed) if engine["random_initial_state"] \
            else ca.seed_centre(engine["grid_size"])
        self.states = ca.scenes(start, self.rule, int(mix["start_generation"]), period, device)
        self.light = _lighting(engine, self.path == "sliced")
        self._traced = {}
        self._shaded = {}

    def _scene(self, gen: int):
        """(visibility plane, age planes or None) of generation ``gen``."""
        state = self.states[gen]
        return ca.visible(state), (state if self.rule["states"] > 2 else None)

    def _trace(self, gen: int, cam):
        # K1's traced frame does not read the clock: frames of one pose share it.
        untimed = cam.copy()
        untimed[frozen.P_TIME] = 0.0
        key = (gen, untimed.tobytes(), frozen.FLOAT)
        if key not in self._traced:
            e = self.e
            vol, ages = self._scene(gen)
            self._traced[key] = frozen.k1_trace(
                vol, cam, grid_size=e["grid_size"], width=e["width"],
                height=e["height"], shadow=int(e["soft_shadow_samples"]) <= 1, ages=ages,
                total_states=self.rule["states"])
        return self._traced[key]

    def _frame(self, gen: int, cam):
        """trace_shaded's (light, depth, ids) of generation ``gen``: K1 with
        the emissive light or the lighting passes, or the sliced frame."""
        keyed = cam.copy()
        if self.light is None or (self.light.soft_k or 0) <= 1:
            keyed[frozen.P_TIME] = 0.0     # only soft-shadow samples read the clock
        key = (gen, keyed.tobytes(), frozen.FLOAT)
        if key in self._shaded:
            return self._shaded[key]
        e = self.e
        kw = dict(grid_size=e["grid_size"], width=e["width"], height=e["height"])
        vol, ages = self._scene(gen)
        if self.path == "sliced":
            out = frozen.sliced_trace(vol, cam, self.light, ages, total_states=self.rule["states"],
                                      **kw)
        else:
            tr = self._trace(gen, cam)
            if self.light is None:
                rgb = frozen.with_emissive(cam, tr)
            else:
                rgb = frozen.lighting_passes(cam, tr.idx, tr.depth, vol, self.light, tr.rgb, **kw)
            out = (rgb, tr.depth, tr.idx)
        self._shaded[key] = out
        return out

    def fused(self, s: Sample):
        """(state before, state after, frame, history colour, ids) of a
        fused call: K1's compose branch, or ``render_frame_fast`` a frame
        (the sliced path, multi-bounce GI) with the history in float16
        between frames.  The camera and the clock are fixed within a
        call."""
        e, mix = self.e, self.mix
        f, r = int(mix["frames_per_call"]), int(mix["reset_every"])
        p = render_params(e, s.view, s.view, s.t_ms)
        cam = frozen.cam_vec(p, e["width"], e["height"])
        hist = s.history_before or _zero_history(e, self.dev)
        pres = None
        if self.path != "k1":
            color, ids = hist
            for i in range(f):
                rgb, depth, idx = self._frame(i % r + 1, cam)
                pres, color = frozen.compose_frame(color, ids, rgb, depth, idx, p, e["width"],
                                                   e["height"], True)
                ids = idx
            return self.states[0], self.states[f % r], pres, color, ids
        prev, prev_idx = hist[0].to(frozen.FLOAT), hist[1]
        for i in range(f):
            tr = self._trace(i % r + 1, cam)
            pres, prev = frozen.k1_compose(cam, tr, prev, prev_idx)
            prev_idx = tr.idx
        return self.states[0], self.states[f % r], pres, prev.to(torch.float16), prev_idx

    def tick(self, s: Sample):
        """(state before, state after, frame, history colour, ids) of a
        tick: K1 and the lighting passes where the configuration has them,
        or the sliced frame, then the composition over the history before
        it."""
        e, mix = self.e, self.mix
        gen, stepped = tick_generation(s.index, float(mix["dt_ms"]),
                                       float(e["compute_step_duration_ms"]),
                                       int(mix["restore_every"]))
        p = render_params(e, s.view, s.prev_view, s.t_ms)
        cam = frozen.cam_vec(p, e["width"], e["height"])
        rgb, depth, idx = self._frame(gen, cam)
        hist = s.history_before or _zero_history(e, self.dev)
        static = s.prev_view is not None and np.array_equal(s.view, s.prev_view)
        pres, color = frozen.compose_frame(hist[0], hist[1], rgb, depth, idx, p,
                                           e["width"], e["height"], static)
        self._traced.clear()
        self._shaded.clear()
        return self.states[gen], self.states[gen + stepped], pres, color, idx


def tick_generation(j: int, dt: float, step_ms: float, restore: int) -> tuple[int, int]:
    """(generations since the last restore at tick ``j``'s frame, 1 if the
    tick steps after it): the reference app's cadence, one step each time
    the frame time accumulated since the last step reaches ``step_ms``
    (main_pathtraced.js:1833-1850), from the first tick on."""
    acc, gen, stepped = 0.0, 0, 0
    for i in range(j + 1):
        if i % restore == 0:
            gen = 0
        acc += dt
        stepped = int(acc >= step_ms)
        if stepped:
            acc = 0.0
        if i < j:
            gen += stepped
    return gen, stepped


def _max_rel(a: torch.Tensor, b: torch.Tensor, same: torch.Tensor) -> float:
    """The largest |a − b| / max(|b|, 1) over the pixels ``same`` [H, W]
    (``b`` the reference): an absolute gap up to 1, a relative one above,
    where the light of a bright pixel runs past 1 and a float16 step with
    it.  NaN on both sides agrees, NaN on one side is an infinite gap."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    d = torch.where(nan_a & nan_b, 0.0, (a - b).abs() / torch.clamp(b.abs(), min=1.0))
    d = torch.where(nan_a ^ nan_b, math.inf, d)
    d = torch.where(same[..., None], d, 0.0)
    return float(d.max())


def compare(prog, ref) -> dict:
    """The numbers compared for one answer: (state before, state after,
    frame, history colour, ids) of the program against the reference's."""
    same = prog[4] == ref[4]
    return {
        "state_words_differ": int((prog[0] != ref[0]).sum()) + int((prog[1] != ref[1]).sum()),
        "hit_ids_differ": int((~same).sum()),
        "frame_max_rel_diff": _max_rel(prog[2], ref[2], same),
        "history_max_rel_diff": _max_rel(prog[3], ref[3], same),
    }


def check(cell: Cell, engine: dict, seed: int, samples: list, device,
          control=None) -> list[dict]:
    """The readings of each sampled answer against the reference.  With
    ``control`` (a torch dtype) the reference computed in that precision
    stands in the program's place, on the same inputs (the states are the
    reference's)."""
    ref = Reference(engine, cell.mix, seed, device)
    kind = cell.mix["loop"]
    out = []
    for s in samples:
        want = getattr(ref, kind)(s)
        if control is None:
            got = (s.state_before, s.state_after, s.frame, s.history_after[0],
                   s.history_after[1])
        else:
            with frozen.precision(control):
                got = getattr(ref, kind)(s)
        out.append(compare(got, want))
    return out


def _finite(v):
    """A reading as JSON takes it: an infinite gap as float32's largest."""
    return v if math.isfinite(v) else 3.4028234663852886e38


def verdict(config: dict, readings: list[dict]) -> tuple[bool, int, dict]:
    """(correct, answers that failed, {number: (worst reading, limit)})."""
    limits = config["limits"]
    worst = {k: max(r[k] for r in readings) for k in CHECK_KEYS}
    failed = sum(any(r[k] > limits[k] for k in CHECK_KEYS) for r in readings)
    return failed == 0, failed, {k: (worst[k], limits[k]) for k in CHECK_KEYS}


# --------------------------------------------------------------- run ---


def run(name: str, seed: int, seconds: float, trace: bool, t0: float, *,
        device: str = "cuda", small: dict | None = None, bench_path: Path | None = None,
        control=None, keep_samples: bool = False) -> tuple[dict, dict]:
    """One run of a cell: (the result line's record, its last key
    ``checks``; extras: the readings of each checked answer and, with
    ``keep_samples``, the answers)."""
    cuda = device == "cuda"
    cell = load_cell(name, bench_path)
    if small and small.get("mix"):
        cell = cell._replace(mix={**cell.mix, **small["mix"]})
    if cuda:
        chips = int(cell.entry["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise HarnessError(f"the cell needs {chips} CUDA device(s); torch sees "
                               f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                               2)
        torch.set_num_threads(1)
    from cellularautomatons3d_tpu_torch import Engine, EngineConfig

    def sync():
        if cuda:
            torch.cuda.synchronize()

    stages = [("imports", time.perf_counter() - t0)]
    e = engine_settings(cell.config, cell.mix, seed, small)
    frame_path(e, cell.mix["loop"])   # raises for a path the check cannot replay
    dev = torch.device(device)
    eng = Engine(EngineConfig(**e), device=dev)
    sync()
    stages.append(("engine", time.perf_counter() - t0))
    eng.step(int(cell.mix["start_generation"]))
    sync()
    stages.append(("scene", time.perf_counter() - t0))
    loop = LOOPS[cell.mix["loop"]](eng, cell.mix, seed)
    samples = [loop.unit(keep=True)]            # the first answer, from a zero history
    sync()
    stages.append(("first_unit", time.perf_counter() - t0))
    for _ in range(loop.warmup_units() - 1):
        loop.unit()
    sync()
    stages.append(("warmup", time.perf_counter() - t0))
    per_layer = trace_info = None
    if trace:
        per_layer, *trace_info = traced_stretch(loop, loop.trace_units(), cell, e, cuda)
    pick = int(np.random.default_rng(seed).integers(int(cell.mix["sample_below"])))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    win = run_window(loop, seconds, pick, cuda)
    samples.append(win.sample)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del eng, loop
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = check(cell, e, seed, samples, dev, control)
    stages.append(("check_s", time.perf_counter() - t_check))
    correct, failed, checks = verdict(cell.config, readings)

    if trace:
        metrics = per_layer
    else:
        values = {"frame_ms": win.frame_ms, "frame_p95_ms": win.frame_p95_ms, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if values.get(m["name"]) is not None}
    dev_rec = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
               "count": int(cell.entry["chips"]), "memory_peak_bytes": int(peak)}
    rec = {"correct": correct, "attempted": win.frames, "failed": failed, "metrics": metrics,
           "device": dev_rec}
    if trace:
        busy_s, window_s, breakdown = trace_info
        dev_rec.update(busy_s=busy_s, window_s=window_s)
        rec["breakdown"] = breakdown
    rec["checks"] = {k: {"value": _finite(v), "limit": lim} for k, (v, lim) in checks.items()}
    return rec, {"readings": readings, "stages": stages, "quarters": win.quarters,
                 "samples": samples if keep_samples else None}
