#!/usr/bin/env python3
"""Re-read the PyTorch/CUDA port's frames, its bench and its occupancy
kernels on two checkouts, in alternated processes, on one card.

    python3 tools/ab_frames.py <tree A> <tree B> [--labels A,B] [--out FILE]
                               [--frames K] [--runs RUN,...]

For each tree in the order A, B, B, A, in processes of their own whose working
directory is the tree (so each imports, and builds at first use, its own
``cellularautomatons3d_tpu_torch``), the runs of ``--runs`` (default
``headline,moved,bench``):

* ``headline``: ``python -m cellularautomatons3d_tpu_torch.tools.profile_trace
  --mode headline --frames K`` (256³ gen-80, the fused compose loop);
* ``mip1``: the same under ``CA3D_MIP1=1`` (K1's plane-mip descent, whose
  frame also rebuilds the plane mip);
* ``moved``: ``... --mode moved --frames K`` (K ``render()`` calls after a
  camera move beside K static ones);
* ``sliced``, ``sliced_1024``, ``gi``, ``gi_temporal``, ``two_bounces``:
  ``... --mode sliced`` at 512³ and 1024³, and the three lighting modes;
* ``multistate``, ``multistate_1024``: ``... --mode multistate`` at 512³ and
  1024³ (the ``pyroclastic`` preset's sliced frames);
* ``bench``: ``python3 bench_torch.py`` (the pinned, dense and step lines);
* ``mip``: this script with ``--mip-child`` (the tree first on ``sys.path``):
  the 8³ mip, the box and the plane mip at 256³ gen-80, 512³ gen-160 and
  1024³ gen-200, each as the device's ms a call
  (``utils.metrics.cuda_time_fn(queued=True)``, 50 back-to-back calls): the
  mip alone (``coarse_occupancy_cuda``), the box alone (``occupied_box_cuda``
  on that mip), the two in turn, the mip with its box in one launch
  (``coarse_occupancy_box_cuda``, where the tree has it: its mip and box held
  to the twins bit for bit first), the plane mip (``plane_occupancy_cuda``),
  the mip then the plane mip (a mip1 frame's rebuild before the two shared a
  launch), the mip with the plane mip in one launch, without and with the
  box (``coarse_occupancy_plane_cuda``, where the tree has it: its outputs
  held to the twins bit for bit first) and a one-element ``fill_`` (the
  launch floor).

A traced run's line also gives K2's device ms a frame (``k2_ms_per_frame``,
from its trace's ``shadow_sweep_kernel`` launches).  Each JSON line is
written to FILE (default ``chiprun_out/ab_frames.jsonl``) with its tree's
label and pass; then one summary line a tree and metric:
the reads of every pass, their median and min-max.  The card's name and power
limit (``nvidia-smi --query-gpu=name,power.limit``) stand on the first line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

TRACE = ["-m", "cellularautomatons3d_tpu_torch.tools.profile_trace", "--mode"]
RUNS = {
    "headline": TRACE + ["headline"],
    "mip1": TRACE + ["headline"],
    "moved": TRACE + ["moved"],
    "sliced": TRACE + ["sliced"],
    "sliced_1024": TRACE + ["sliced", "--grid", "1024"],
    "gi": TRACE + ["gi"],
    "gi_temporal": TRACE + ["gi_temporal"],
    "two_bounces": TRACE + ["two_bounces"],
    "multistate": TRACE + ["multistate", "--grid", "512"],
    "multistate_1024": TRACE + ["multistate", "--grid", "1024"],
    "bench": ["bench_torch.py"],
    "mip": [str(Path(__file__).resolve()), "--mip-child"],
}
ENV = {"mip1": {"CA3D_MIP1": "1"}}   # run: the variables it sets
FRAME = ("frame_ms", "busy_ms_per_frame", "launches_per_frame", "events_busy_share",
         "k2_ms_per_frame")
MIP_GRIDS = {256: 80, 512: 160, 1024: 200}   # grid: generations of the scene
MIP_CALLS = ("mip", "box", "mip_then_box", "mip_box", "plane", "mip_then_plane", "mip_plane",
             "mip_plane_box", "fill")
# run: the keys of its line that the summary reads
METRICS = {
    "headline": FRAME,
    "mip1": FRAME,
    "moved": ("frame_ms", "moved_extra_launches_per_frame", "moved_extra_device_ms_per_frame",
              "launches_per_frame", "busy_ms_per_frame"),
    "sliced": FRAME, "sliced_1024": FRAME, "gi": FRAME, "gi_temporal": FRAME,
    "two_bounces": FRAME, "multistate": FRAME, "multistate_1024": FRAME,
    "bench": ("value", "dense_scene_ms", "step_ms"),
    "mip": tuple(f"{c}_{g}_dev_ms" for g in MIP_GRIDS for c in MIP_CALLS),
}
TIMEOUT_S = 600


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def mip_child() -> None:
    """The ``mip`` run, in a process whose working directory is the tree:
    one JSON line of device ms a call (see the module docstring)."""
    sys.path.insert(0, os.getcwd())
    import torch

    from cellularautomatons3d_tpu_torch.ops import occupancy
    from cellularautomatons3d_tpu_torch.tools import common
    from cellularautomatons3d_tpu_torch.utils.metrics import cuda_time_fn

    dev = torch.device("cuda")
    rec = {"device": torch.cuda.get_device_name(dev), "card": card()}
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    fused = getattr(occupancy, "coarse_occupancy_box_cuda", None)
    with_plane = getattr(occupancy, "coarse_occupancy_plane_cuda", None)
    for grid, gens in MIP_GRIDS.items():
        vol = common.scene(grid, gens, dev)
        mip = occupancy.coarse_occupancy_cuda(vol)
        calls = {
            "mip": lambda: occupancy.coarse_occupancy_cuda(vol),
            "box": lambda: occupancy.occupied_box_cuda(mip, grid),
            "mip_then_box": lambda: occupancy.occupied_box_cuda(
                occupancy.coarse_occupancy_cuda(vol), grid),
            "plane": lambda: occupancy.plane_occupancy_cuda(vol),
            "mip_then_plane": lambda: (occupancy.coarse_occupancy_cuda(vol),
                                       occupancy.plane_occupancy_cuda(vol)),
            "fill": lambda: one.fill_(grid),
        }
        if with_plane is not None:
            want = (*occupancy.coarse_occupancy_box(vol), occupancy.plane_occupancy(vol))
            for box in (False, True):
                got = with_plane(vol, with_box=box)
                if not (torch.equal(got.coarse, want[0]) and torch.equal(got.plane, want[2])
                        and (not box or torch.equal(got.box, want[1]))):
                    raise AssertionError(f"coarse_occupancy_plane_cuda(with_box={box}) != its "
                                         f"twins at {grid}^3")
            calls["mip_plane"] = lambda: with_plane(vol)
            calls["mip_plane_box"] = lambda: with_plane(vol, with_box=True)
        if fused is not None:
            got = fused(vol)
            want = occupancy.coarse_occupancy_box(vol)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"coarse_occupancy_box_cuda != its twins at {grid}^3")
            calls["mip_box"] = lambda: fused(vol)
        for name, fn in calls.items():
            rec[f"{name}_{grid}_dev_ms"] = cuda_time_fn(fn, reps=50, warmup=5, device=dev,
                                                        queued=True)
        del vol, mip
    print(json.dumps(rec), flush=True)


def run_one(tree: Path, argv, frames: int, env=None) -> dict:
    args = list(argv)
    if args[0] == "-m":
        args += ["--frames", str(frames), "--out", str(tree / "build" / "traces" / "ab")]
    proc = subprocess.run([sys.executable, *args], cwd=tree, capture_output=True, text=True,
                          timeout=TIMEOUT_S, env={**os.environ, **(env or {})})
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(args)} in {tree} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-3000:]}")
    lines = [x for x in proc.stdout.splitlines() if x.startswith("{")]
    rec = json.loads(lines[-1])
    if "kernels" in rec:
        rec["k2_ms_per_frame"] = sum(k["device_ms_per_frame"] for k in rec["kernels"]
                                     if "shadow_sweep_kernel" in k["name"])
    return rec


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--labels", default="A,B")
    ap.add_argument("--out", type=Path, default=Path("chiprun_out") / "ab_frames.jsonl")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--runs", default="headline,moved,bench",
                    help=f"comma-separated runs of {', '.join(RUNS)}")
    ap.add_argument("--mip-child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.mip_child:
        mip_child()
        return []
    if len(args.trees) != 2:
        ap.error("give two trees")
    runs = args.runs.split(",")
    unknown = sorted(set(runs) - set(RUNS))
    if unknown:
        ap.error(f"unknown runs {unknown}; choose from {', '.join(RUNS)}")
    labels = args.labels.split(",")
    trees = dict(zip(labels, (t.resolve() for t in args.trees)))
    print(json.dumps({"card": card()}), flush=True)
    recs = []
    for i, label in enumerate((labels[0], labels[1], labels[1], labels[0])):
        for run in runs:
            rec = run_one(trees[label], RUNS[run], args.frames, ENV.get(run))
            rec.update(ab_tree=label, ab_pass=i, ab_run=run)
            recs.append(rec)
            print(json.dumps({k: rec.get(k) for k in ("ab_tree", "ab_pass", "ab_run",
                                                      *METRICS[run])}), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text("".join(json.dumps(r) + "\n" for r in recs))
    for run in runs:
        keys = METRICS[run]
        for label in labels:
            for key in keys:
                reads = [r[key] for r in recs if r["ab_run"] == run and r["ab_tree"] == label
                         and isinstance(r.get(key), (int, float))]
                if reads:
                    print(json.dumps({"tree": label, "run": run, "metric": key, "reads": reads,
                                      "median": statistics.median(reads),
                                      "min": min(reads), "max": max(reads)}), flush=True)
    return recs


if __name__ == "__main__":
    main()
