#!/usr/bin/env python3
"""Re-read the PyTorch/CUDA port's headline and moved frames and its bench on
two checkouts, in alternated processes, on one card.

    python3 tools/ab_frames.py <tree A> <tree B> [--labels A,B] [--out FILE]
                               [--frames K]

For each tree in the order A, B, B, A, in processes of their own whose working
directory is the tree (so each imports, and builds at first use, its own
``cellularautomatons3d_tpu_torch``):

* ``python -m cellularautomatons3d_tpu_torch.tools.profile_trace --mode
  headline --frames K`` (256³ gen-80, the fused compose loop);
* ``... --mode moved --frames K`` (K ``render()`` calls after a camera move
  beside K static ones);
* ``python3 bench_torch.py`` (the pinned, dense and step lines).

Each JSON line is written to FILE (default ``chiprun_out/ab_frames.jsonl``)
with its tree's label and pass; then one summary line a tree and metric:
the reads of every pass, their median and min-max.  The card's name and power
limit (``nvidia-smi --query-gpu=name,power.limit``) stand on the first line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

RUNS = (
    ("headline", ["-m", "cellularautomatons3d_tpu_torch.tools.profile_trace", "--mode",
                  "headline"]),
    ("moved", ["-m", "cellularautomatons3d_tpu_torch.tools.profile_trace", "--mode", "moved"]),
    ("bench", ["bench_torch.py"]),
)
# run: the keys of its line that the summary reads
METRICS = {
    "headline": ("frame_ms", "busy_ms_per_frame", "launches_per_frame", "events_busy_share"),
    "moved": ("frame_ms", "moved_extra_launches_per_frame", "moved_extra_device_ms_per_frame",
              "launches_per_frame", "busy_ms_per_frame"),
    "bench": ("value", "dense_scene_ms", "step_ms"),
}
TIMEOUT_S = 600


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def run_one(tree: Path, argv, frames: int) -> dict:
    args = list(argv)
    if args[0] == "-m":
        args += ["--frames", str(frames), "--out", str(tree / "build" / "traces" / "ab")]
    proc = subprocess.run([sys.executable, *args], cwd=tree, capture_output=True, text=True,
                          timeout=TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(args)} in {tree} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-3000:]}")
    lines = [x for x in proc.stdout.splitlines() if x.startswith("{")]
    return json.loads(lines[-1])


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs=2, type=Path)
    ap.add_argument("--labels", default="A,B")
    ap.add_argument("--out", type=Path, default=Path("chiprun_out") / "ab_frames.jsonl")
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args(argv)
    labels = args.labels.split(",")
    trees = dict(zip(labels, (t.resolve() for t in args.trees)))
    print(json.dumps({"card": card()}), flush=True)
    recs = []
    for i, label in enumerate((labels[0], labels[1], labels[1], labels[0])):
        for run, argv_run in RUNS:
            rec = run_one(trees[label], argv_run, args.frames)
            rec.update(ab_tree=label, ab_pass=i, ab_run=run)
            recs.append(rec)
            print(json.dumps({k: rec.get(k) for k in ("ab_tree", "ab_pass", "ab_run",
                                                      *METRICS[run])}), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text("".join(json.dumps(r) + "\n" for r in recs))
    for run, keys in METRICS.items():
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
