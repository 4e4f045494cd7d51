#!/usr/bin/env python3
"""Time the lighting passes' kernels alone on several checkouts of the
PyTorch/CUDA port, in alternated processes, on one card.

    python3 tools/ab_lighting.py <tree A> <tree B> [<tree C> ...] [--out FILE]

For each tree in the order A, B, ..., ..., B, A, in a process of its own whose
working directory is the tree (so each imports, and builds at first use, its
own ``cellularautomatons3d_tpu_torch``), on the scenes of
``cellularautomatons3d_tpu_torch.tools.common`` at 1920×1080 (256³ gen-80 and
gen-230 with K1's hits, 512³ gen-160 with K4's), the device's ms a call
(``utils.metrics.cuda_time_fn(queued=True)``, the least of 3 reads of 30
back-to-back calls) of:

* the queries kernel (``render_slab.lighting_queries_cuda``) and the shade
  kernel (``lighting_shade_cuda``; on K1's frames composing the fused loop's
  frame against a history that holds every hit's id) at full quality (soft
  shadows ×4, GI), ``gi_temporal`` (sample 1) and the hard shadow;
* at two bounces, the queries kernel, the shade kernel's tree and the level
  launch of level 2 (``lighting_level_cuda``).

Each JSON line (the tree's label and pass, then ``<kernel>_<grid>_<gens>_
<form>`` ms) goes to FILE (default ``build/ab_lighting.jsonl``); then
one summary line a key: each tree's mean of its two passes and its ratio to
the first tree's.  The card's name and power limit (``nvidia-smi``) stand
on the first line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

SCENES = ((256, 80), (256, 230), (512, 160))   # grid, generations
TIMEOUT_S = 900


def child() -> None:
    """One tree's times, in a process whose working directory is the tree."""
    sys.path.insert(0, os.getcwd())
    import torch

    from cellularautomatons3d_tpu_torch.render import render_fast as rf
    from cellularautomatons3d_tpu_torch.render import render_slab as rs
    from cellularautomatons3d_tpu_torch.tools import common
    from cellularautomatons3d_tpu_torch.utils.metrics import cuda_time_fn

    dev = torch.device("cuda")
    w, h = common.WIDTH, common.HEIGHT
    forms = {"full": rs.Lighting(soft_k=4, gi=True),
             "temporal": rs.Lighting(soft_k=4, jitter_k=1, gi=True, gi_slot=1),
             "hard": rs.Lighting(soft_k=1),
             "b2": rs.Lighting(soft_k=4, gi=True, bounces=2)}
    rec = {"device": torch.cuda.get_device_name(dev)}
    for grid, gens in SCENES:
        vol = common.scene(grid, gens, dev)
        prepped = rs.prep_volume(vol)
        cam = common.cam(w, h, light_radius=0.08)
        kw = dict(grid_size=grid, width=w, height=h)
        for name, light in forms.items():
            if grid <= 256:
                rgb, t, idx = rf.raytrace_cuda(vol, prepped.coarse, cam, shadow=False, **kw)
            else:
                t, idx = rs.primary_sweep_cuda(prepped.vol, prepped.coarse, prepped.box, cam,
                                               **kw)
                rgb = None
            ops = rs.lighting_queries_cuda(cam, idx, t, light, **kw)
            states = rs.gi_states(cam, idx, t, ops, prepped, light, **kw) if light.n_slots else None
            flags = rs.occlusion_flags(cam, ops, prepped, grid_size=grid)
            hist = None
            if rgb is not None and light.bounces == 1:
                hist = (torch.rand((h, w, 3), device=dev), idx.clone())
            calls = {"queries": lambda: rs.lighting_queries_cuda(cam, idx, t, light, **kw),
                     "shade": lambda: rs.lighting_shade_cuda(cam, idx, t, flags, states, light,
                                                             rgb=rgb, history=hist, **kw)}
            if light.bounces > 1:
                calls["level"] = lambda: rs.lighting_level_cuda(cam, idx, t, ops, states, light,
                                                                2, **kw)
            for kernel, fn in calls.items():
                rec[f"{kernel}_{grid}_{gens}_{name}"] = min(
                    cuda_time_fn(fn, reps=30, warmup=3, queued=True) for _ in range(3))
            del ops, states, flags
        del vol, prepped
    print(json.dumps(rec), flush=True)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--out", type=Path, default=Path("build") / "ab_lighting.jsonl")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child()
        return
    if len(args.trees) < 2:
        ap.error("give two trees or more")
    trees = [t.resolve() for t in args.trees]
    print(json.dumps({"card": card()}), flush=True)
    order = list(range(len(trees))) + list(range(len(trees)))[::-1]
    recs = []
    for p, i in enumerate(order):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child"],
                              cwd=trees[i], capture_output=True, text=True, timeout=TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"{trees[i]} failed ({proc.returncode}):\n{proc.stderr[-3000:]}")
        rec = json.loads([x for x in proc.stdout.splitlines() if x.startswith("{")][-1])
        rec.update(ab_tree=str(args.trees[i]), ab_pass=p)
        recs.append(rec)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text("".join(json.dumps(r) + "\n" for r in recs))
    keys = [k for k in recs[0] if k.endswith(("_full", "_temporal", "_hard", "_b2"))]
    for key in keys:
        means = [sum(r[key] for r in recs if r["ab_tree"] == str(t)) / 2 for t in args.trees]
        print(json.dumps({"key": key, **{str(t): m for t, m in zip(args.trees, means)},
                          "ratios": [m / means[0] for m in means[1:]]}), flush=True)


if __name__ == "__main__":
    main()
