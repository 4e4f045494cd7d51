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
  launch of level 2 (``lighting_level_cuda``), and the same at three;
* K2 (``render_slab.shadow_sweep_cuda``) on every form's queries (at two
  bounces the orbit's batch: 24 queries, 256³ gen-230 from the centre
  start), ``k2``; on the multi-bounce forms also with the last level gated
  by the states, as ``lighting_passes`` launches it (``k2gate``, the strip
  kernel), where the tree's K2 takes states; where it takes ``_tiles``,
  the ungated launch in the tile kernel too (``k2tile1``: the grid before
  the floor cut); and once a scene the floor of 8 and 24 queries with
  every lane inactive (``k2floor``, ``k2floortile1``; forms ``q8`` and
  ``q24``).  A tree that gates has its gated flags checked first against
  its ungated ones: equal but on the last level's lanes of dead
  neighbours, 0 there.

Each JSON line (the tree's label and pass, then ``<kernel>_<grid>_<gens>_
<form>`` ms) goes to FILE (default ``build/ab_lighting.jsonl``); then
one summary line a key: each tree's mean of its two passes (of the trees
that have the key) and its ratio to the first tree's.  The card's name and
power limit (``nvidia-smi``) stand on the first line.
"""

from __future__ import annotations

import argparse
import functools
import inspect
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
             "b2": rs.Lighting(soft_k=4, gi=True, bounces=2),
             "b3": rs.Lighting(soft_k=4, gi=True, bounces=3)}
    params = inspect.signature(rs.shadow_sweep_cuda).parameters
    gates, tiled = "states" in params, "_tiles" in params
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
            k2 = {"k2": {}}
            if gates and light.bounces > 1:
                gate = dict(states=states,
                            q_gate=light.n_soft + rs.Lighting.level_span(light.bounces)[0])
                check_gate(rs, cam, ops, prepped, grid, gate, flags)
                k2["k2gate"] = gate
            if tiled:
                k2["k2tile1"] = {"_tiles": 1}
            for key, extra in k2.items():
                calls[key] = functools.partial(k2_call, rs, cam, ops, prepped, grid, extra)
            for kernel, fn in calls.items():
                rec[f"{kernel}_{grid}_{gens}_{name}"] = min(
                    cuda_time_fn(fn, reps=30, warmup=3, queued=True) for _ in range(3))
            del ops, states, flags
        for nq in (8, 24):
            idle = (torch.zeros((nq, 3, h, w), device=dev),) * 2 + (
                torch.zeros((nq, 3, h, w), dtype=torch.int32, device=dev),
                torch.zeros((nq, h, w), dtype=torch.bool, device=dev))
            for key, extra in {"k2floor": {}, "k2floortile1": {"_tiles": 1}}.items():
                if extra and not tiled:
                    continue
                fn = functools.partial(k2_call, rs, cam, idle, prepped, grid, extra)
                rec[f"{key}_{grid}_{gens}_q{nq}"] = min(
                    cuda_time_fn(fn, reps=30, warmup=3, queued=True) for _ in range(3))
            del idle
        del vol, prepped
    print(json.dumps(rec), flush=True)


def k2_call(rs, cam, ops, prepped, grid, extra):
    """One K2 launch on stacked queries ``ops``, with the wrapper's
    ``extra`` arguments (the gate, ``_tiles``)."""
    return rs.shadow_sweep_cuda(prepped.vol, prepped.coarse, prepped.box, *ops,
                                grid_size=grid, cell_half=rs._cell_half(cam, grid), **extra)


def check_gate(rs, cam, ops, prepped, grid, gate, ungated) -> None:
    """The gated flags (the launch's choice and the strip kernel asked
    for) equal the ungated ones but on the gated rows' lanes whose state is
    not 1, where they are 0."""
    import torch

    q_gate, states = gate["q_gate"], gate["states"]
    dead = torch.zeros_like(ops[3])
    dead[q_gate:] = states[q_gate - (len(ops[3]) - len(states)):] != 1
    for tiles in (0, 8):
        got = k2_call(rs, cam, ops, prepped, grid, dict(gate, _tiles=tiles))
        if not (bool((got[dead] == 0).all()) and torch.equal(got[~dead], ungated[~dead])):
            raise AssertionError(f"gated K2 (tiles={tiles}) != the ungated flags at {grid}^3")


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
    ends = ("_full", "_temporal", "_hard", "_b2", "_b3", "_q8", "_q24")
    keys = dict.fromkeys(k for r in recs for k in r if k.endswith(ends))
    for key in keys:
        means = {}
        for t in args.trees:
            reads = [r[key] for r in recs if r["ab_tree"] == str(t) and key in r]
            if reads:
                means[str(t)] = sum(reads) / len(reads)
        first = means.get(str(args.trees[0]))
        ratios = {t: m / first for t, m in means.items()} if first else {}
        print(json.dumps({"key": key, **means, "ratios": ratios}), flush=True)


if __name__ == "__main__":
    main()
