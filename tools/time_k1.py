#!/usr/bin/env python3
"""Time the hand-written kernels of one checkout of the PyTorch/CUDA port on
the card, for an A/B of two commits in one call.

    python3 tools/time_k1.py <repo root> [label] [--out FILE] [--sass DIR]

Imports ``cellularautomatons3d_tpu_torch`` from ``<repo root>`` (which builds
its own kernels there) and times, with CUDA events after a warm-up, at
1920×1080 from the initial view:

* K1 (``render_fast.raytrace_cuda``, no column mask, no ages) in compose mode
  (against a history that keeps its ids) and in non-compose mode, on the
  centre seed after 80 generations at 256³ (the main path's scene) and after
  230 (the dense scene of ``tools/bench_dense.py``); where the tree has K1's
  ``no_sweep`` flag, also the split of compose mode: no sweep (ray set-up,
  composition, stores), ``shadow=False`` (plus the primary sweep) and full;
* K2 (``render_slab.shadow_sweep_cuda``) on a full-quality frame's 8
  occlusion queries at 256³, and K4 (``render_slab.primary_sweep_cuda``) at
  512³ on the scene after 160 generations;
* the binary CA step at 256³, 512³ and 1024³ (default rule), the binary
  step on the ``pyroclastic`` preset's rule (Moore) at 1024³, and the
  multi-state step (both launches) at 1024³ on that preset (10 states) over
  random ages.

Each time is CUDA events around back-to-back calls (``*_ms``; a short kernel
reads the host's enqueue rate there) and, under ``device_ms``, the kernels'
own device time from a ``torch.profiler`` trace of the same calls.

Before timing it checks that K1's ids equal its plain version's on both
scenes and that both CA steps equal theirs at 256³, so a broken tree is not
timed.  Prints one JSON line with the times, the hit counts, the registers
and spills ``ptxas`` gave K1, K2, K4 and the CA step kernels, the label and
the card, and appends it to ``--out``.  With ``--sass DIR`` it also writes
``cuobjdump -sass`` of the CA step kernels to ``DIR``.  Compare two trees by
running them in turns in one call: parent, change, change, parent.
"""

import argparse
import inspect
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path


TIMED = ("render_kernel", "ca_step_kernel", "shadow_sweep_kernel", "primary_sweep_kernel")


def ptxas_report(log: str) -> dict:
    """{kernel: [registers, spill stores, spill loads, mangled name]} of the
    timed kernels, from the build log's ``-Xptxas -v`` lines, names demangled
    with ``cu++filt`` and shortened to their template arguments."""
    info, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            info[name] = [int(m.group(1)), *spill, name]
            name = None
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    names = list(info)
    if names and Path(filt).is_file():
        out = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = out.stdout.splitlines()
    short = {}
    for full, v in zip(names, info.values()):
        # cu++filt: "void <unnamed>::ca_step_kernel<(int)0, (int)3>(...)".
        full = re.sub(r"<unnamed>::|\(anonymous namespace\)::|\((bool|int)\)|^void ", "", full)
        base = full[:full.index(">") + 1] if "<" in full.split("(")[0] else full.split("(")[0]
        if any(k in base for k in TIMED):
            short[base] = v
    return short


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("label", nargs="?")
    ap.add_argument("--out", help="file to append the JSON line to")
    ap.add_argument("--sass", help="directory for the CA step kernels' SASS")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    label = args.label or str(root)
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import cellularautomatons3d_tpu_torch as ct
    from cellularautomatons3d_tpu_torch import kernels
    from cellularautomatons3d_tpu_torch.models.automaton import AutomatonSpec
    from cellularautomatons3d_tpu_torch.ops import ca_reference, ca_step
    from cellularautomatons3d_tpu_torch.ops.occupancy import coarse_occupancy
    from cellularautomatons3d_tpu_torch.render import render_fast as rf
    from cellularautomatons3d_tpu_torch.render import render_slab as rs
    from cellularautomatons3d_tpu_torch.utils import mat4

    if Path(ct.__file__).resolve().parent.parent != root:
        raise SystemExit(f"imported {ct.__file__}, not the package under {root}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    lib = kernels.build()
    regs = ptxas_report(lib.with_suffix(".log").read_text())
    out = {"label": label, "ptxas": {k: v[:3] for k, v in regs.items()}}
    if args.sass:
        Path(args.sass).mkdir(parents=True, exist_ok=True)
        for name, v in regs.items():
            if "ca_step_kernel" in name:
                sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", "-fun", v[3],
                                       str(lib)], capture_output=True, text=True)
                tag = re.sub(r"\W+", "_", name).strip("_")
                (Path(args.sass) / f"sass_{label}_{tag}.txt").write_text(sass.stdout + sass.stderr)

    n, w, h = 256, 1920, 1080
    dev = torch.device("cuda", 0)
    spec = AutomatonSpec.from_rule_strings(n)
    d = ct.EngineConfig()
    cam = rf.pack_cam(mat4.initial_view_matrix(), w, h, d.light.position, d.light.magnitude,
                      d.cell_size, d.roughness, d.base_reflectivity, d.material_color,
                      temporal_alpha=d.temporal_alpha, gamma=d.gamma)
    kw = dict(grid_size=n, width=w, height=h, shadow=True)

    def device_ms(fn, kernels, iters=20, warmup=3):
        """Mean device time per call of fn in the kernels whose names hold one
        of ``kernels``, from torch.profiler's CUDA trace: the kernels alone,
        without the host's enqueue between them (None if the trace has none)."""
        from torch.profiler import ProfilerActivity, profile

        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and any(k in e.name for k in kernels)]
        return sum(us) / iters / 1000.0 if us else None

    dev_ms = {}

    def ms(fn, iters=100, warmup=5):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    # The CA steps against their plain versions first.
    vol = ct.from_reference(ct.pack_grid(ct.seed_center(n)), dev)
    rng = np.random.default_rng(0)
    check = torch.from_numpy((rng.random((n, n, n)) < 0.2).astype(np.uint8))
    a = ct.from_reference(ct.pack_grid(check.numpy()), dev)
    b = a.clone()
    for _ in range(2):
        a, b = ca_step.fires_plane_cuda(a, spec), ca_step.fires_plane(b, spec)
    if not torch.equal(a, b):
        raise SystemExit(f"{label}: the binary CA step differs from its plain version")
    pyro = ct.PRESETS["pyroclastic"]

    def random_ages(size, seed):
        g = torch.Generator(dev).manual_seed(seed)
        dense = torch.randint(1, pyro["total_states"], (size,) * 3, dtype=torch.uint8,
                              device=dev, generator=g)
        dense[torch.rand((size,) * 3, device=dev, generator=g) < 0.6] = 0
        return ca_reference.dense_to_planes(dense, 4)

    ms_spec = AutomatonSpec.from_rule_strings(n, **pyro)
    a = random_ages(n, 1)
    b = a.clone()
    for _ in range(2):
        a = ca_step.step_packed_multistate_cuda(a, ms_spec)
        b = ca_step.step_packed_multistate(b, ms_spec)
    if not torch.equal(a, b):
        raise SystemExit(f"{label}: the multi-state CA step differs from its plain version")
    del a, b, check

    no_sweep = "no_sweep" in inspect.signature(rf.raytrace_cuda).parameters
    gen = 0
    for steps in (80, 230):
        for gen in range(gen, steps):
            vol = ca_step.fires_plane_cuda(vol, spec)
        gen = steps
        coarse = coarse_occupancy(vol)
        rgb, _, idx = rf.raytrace_cuda(vol, coarse, cam, **kw)
        want = rf.raytrace(vol, coarse, cam, **kw)[2]
        if not torch.equal(idx, want):
            raise SystemExit(f"{label}: K1 gen-{steps}: {int((idx != want).sum())} ids "
                             "differ from the plain version")
        hist = (torch.clamp(rgb * 1.5 + 0.02, 0.0, 1.0).contiguous(), idx.contiguous())
        g = f"gen{steps}"
        out[f"k1_compose_{g}_ms"] = ms(lambda: rf.raytrace_cuda(vol, coarse, cam, hist, **kw))
        out[f"k1_noncompose_{g}_ms"] = ms(lambda: rf.raytrace_cuda(vol, coarse, cam, **kw))
        dev_ms[f"k1_compose_{g}"] = device_ms(
            lambda: rf.raytrace_cuda(vol, coarse, cam, hist, **kw), ["render_kernel"])
        dev_ms[f"k1_noncompose_{g}"] = device_ms(
            lambda: rf.raytrace_cuda(vol, coarse, cam, **kw), ["render_kernel"])
        out[f"hit_pixels_{g}"] = int((idx >= 0).sum())
        if no_sweep:
            kw0 = dict(kw, shadow=False)
            out[f"k1_split_{g}_ms"] = {
                "no_sweep": ms(lambda: rf.raytrace_cuda(vol, coarse, cam, hist, no_sweep=True,
                                                        **kw)),
                "primary": ms(lambda: rf.raytrace_cuda(vol, coarse, cam, hist, **kw0)),
                "full": ms(lambda: rf.raytrace_cuda(vol, coarse, cam, hist, **kw)),
            }
            dev_ms[f"k1_split_{g}"] = {
                "no_sweep": device_ms(lambda: rf.raytrace_cuda(
                    vol, coarse, cam, hist, no_sweep=True, **kw), ["render_kernel"]),
                "primary": device_ms(lambda: rf.raytrace_cuda(vol, coarse, cam, hist, **kw0),
                                     ["render_kernel"]),
                "full": dev_ms[f"k1_compose_{g}"],
            }
        if steps == 80:
            out["ca_step_256_ms"] = ms(lambda: ca_step.fires_plane_cuda(vol, spec), 1000, 20)
            dev_ms["ca_step_256"] = device_ms(lambda: ca_step.fires_plane_cuda(vol, spec),
                                              ["ca_step_kernel"], 100)
            # K2 on a full-quality frame's 8 occlusion queries (4 soft-shadow
            # samples, 4 GI slots), built as the port builds them.
            lcam = rf.pack_cam(mat4.initial_view_matrix(), w, h, d.light.position,
                               d.light.magnitude, d.cell_size, d.roughness,
                               d.base_reflectivity, d.material_color, light_radius=0.08,
                               elapsed_time=0.37)
            _, depth, idx = rf.raytrace_cuda(vol, coarse, lcam, grid_size=n, width=w,
                                             height=h, shadow=False)
            geo = rs.hit_geometry(lcam, idx, depth, grid_size=n, width=w, height=h)
            queries, _, _ = rs.lighting_queries(lcam, *geo[:4], grid_size=n, width=w,
                                                height=h, soft_k=4, gi=True)
            k2 = rs.stack_occlusion_queries(queries, w, h)
            k2kw = dict(grid_size=n, cell_half=rs._cell_half(lcam, n))
            out["k2_8q_256_ms"] = ms(lambda: rs.shadow_sweep_cuda(vol, coarse, *k2, **k2kw), 50)
            dev_ms["k2_8q_256"] = device_ms(lambda: rs.shadow_sweep_cuda(vol, coarse, *k2, **k2kw),
                                            ["shadow_sweep_kernel"])
            del geo, queries, k2
    for size, steps in ((512, 160), (1024, 0)):
        big_spec = AutomatonSpec.from_rule_strings(size)
        big = ct.from_reference(ct.pack_grid(ct.seed_center(size)), dev)
        for _ in range(steps):
            big = ca_step.fires_plane_cuda(big, big_spec)
        out[f"ca_step_{size}_ms"] = ms(lambda: ca_step.fires_plane_cuda(big, big_spec), 50)
        dev_ms[f"ca_step_{size}"] = device_ms(lambda: ca_step.fires_plane_cuda(big, big_spec),
                                              ["ca_step_kernel"])
        if size == 512:
            big_coarse = coarse_occupancy(big)
            out["k4_512_ms"] = ms(lambda: rs.primary_sweep_cuda(
                big, big_coarse, cam, grid_size=size, width=w, height=h), 50)
            dev_ms["k4_512"] = device_ms(lambda: rs.primary_sweep_cuda(
                big, big_coarse, cam, grid_size=size, width=w, height=h), ["primary_sweep_kernel"])
        del big
    big_spec = AutomatonSpec.from_rule_strings(1024, **pyro)
    planes = random_ages(1024, 2)
    out["ms_step_1024_ms"] = ms(
        lambda: ca_step.step_packed_multistate_cuda(planes, big_spec), 20, 3)
    moore = AutomatonSpec.from_rule_strings(
        1024, **{k: v for k, v in pyro.items() if k != "total_states"})
    alive = ca_step.age_masks_cuda(planes, vis=False)[0]
    out["ca_step_moore_1024_ms"] = ms(lambda: ca_step.fires_plane_cuda(alive, moore), 20, 3)
    dev_ms["ms_step_1024"] = device_ms(
        lambda: ca_step.step_packed_multistate_cuda(planes, big_spec),
        ["ca_step_kernel", "age_masks_kernel"], 10)
    dev_ms["ca_step_moore_1024"] = device_ms(lambda: ca_step.fires_plane_cuda(alive, moore),
                                             ["ca_step_kernel"], 10)
    out["device_ms"] = dev_ms
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    line = json.dumps({**out, "card": card})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
