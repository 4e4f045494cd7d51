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
* the opt-in prepass frame on the same scenes (``raytrace_tiles(...,
  use_prepass=True)``, compose), each tree on its own contract: K6
  (``render_fast.prepass_cuda``; on the undilated mip where K1 takes
  ``prepass``, else on the twice-dilated one), the two dilations where the
  frame runs them, K1 given the plain masks, and the whole frame with the
  kernels it launches (from the profiler trace);
* K2 (``render_slab.shadow_sweep_cuda``) on a full-quality frame's 8
  occlusion queries at 256³ on gen-80 and on gen-230 (whose box of occupied
  blocks is the whole volume), with every lane inactive (its floor), and at
  512³ on gen-160; its hard-shadow query at 512³ (gen-160) and 1024³
  (gen-200);
* K5 (``render_slab.shadow_sweep_multi_cuda``) on the same 8 queries as
  two launches of 4 (as the ``CA3D_OCC_SWEEP=0`` dispatch runs them) at 256³
  on gen-80 and gen-230, with every lane inactive, and at 512³; each tree on
  its own contract (stacked operands with packed exclusion ids before the
  redesign, each query's own tensors after), and the whole occlusion batch
  (``shadow_occlusion_batch``, operands included) with K2 and with K5, and
  the device time of K2's operand stacking;
* K3 (``render_slab.cell_state_cuda``) on a full-quality frame's 4 GI
  lookups at 256³ (gen-80), 512³ (gen-160) and 1024³ (gen-200), each tree on
  its own contract, and the whole ``cell_state_batch``;
* K4 (``render_slab.primary_sweep_cuda``) at 512³ on gen-160, at 1024³ on
  gen-200, at 512³ on gen-260 (whose box is the whole volume) and on an empty
  volume at 512³ and 1024³ (its floor); where the tree has
  ``ops.occupancy.occupied_box_cuda``, the box kernel alone at each size
  (K2's, K4's and K5's times include its launch where their entry points
  make it, before the box became their operand, written by the mip
  kernel's launch; a tree with the operand passes the twin's box), and
  in the same trace the launch floor (a one-element torch ``fill_``) and the
  plane mip's kernel (``ops.occupancy.plane_occupancy_cuda``) on the volume;
* the binary CA step at 256³, 512³ and 1024³ (default rule), the binary
  step on the ``pyroclastic`` preset's rule (Moore) at 1024³, and the
  multi-state step (both launches) at 1024³ on that preset (10 states) over
  random ages; the alive / visibility pass alone (``age_masks_cuda``) at 256³,
  512³ and 1024³ on such ages;
* step + frame of the lighting configurations (``Engine.run_fused(k,
  reset_every=k)``, soft shadows ×4, GI, light radius 0.08) under
  ``torch.profiler``: full quality at 256³ (gen-80) with the default
  backend and with ``CA3D_OCC_SWEEP=0``, gi_temporal and two bounces at
  256³ and gi_temporal at 512³ (gen-160) with the default one: wall and
  device time per step + frame, the card's busy share, launches, and the
  device time by kernel.

Each time is CUDA events around back-to-back calls (``*_ms``; a short kernel
reads the host's enqueue rate there) and, under ``device_ms``, the kernels'
own device time from a ``torch.profiler`` trace of the same calls.

Before timing it checks that K1's ids equal its plain version's on both
scenes, that both CA steps equal theirs at 256³, that K2's flags and K4's
ids equal theirs on each scene they are timed on, that K5's flags equal
K2's and K3's states its plain version's, so a broken tree is not timed.
Prints one JSON line with the times, the hit counts, the registers and
spills ``ptxas`` gave K1, K2, K3, K4, K5, K6, the box kernel, the CA step
kernels and the age-mask pass, the label and the card, and appends it to
``--out``.  With ``--sass DIR`` it also writes
``cuobjdump -sass`` of the CA step kernels to ``DIR``.  Compare two trees by
running them in turns in one call: parent, change, change, parent.
"""

import argparse
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path


TIMED = ("render_kernel", "prepass_kernel", "ca_step_kernel", "shadow_sweep_kernel",
         "primary_sweep_kernel", "occupied_box_kernel", "shadow_multi_kernel",
         "cell_state_kernel", "age_masks_kernel")
K2_KERNELS = ["shadow_sweep_kernel", "occupied_box_kernel"]
K4_KERNELS = ["primary_sweep_kernel", "occupied_box_kernel"]
K5_KERNELS = ["shadow_multi_kernel", "occupied_box_kernel"]
ALL_KERNELS = [""]  # every device event


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

    def device_events(fn, iters=20, warmup=3):
        """(name, µs) of every device event of ``iters`` calls of fn, from
        torch.profiler's CUDA trace."""
        from torch.profiler import ProfilerActivity, profile

        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    def device_ms(fn, kernels, iters=20, warmup=3):
        """Mean device time per call of fn in the kernels whose names hold one
        of ``kernels``: the kernels alone, without the host's enqueue between
        them (None if the trace has none)."""
        us = [t for name, t in device_events(fn, iters, warmup)
              if any(k in name for k in kernels)]
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

    lcam = rf.pack_cam(mat4.initial_view_matrix(), w, h, d.light.position, d.light.magnitude,
                       d.cell_size, d.roughness, d.base_reflectivity, d.material_color,
                       light_radius=0.08, elapsed_time=0.37)

    # The sweeps' box: an operand since the mip kernel's launch writes it;
    # before, K2's, K4's and K5's entry points launched the box kernel.
    box_operand = "box" in inspect.signature(rs.primary_sweep_cuda).parameters

    def boxed(coarse_):
        """The operands after the mip: (its box,) or ()."""
        if not box_operand:
            return ()
        from cellularautomatons3d_tpu_torch.ops.occupancy import occupied_box

        return (occupied_box(coarse_, coarse_.shape[0] * 8),)

    def primary(vol_, coarse_, size, c):
        if size <= 256:
            _, depth, idx_ = rf.raytrace_cuda(vol_, coarse_, c, grid_size=size, width=w,
                                              height=h, shadow=False)
            return depth, idx_
        return rs.primary_sweep_cuda(vol_, coarse_, *boxed(coarse_), c, grid_size=size,
                                     width=w, height=h)

    def frame_queries(vol_, coarse_, size):
        """A full-quality frame's 8 occlusion queries (4 soft-shadow
        samples, 4 GI slots) and its 4 GI lookups, as the lighting passes
        leave them."""
        depth, idx_ = primary(vol_, coarse_, size, lcam)
        geo = rs.hit_geometry(lcam, idx_, depth, grid_size=size, width=w, height=h)
        queries, slots, _ = rs.lighting_queries(lcam, *geo[:4], grid_size=size, width=w,
                                                height=h, soft_k=4, gi=True)
        return queries, [(sl[0], sl[3]) for sl in slots]

    def k2_operands(vol_, coarse_, size):
        """K2's operands of a full-quality frame's 8 occlusion queries."""
        queries, _ = frame_queries(vol_, coarse_, size)
        return (rs.stack_occlusion_queries(queries, w, h),
                dict(grid_size=size, cell_half=rs._cell_half(lcam, size)))

    # K5's and K3's contracts: each query's own tensors since the redesign,
    # stacked operands (K5 with packed exclusion ids) before it.
    k5_in_place = "excl" in inspect.signature(rs.shadow_sweep_multi_cuda).parameters

    def time_k5(tag, vol_, coarse_, queries, size, check=True):
        """K5 on 8 queries as two launches of 4, checked against K2."""
        k5kw = dict(grid_size=size, cell_half=rs._cell_half(lcam, size))
        stacked = rs.stack_occlusion_queries(queries, w, h)
        box = boxed(coarse_)
        if k5_in_place:
            run = lambda: [rs.shadow_sweep_multi_cuda(  # noqa: E731
                vol_, coarse_, *box, *zip(*queries[i:i + 4]), **k5kw) for i in (0, 4)]
        else:
            start, target, excl, active = stacked
            exid = rs.pack_exclusion(excl, size)
            run = lambda: [rs.shadow_sweep_multi_cuda(  # noqa: E731
                vol_, coarse_, start[i:i + 4], target[i:i + 4], exid[i:i + 4],
                active[i:i + 4], **k5kw) for i in (0, 4)]
        if check and not torch.equal(torch.cat(run()),
                                     rs.shadow_sweep_cuda(vol_, coarse_, *box, *stacked,
                                                          **k5kw)):
            raise SystemExit(f"{label}: {tag}: K5 differs from K2")
        out[f"{tag}_ms"] = ms(run, 50)
        dev_ms[tag] = device_ms(run, K5_KERNELS)
        out[f"{tag}_active"] = int(stacked[3].sum())

    def time_occlusion_batch(tag, vol_, coarse_, queries, size):
        """The dispatch on the frame's 8 queries, operands included, with K2
        (the default) and with K5 (CA3D_OCC_SWEEP=0); K2's operand stacking
        alone (the stacks and the packed ids the parent's K5 path made)."""
        prepped = rs.prep_volume(vol_, coarse_)
        run = lambda: rs.shadow_occlusion_batch(  # noqa: E731
            lcam, queries, prepped, grid_size=size, width=w, height=h)
        for backend, env in (("k2", "1"), ("k5", "0")):
            os.environ["CA3D_OCC_SWEEP"] = env
            out[f"{tag}_{backend}_ms"] = ms(run, 50)
            dev_ms[f"{tag}_{backend}"] = device_ms(run, ALL_KERNELS)
        os.environ.pop("CA3D_OCC_SWEEP")
        stack = lambda: rs.pack_exclusion(  # noqa: E731
            rs.stack_occlusion_queries(queries, w, h)[2], size)
        dev_ms[f"{tag}_stacking"] = device_ms(stack, ALL_KERNELS)

    def time_k3(tag, vol_, lookups, size):
        """K3 on the frame's 4 GI lookups, and the whole cell_state_batch."""
        stacked = rs.stack_cell_queries(lookups, w, h)
        if k5_in_place:
            run = lambda: rs.cell_state_cuda(vol_, *zip(*lookups), grid_size=size)  # noqa: E731
        else:
            run = lambda: rs.cell_state_cuda(vol_, *stacked, grid_size=size)  # noqa: E731
        if not torch.equal(run(), rs.cell_state(vol_, *stacked, grid_size=size)):
            raise SystemExit(f"{label}: {tag}: K3 differs from its plain version")
        out[f"{tag}_ms"] = ms(run, 100)
        dev_ms[tag] = device_ms(run, ["cell_state_kernel"], 50)
        out[f"{tag}_active"] = int(stacked[1].sum())
        prepped = rs.prep_volume(vol_)
        batch = lambda: rs.cell_state_batch(  # noqa: E731
            lookups, prepped, grid_size=size, width=w, height=h)
        out[f"{tag}_batch_ms"] = ms(batch, 100)
        dev_ms[f"{tag}_batch"] = device_ms(batch, ALL_KERNELS, 50)

    def hard_operands(vol_, coarse_, size):
        """K2's operands of the sliced frame's hard-shadow query."""
        depth, idx_ = rs.primary_sweep_cuda(vol_, coarse_, *boxed(coarse_), cam,
                                            grid_size=size, width=w, height=h)
        geo = rs.hit_geometry(cam, idx_, depth, grid_size=size, width=w, height=h)
        queries, _, _ = rs.lighting_queries(cam, *geo[:4], grid_size=size, width=w,
                                            height=h, soft_k=1)
        return (rs.stack_occlusion_queries(queries, w, h),
                dict(grid_size=size, cell_half=rs._cell_half(cam, size)))

    def time_k2(tag, vol_, coarse_, ops, k2kw, check=True):
        box = boxed(coarse_)
        run = lambda: rs.shadow_sweep_cuda(vol_, coarse_, *box, *ops, **k2kw)  # noqa: E731
        if check and not torch.equal(
                run(), rs.shadow_sweep(vol_, *ops, **k2kw)):
            raise SystemExit(f"{label}: {tag}: K2 differs from its plain version")
        out[f"{tag}_ms"] = ms(run, 50)
        dev_ms[tag] = device_ms(run, K2_KERNELS)
        out[f"{tag}_active"] = int(ops[3].sum())

    def time_k4(tag, vol_, coarse_, size, check=True):
        kw4 = dict(grid_size=size, width=w, height=h)
        box = boxed(coarse_)
        run = lambda: rs.primary_sweep_cuda(vol_, coarse_, *box, cam, **kw4)  # noqa: E731
        if check and not torch.equal(
                run()[1], rs.primary_sweep(vol_, cam, **kw4)[1]):
            raise SystemExit(f"{label}: {tag}: K4 differs from its plain version")
        out[f"{tag}_ms"] = ms(run, 50 if size <= 512 else 20)
        dev_ms[tag] = device_ms(run, K4_KERNELS)
        out[f"{tag}_hits"] = int((run()[1] >= 0).sum())

    one = torch.zeros(1, dtype=torch.int32, device=dev)

    def time_box(tag, vol_, coarse_, size):
        """The box kernel by events, then in one trace beside the launch
        floor (a one-element torch ``fill_``) and, where the tree has it, the
        plane mip's kernel on the same volume: ``device_ms`` gets ``tag``,
        ``fill_<size>`` and ``plane_occupancy_<size>``."""
        from cellularautomatons3d_tpu_torch.ops import occupancy

        if hasattr(occupancy, "occupied_box_cuda"):
            run = lambda: occupancy.occupied_box_cuda(coarse_, size)  # noqa: E731
            out[f"{tag}_ms"] = ms(run, 200)
            plane = getattr(occupancy, "plane_occupancy_cuda", None)

            def beside():
                run()
                one.fill_(1)
                if plane is not None:
                    plane(vol_)

            iters = 100
            events = device_events(beside, iters)
            # The plane mip's kernel: its own before the occupancy rebuild
            # took it in, the rebuild's since (the only one launched here).
            for key, kernel in ((tag, ("occupied_box_kernel",)), (f"fill_{size}", ("FillFunctor",)),
                                (f"plane_occupancy_{size}",
                                 ("plane_occupancy_kernel", "coarse_occupancy_kernel"))):
                us = [t for name, t in events if any(k in name for k in kernel)]
                dev_ms[key] = sum(us) / iters / 1000.0 if us else None
            out[f"{tag}_box"] = run().tolist()

    # The prepass frame's contract: K1 computes its own masks since the
    # redesign (``prepass``), and K6 reads the undilated mip; before it the
    # frame ran the two dilations, K6 on their mip and K1 with its masks.
    inline = "prepass" in inspect.signature(rf.raytrace_cuda).parameters

    def time_prepass(g, vol_, coarse_, hist_, idx_):
        """K6, the dilations (where the frame runs them), K1 given the plain
        masks and the whole prepass frame, compose, checked against K1
        without masks."""
        from cellularautomatons3d_tpu_torch.ops.occupancy import dilate_occupancy

        dilate = lambda: dilate_occupancy(  # noqa: E731
            dilate_occupancy(coarse_, dilate_z=False), dilate_z=False, dilate_y=False)
        pre = dilate()
        plain = rf.prepass(pre, cam, grid_size=n, width=w, height=h)
        k6_in = coarse_ if inline else pre
        k6 = lambda: rf.prepass_cuda(k6_in, cam, grid_size=n, width=w, height=h)  # noqa: E731
        if not torch.equal(k6(), plain):
            raise SystemExit(f"{label}: K6 {g} differs from its plain version")
        masked = lambda: rf.raytrace_cuda(  # noqa: E731
            vol_, coarse_, cam, hist_, colmask=plain, **kw)
        frame = lambda: rf.raytrace_tiles(vol_, coarse_, cam, hist_,  # noqa: E731
                                          use_prepass=True, **kw)
        if not (torch.equal(masked()[2], idx_) and torch.equal(frame()[2], idx_)):
            raise SystemExit(f"{label}: the prepass frame {g} differs from K1 without masks")
        out[f"k6_{g}_ms"] = ms(k6, 200)
        dev_ms[f"k6_{g}"] = device_ms(k6, ["prepass_kernel"], 50)
        if not inline:
            out[f"dilations_{g}_ms"] = ms(dilate, 200)
            dev_ms[f"dilations_{g}"] = device_ms(dilate, ALL_KERNELS, 50)
        out[f"k1_compose_masked_{g}_ms"] = ms(masked)
        dev_ms[f"k1_compose_masked_{g}"] = device_ms(masked, ["render_kernel"])
        out[f"prepass_frame_{g}_ms"] = ms(frame)
        events = device_events(frame, 20)
        dev_ms[f"prepass_frame_{g}"] = sum(t for _, t in events) / 20 / 1000.0
        out[f"prepass_frame_{g}_kernels"] = len(events) / 20
        out[f"prepass_frame_{g}_kernel_names"] = sorted({k[:60] for k, _ in events})

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
        time_prepass(g, vol, coarse, hist, idx)
        k2, k2kw = k2_operands(vol, coarse, n)
        tag = "k2_8q_256" if steps == 80 else f"k2_8q_256_{g}"
        time_k2(tag, vol, coarse, k2, k2kw)
        if steps == 80:
            idle = (*k2[:3], torch.zeros_like(k2[3]))
            time_k2("k2_8q_256_idle", vol, coarse, idle, k2kw, check=False)
        del k2
        queries, lookups = frame_queries(vol, coarse, n)
        time_k5("k5_8q_256" if steps == 80 else f"k5_8q_256_{g}", vol, coarse, queries, n)
        if steps == 80:
            idle = [(s_, t_, e_, torch.zeros_like(a_)) for s_, t_, e_, a_ in queries]
            time_k5("k5_8q_256_idle", vol, coarse, idle, n, check=False)
            time_occlusion_batch("occlusion_batch_8q_256", vol, coarse, queries, n)
            time_k3("k3_4q_256", vol, lookups, n)
        del queries, lookups
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
            time_box("box_256", vol, coarse, n)
    # The sliced sizes: K4 (and the hard-shadow K2) on the centre seed grown
    # 160 generations at 512³, 260 at 512³ (the box is the whole volume) and
    # 200 at 1024³; K4 on an empty volume; the CA step at 512³ on gen-160
    # and at 1024³ on the seed.
    for size, steps in ((512, 160), (512, 260), (1024, 200)):
        big_spec = AutomatonSpec.from_rule_strings(size)
        big = ct.from_reference(ct.pack_grid(ct.seed_center(size)), dev)
        for gen in range(steps + 1):
            if (size, steps, gen) in ((512, 160, 160), (1024, 200, 0)):
                out[f"ca_step_{size}_ms"] = ms(lambda: ca_step.fires_plane_cuda(big, big_spec), 50)
                dev_ms[f"ca_step_{size}"] = device_ms(
                    lambda: ca_step.fires_plane_cuda(big, big_spec), ["ca_step_kernel"])
            if gen < steps:
                big = ca_step.fires_plane_cuda(big, big_spec)
        big_coarse = coarse_occupancy(big)
        tag = f"k4_{size}" if steps != 260 else "k4_512_gen260"
        time_k4(tag, big, big_coarse, size)
        if steps != 260:
            time_box(f"box_{size}", big, big_coarse, size)
            time_k2(f"k2_hard_{size}", big, big_coarse, *hard_operands(big, big_coarse, size))
        if size == 512 and steps == 160:
            time_k2("k2_8q_512", big, big_coarse, *k2_operands(big, big_coarse, size))
        if steps != 260:
            queries, lookups = frame_queries(big, big_coarse, size)
            if size == 512:
                time_k5("k5_8q_512", big, big_coarse, queries, size)
            time_k3(f"k3_4q_{size}", big, lookups, size)
            del queries, lookups
        del big
        if steps == 200 or steps == 160:
            empty = torch.zeros((size // 32, size, size), dtype=torch.int32, device=dev)
            time_k4(f"k4_{size}_empty", empty, coarse_occupancy(empty), size, check=False)
            del empty
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
    # The alive / visibility pass alone on random ages at each size.
    for size in (256, 512, 1024):
        ages = planes if size == 1024 else random_ages(size, 3)
        run = lambda: ca_step.age_masks_cuda(ages)  # noqa: E731
        out[f"age_masks_{size}_ms"] = ms(run, 100 if size < 1024 else 20)
        dev_ms[f"age_masks_{size}"] = device_ms(run, ["age_masks_kernel"], 50)
    del planes, alive

    # Step + frame of the lighting configurations, profiled: full quality at
    # 256³ with each occlusion backend, gi_temporal and two bounces at 256³
    # and gi_temporal at 512³ with the default one.
    from torch.profiler import ProfilerActivity, profile

    def profile_frames(eng, frames):
        eng.run_fused(frames, reset_every=frames)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.run_fused(frames, reset_every=frames)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / frames
        by_kernel = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                k = next((k for k in ("shadow_sweep_kernel", "shadow_multi_kernel",
                                      "cell_state_kernel", "occupied_box_kernel",
                                      "render_kernel", "primary_sweep_kernel",
                                      "ca_step_kernel") if k in e.name), "torch")
                t_, c_ = by_kernel.get(k, (0.0, 0))
                by_kernel[k] = (t_ + e.time_range.elapsed_us() / 1e3 / frames, c_ + 1)
        busy = sum(t_ for t_, _ in by_kernel.values())
        return {"wall_ms": wall, "device_ms": busy, "busy_share": busy / wall,
                "launches_per_frame": sum(c_ for _, c_ in by_kernel.values()) / frames,
                "device_ms_by_kernel": {k: v[0] for k, v in by_kernel.items()}}

    lit = dict(soft_shadow_samples=4, indirect_lighting=True, light_radius=0.08)
    for name, size, steps, cfg, frames, backends in (
        ("full_quality", n, 80, {}, 10, ("1", "0", "0", "1")),
        ("gi_temporal", n, 80, dict(gi_temporal=True), 10, ("1", "1")),
        ("two_bounces", n, 80, dict(indirect_bounces=2), 3, ("1", "1")),
        ("sliced_512_gi_temporal", 512, 160, dict(gi_temporal=True), 10, ("1", "1")),
    ):
        eng = ct.Engine(grid_size=size, width=w, height=h, device="cuda", **lit, **cfg)
        eng.step(steps)
        for env in backends:
            os.environ["CA3D_OCC_SWEEP"] = env
            out.setdefault(f"frame_{name}_{'k2' if env == '1' else 'k5'}", []).append(
                profile_frames(eng, frames))
        del eng
    os.environ.pop("CA3D_OCC_SWEEP")
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
