#!/usr/bin/env python3
"""Time the binary path's kernels -- K1 (``render_fast.raytrace_cuda``, no
column mask, no ages), K4 (``render_slab.primary_sweep_cuda``) and the binary
CA step -- of one checkout of the PyTorch/CUDA port on the card, for an A/B
of two commits in one call.

    python3 tools/time_k1.py <repo root> [label]

Imports ``cellularautomatons3d_tpu_torch`` from ``<repo root>`` (which builds
its own kernels there), steps the centre seed 80 generations at 256³ with
the default rule, and times K1 at 1920×1080 from the initial view in
compose mode (against a history that keeps its ids) and in non-compose
mode, with CUDA events over 100 launches after 5 of warm-up; then K4 at 512³
on the scene after 160 generations and the CA step at 256³, 512³ and 1024³.
Prints one JSON line with the times, the label and the card.  Compare two trees by
running them in turns in one call: parent, change, change, parent.
"""

import json
import subprocess
import sys
from pathlib import Path


def main():
    root = Path(sys.argv[1]).resolve()
    label = sys.argv[2] if len(sys.argv) > 2 else str(root)
    sys.path.insert(0, str(root))
    import torch

    import cellularautomatons3d_tpu_torch as ct
    from cellularautomatons3d_tpu_torch.models.automaton import AutomatonSpec
    from cellularautomatons3d_tpu_torch.ops import ca_step
    from cellularautomatons3d_tpu_torch.ops.occupancy import coarse_occupancy
    from cellularautomatons3d_tpu_torch.render import render_fast as rf
    from cellularautomatons3d_tpu_torch.render import render_slab as rs
    from cellularautomatons3d_tpu_torch.utils import mat4

    if Path(ct.__file__).resolve().parent.parent != root:
        raise SystemExit(f"imported {ct.__file__}, not the package under {root}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    n, w, h = 256, 1920, 1080
    dev = torch.device("cuda", 0)
    spec = AutomatonSpec.from_rule_strings(n)
    vol = ct.from_reference(ct.pack_grid(ct.seed_center(n)), dev)
    for _ in range(80):
        vol = ca_step.fires_plane_cuda(vol, spec)
    coarse = coarse_occupancy(vol)
    d = ct.EngineConfig()
    cam = rf.pack_cam(mat4.initial_view_matrix(), w, h, d.light.position, d.light.magnitude,
                      d.cell_size, d.roughness, d.base_reflectivity, d.material_color,
                      temporal_alpha=d.temporal_alpha, gamma=d.gamma)
    kw = dict(grid_size=n, width=w, height=h, shadow=True)
    rgb, _, idx = rf.raytrace_cuda(vol, coarse, cam, **kw)
    hist = (torch.clamp(rgb * 1.5 + 0.02, 0.0, 1.0).contiguous(), idx.contiguous())

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

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    out = {
        "label": label,
        "k1_compose_ms": ms(lambda: rf.raytrace_cuda(vol, coarse, cam, hist, **kw)),
        "k1_noncompose_ms": ms(lambda: rf.raytrace_cuda(vol, coarse, cam, **kw)),
        "hit_pixels": int((idx >= 0).sum()),
        "ca_step_256_ms": ms(lambda: ca_step.fires_plane_cuda(vol, spec), 1000, 20),
    }
    for size, steps in ((512, 160), (1024, 0)):
        big_spec = AutomatonSpec.from_rule_strings(size)
        big = ct.from_reference(ct.pack_grid(ct.seed_center(size)), dev)
        for _ in range(steps):
            big = ca_step.fires_plane_cuda(big, big_spec)
        out[f"ca_step_{size}_ms"] = ms(lambda: ca_step.fires_plane_cuda(big, big_spec), 50)
        if size == 512:
            big_coarse = coarse_occupancy(big)
            out["k4_512_ms"] = ms(lambda: rs.primary_sweep_cuda(
                big, big_coarse, cam, grid_size=size, width=w, height=h), 50)
    print(json.dumps({**out, "card": card}), flush=True)


if __name__ == "__main__":
    main()
