"""The port's multi-device dry run: every mesh path once, on given devices."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["dryrun_multichip"]


def dryrun_multichip(n_devices: int, devices=None) -> str:
    """Run each multi-device path of the port once at a small size over an
    ``n_devices`` mesh of ``devices`` (every CUDA device by default; a list
    may repeat one, ``["cpu"] * 4``), the twin of the JAX package's
    ``__graft_entry__.dryrun_multichip``:

    1. a z-sharded CA step (halo exchange), equal to the single-device step;
    2. a row-sharded frame: ``Engine(mesh_devices=N).render()``;
    3. a 2-D ``(N/2, 2)`` mesh Engine stepped (for even N ≥ 4);
    4. a mesh frame through the sliced path (``force_sliced``);
    5. a 10-frame mesh ``run_fused``.

    The grid is 512³ from 8 devices on and ``max(64, 32 N)``³ below, the
    window 64 × 16 N.  Returns the summary line it prints."""
    from ..engine import Engine
    from ..models.automaton import AutomatonSpec
    from ..ops import packing
    from ..ops.ca_step import step_packed
    from ..utils.config import EngineConfig
    from .sharded import make_mesh, make_sharded_step, shard_state

    mesh = make_mesh(n_devices, devices=devices)
    devices = list(mesh.devices.flat)
    home = devices[0]
    grid = 512 if n_devices >= 8 else max(64, 32 * n_devices)
    height = 16 * n_devices
    common = dict(grid_size=grid, width=64, height=height)

    # 1) The z-sharded step against the single-device step.
    spec = AutomatonSpec.from_config(EngineConfig(grid_size=grid))
    packed = torch.from_numpy(packing.pack_grid(packing.seed_center(grid)).view(np.int32))
    state = make_sharded_step(spec, mesh)(shard_state(packed, mesh))
    want = step_packed(packed.to(home), spec)
    if not torch.equal(state.full(home), want):
        raise AssertionError("sharded step != single-device step")

    # 2) The row-sharded frame of the mesh Engine.
    eng = Engine(EngineConfig(mesh_devices=n_devices, **common), device=home,
                 mesh_device_list=devices)
    eng.step(2)
    frame = eng.render()
    if tuple(frame.shape) != (height, 64, 3) or not bool(torch.isfinite(frame).all()):
        raise AssertionError(f"mesh frame {tuple(frame.shape)} is not a finite window")

    # 3) A 2-D (z, y) mesh.
    note = ""
    if n_devices >= 4 and n_devices % 2 == 0:
        eng2 = Engine(EngineConfig(mesh_shape=(n_devices // 2, 2), **{**common, "grid_size": 64}),
                      device=home, mesh_device_list=devices)
        eng2.step(2)
        note = f" + 2-D ({n_devices // 2}, 2) Engine(mesh_shape)"

    # 4) A mesh frame through the sliced path.
    eng.render_static = dataclasses.replace(eng.render_static, force_sliced=True)
    framef = eng.render()
    if not bool(torch.isfinite(framef).all()):
        raise AssertionError("sliced mesh frame is not finite")

    # 5) The mesh fused loop.
    engl = Engine(EngineConfig(mesh_devices=n_devices, **{**common, "grid_size": 64}),
                  device=home, mesh_device_list=devices)
    engl.step(2)
    framel = engl.run_fused(10)
    if engl.simulation_step != 12 or not bool(torch.isfinite(framel).all()):
        raise AssertionError("mesh run_fused")

    line = (f"dryrun_multichip OK: {n_devices}-shard mesh on "
            f"{sorted({str(d) for d in devices})}, grid {grid}^3 (z-sharded step + "
            f"row-sharded frame + Engine(mesh_devices){note} + sliced mesh frame + "
            f"10-frame fused mesh loop)")
    print(line, flush=True)
    return line
