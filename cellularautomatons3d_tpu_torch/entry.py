"""The flagship forward step: one CA generation, then one frame of the exact
reference pipeline, the twin of the JAX package's ``__graft_entry__.entry``.

    python -m cellularautomatons3d_tpu_torch.entry                  # on the card
    python -m cellularautomatons3d_tpu_torch.entry --device cpu
    python -m cellularautomatons3d_tpu_torch.entry dryrun 4 [--device cpu]

:func:`entry` returns ``(fn, (packed, params, history))`` on the scene of
:func:`_example` (the centre seed at 64³, 320×240, 16 depth and 8 shadow
steps); ``fn(packed, params, history)`` returns ``(frame, new_packed,
new_history)``.  The generation is ``ops.ca_step.step_packed``: the CA step's
hand kernel (``csrc/ca_step.cu``) on the card, its plain twin on the CPU.
The frame is ``render.renderer.render_frame``, plain torch on the state's
device, as the reference runs it in XLA.  Without a subcommand the module
runs ``fn`` once and prints ``entry OK:`` and the shapes of its outputs;
``dryrun N`` (8 by default) runs ``parallel.dryrun_multichip`` over N shards,
on the host's cards in turn (several shards to a card when N exceeds them) or
on the CPU under ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .models.automaton import AutomatonSpec
from .ops.ca_step import step_packed
from .ops.packing import pack_grid, seed_center
from .render.renderer import RenderParams, RenderStatic, init_history, render_frame
from .utils import mat4
from .utils.config import EngineConfig

__all__ = ["entry", "main"]


def _device(device) -> torch.device:
    """``device`` as a torch device: the card or the CPU, nothing else, and
    the card only when there is one."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "entry(device='cuda') needs a CUDA device, and "
            "torch.cuda.is_available() is false; pass device='cpu' for "
            "the plain torch path"
        )
    return dev


def _example(grid=64, width=320, height=240, device="cuda"):
    """``(spec, s, packed, params, history)`` of the flagship step's scene:
    the default rule (von Neumann B1,3/S0-6) on the centre seed, the initial
    camera, ``depth_samples=16``, ``shadow_samples=8`` and a zero history;
    the packed words on ``device``."""
    dev = _device(device)
    spec = AutomatonSpec.from_config(EngineConfig(grid_size=grid))
    words = pack_grid(seed_center(grid)).view(np.int32)
    packed = torch.from_numpy(words.copy()).to(dev)
    view = mat4.initial_view_matrix()
    proj = mat4.initial_projection_matrix(width, height)
    proj_view = mat4.multiply(proj, mat4.inverse(view))
    s = RenderStatic(width=width, height=height, grid_size=grid,
                     depth_samples=16, shadow_samples=8)
    f32 = np.float32
    params = RenderParams(
        view_mat=np.asarray(view, f32),
        prev_view_mat=np.asarray(view, f32),
        prev_proj_view=np.asarray(proj_view, f32),
        elapsed_time=f32(0.1),
        cell_size=f32(0.85),
        temporal_alpha=f32(0.1),
        gamma=f32(2.0),
        roughness=f32(0.29),
        base_reflectivity=np.full(3, 0.17, f32),
        material_color=np.zeros(3, f32),
        light_pos=np.asarray([0.721, 1.0, 1.0], f32),
        light_magnitude=f32(5.0),
        show_depth_overlay=f32(0.0),
    )
    history = init_history(width, height, dev)
    return spec, s, packed, params, history


def entry(device="cuda"):
    """``(fn, (packed, params, history))``: the flagship forward step on
    :func:`_example`'s scene, its tensors on ``device`` (the card unless the
    caller asks for the CPU).  ``fn`` steps the state once and renders it."""
    spec, s, packed, params, history = _example(device=device)

    def fn(packed, params, history):
        new_packed = step_packed(packed, spec)
        frame, new_history = render_frame(s, new_packed, params, history)
        return frame, new_packed, new_history

    return fn, (packed, params, history)


def _shapes(out):
    frame, packed, history = out
    return (tuple(frame.shape), tuple(packed.shape),
            type(history)(*(tuple(t.shape) for t in history)))


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(
        prog="python -m cellularautomatons3d_tpu_torch.entry",
        description=__doc__.splitlines()[0])
    ap.add_argument("command", nargs="?", choices=["dryrun"],
                    help="dryrun: the multi-device dry run instead of the step")
    ap.add_argument("n", nargs="?", type=int, default=8,
                    help="shards of the dry run (default 8)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = _device(args.device)
    if args.command == "dryrun":
        from .parallel.dryrun import dryrun_multichip

        if dev.type == "cpu":
            devices = ["cpu"] * args.n
        else:
            cards = torch.cuda.device_count()
            devices = [torch.device("cuda", i % cards) for i in range(args.n)]
        return dryrun_multichip(args.n, devices=devices)
    fn, example = entry(dev)
    out = fn(*example)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    line = f"entry OK: {_shapes(out)}"
    print(line, flush=True)
    return line


if __name__ == "__main__":
    main()
