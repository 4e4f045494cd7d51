"""Fast render pipeline: the K1 kernel plus frame composition.

Port of ``cellularautomatons3d_tpu.render.renderer_fast`` for the
configurations this port covers: hard shadows, no GI, grid ≤ 256, a static
camera, binary states.

* :func:`render_frame_fast` -- one frame: K1 in its non-compose mode, then
  the temporal EMA (validated by the stored hit-cell id), the light cube,
  f16 history, the depth overlay and gamma in torch.
* :func:`make_fused_loop` -- the production loop (step + composed frame per
  iteration, K1 in compose mode), with ``reset_every`` as a runtime
  argument.  History is f32 inside the loop and f16 at its exit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.ca_step import step_packed
from ..ops.occupancy import coarse_occupancy
from .camera import get_ray, pixel_uvs
from .intersect import ray_cube_intersect
from .render_fast import P_EMIS, P_EMISS, P_LEN, raytrace_tiles
from .renderer import RenderParams, RenderStatic

__all__ = [
    "FastHistory",
    "init_fast_history",
    "trace_shaded",
    "render_frame_fast",
    "make_fused_loop",
    "check_supported",
]


class FastHistory(NamedTuple):
    color: torch.Tensor    # [H, W, 3] float16 linear light
    hit_idx: torch.Tensor  # [H, W] int32 cell id (-1 = miss)


def init_fast_history(width: int, height: int, device) -> FastHistory:
    return FastHistory(
        color=torch.zeros((height, width, 3), dtype=torch.float16, device=device),
        hit_idx=torch.full((height, width), -1, dtype=torch.int32, device=device),
    )


def check_supported(s: RenderStatic) -> None:
    """Raise NotImplementedError for render settings not ported yet."""
    if s.soft_shadow_samples > 1 or s.indirect_lighting or s.gi_temporal:
        raise NotImplementedError(
            "soft shadows, GI and gi_temporal are not ported yet "
            "(ROADMAP.md queue 1, item 6)"
        )
    if s.grid_size > 256:
        raise NotImplementedError(
            "grids above 256³ (the sliced path) are not ported yet "
            "(ROADMAP.md queue 1, item 7)"
        )


def _cam_vec(params: RenderParams, w, h) -> np.ndarray:
    """Pack RenderParams into the kernel's parameter vector (host f32)."""
    cam = np.concatenate(
        [
            np.asarray(params.view_mat, np.float32)[:3, :3].reshape(-1),
            np.asarray(params.view_mat, np.float32)[:3, 3],
            np.array([w, h], np.float32),
            np.asarray(params.light_pos, np.float32).reshape(3),
            np.float32([params.light_magnitude]),
            np.float32([params.cell_size]),
            np.float32([params.roughness]),
            np.asarray(params.base_reflectivity, np.float32).reshape(3),
            np.asarray(params.material_color, np.float32).reshape(3),
            np.float32([params.light_radius]),
            np.asarray(params.emissive_color, np.float32).reshape(3),
            np.float32([params.emissive_strength]),
            np.float32([params.elapsed_time]),
            np.float32([0.0]),  # P_ROW0: no row shards (mesh render)
            np.float32([params.temporal_alpha]),
            np.float32([params.gamma]),
            np.float32([params.show_depth_overlay]),
            np.zeros((4,), np.float32),
        ]
    )
    assert cam.shape == (P_LEN,)
    return cam


def trace_shaded(s: RenderStatic, packed: torch.Tensor, cam: np.ndarray):
    """Traced + shaded scene: (rgb [H,W,3] linear light, depth, hit_idx).

    K1 with the hard shadow, then emissive radiance on every hit
    (renderer.py:263-264)."""
    check_supported(s)
    rgb, depth, idx = raytrace_tiles(
        packed, coarse_occupancy(packed), cam,
        grid_size=s.grid_size, width=s.width, height=s.height, shadow=True,
    )
    emis = torch.from_numpy(cam[P_EMIS : P_EMIS + 3] * cam[P_EMISS]).to(rgb.device)
    rgb = torch.where((idx >= 0)[..., None], rgb + emis, rgb)
    return rgb, depth, idx


def render_frame_fast(s: RenderStatic, packed: torch.Tensor,
                      params: RenderParams, history: FastHistory,
                      camera_static: bool = True):
    """One fast-path frame.  Returns (presentation [H,W,3] f32, depth
    [H,W] f32, new FastHistory).  Static camera only: the reprojection of a
    moving camera is not ported yet."""
    if not camera_static:
        raise NotImplementedError(
            "a moving camera (history reprojection) is not ported yet "
            "(ROADMAP.md queue 1, item 8)"
        )
    h, w = s.height, s.width
    cam = _cam_vec(params, w, h)
    rgb, depth, idx = trace_shaded(s, packed, cam)
    dev = rgb.device

    uv = pixel_uvs(w, h, device=dev)
    ray_cam = get_ray(uv, (w, h))
    rot = torch.from_numpy(np.asarray(params.view_mat, np.float32)[:3, :3]).to(dev)
    view_ray = ray_cam @ rot.T
    camera_pos = torch.from_numpy(np.asarray(params.view_mat, np.float32)[:3, 3]).to(dev)

    # Temporal EMA (wgsl:429-471): same-cell history blended with alpha.
    prev = history.color.to(torch.float32)
    same_cell = (idx == history.hit_idx) & (idx >= 0)
    alpha = float(np.float32(params.temporal_alpha))
    mixed = torch.clamp(prev + (rgb - prev) * alpha, 0.0, 1.0)
    out = torch.where(same_cell[..., None], mixed, rgb)

    # Light-source cube (wgsl:866-874).
    light_pos = torch.from_numpy(np.asarray(params.light_pos, np.float32)).to(dev)
    lt_near, lt_far = ray_cube_intersect(
        camera_pos, view_ray, light_pos, float(np.float32(0.005))
    )
    light_hit = (lt_near <= lt_far) & (lt_far >= 0.0)
    black = (out == 0.0).all(dim=-1)
    out = torch.where((light_hit & black)[..., None], 1.0, out)

    # History snapshots the scene (incl. the light cube), not the overlay.
    new_history = FastHistory(color=out.to(torch.float16), hit_idx=idx)

    # Depth overlay (wgsl:880-883), then gamma.
    if float(params.show_depth_overlay) == 1.0:
        overlay = (uv[..., 0] < 0.5)[..., None]
        overlay_rgb = torch.stack(
            [depth, torch.zeros_like(depth), torch.zeros_like(depth)], dim=-1
        )
        out = torch.where(overlay, overlay_rgb, out)
    presentation = torch.pow(out, float(np.float32(1.0) / np.float32(params.gamma)))
    return presentation, depth, new_history


def make_fused_loop(s: RenderStatic, spec, frames: int,
                    steps_per_frame: int = 1, reset_every: int = 0):
    """The production loop: ``frames`` iterations of (CA steps + one
    composed frame), K1 in compose mode.

    Returns ``run(state, params, history) -> (state, history, last_frame)``.
    ``reset_every > 0`` restores the input state after every that many
    frames (the benchmark's pinned scene: every frame still steps and
    renders).  Static camera.  The input ``state`` is not modified."""
    check_supported(s)
    if spec.total_states != 2:
        raise NotImplementedError(
            "multi-state rules are not ported yet (ROADMAP.md queue 1, item 14)"
        )
    h, w, n = s.height, s.width, s.grid_size

    def run(state, params: RenderParams, history: FastHistory):
        cam = _cam_vec(params, w, h)
        hist = (history.color.to(torch.float32), history.hit_idx)
        st = state
        frame = torch.zeros((h, w, 3), dtype=torch.float32, device=state.device)
        for i in range(frames):
            for _ in range(steps_per_frame):
                st = step_packed(st, spec)
            frame, _, idx, color = raytrace_tiles(
                st, coarse_occupancy(st), cam, hist,
                grid_size=n, width=w, height=h, shadow=True,
            )
            hist = (color, idx)
            if reset_every > 0 and (i + 1) % reset_every == 0:
                st = state
        new_history = FastHistory(color=hist[0].to(torch.float16), hit_idx=hist[1])
        return st, new_history, frame

    return run
