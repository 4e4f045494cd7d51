"""Fast render pipeline: the traced frame (K1 up to 256³, the sliced path
above), the extended lighting, and frame composition.

Port of ``cellularautomatons3d_tpu.render.renderer_fast`` for grids up to
1024³, binary and multi-state rules.  For a multi-state
rule ``packed`` is the visibility plane (any cell with age ≥ 1) and
``ages`` / ``total_states`` carry the age bit-planes, whose hit ages fade
the direct term in K1 and in the sliced path; shadows, GI lookups and the
occupancy mip take the visibility plane, so a dying cell is hit, occludes
and counts as a GI neighbour like a live one:

* :func:`trace_shaded` -- the traced and shaded scene.  Up to 256³: K1
  with the hard shadow, or K1 unshadowed followed by the extended lighting
  of ``render_slab`` (soft shadows through K2, one- or multi-bounce GI
  through K2 and K3, the temporally amortized mode).  Above 256³, or with
  ``RenderStatic.force_sliced``: ``render_slab.raytrace_sliced`` (K4's
  primary hits, every shadow through K2, GI through K2 and K3, the BRDF in
  torch).  Then emissive light.
* :func:`render_frame_fast` -- one frame: trace_shaded, then the temporal
  EMA (validated by the stored hit-cell id; after a camera move the history
  is reprojected first, :func:`reproject_history`), the light cube, f16
  history, the depth overlay and gamma in torch.
* :func:`make_fused_loop` -- the production loop (CA steps + one composed
  frame per iteration, static camera) with ``reset_every`` as a runtime
  argument.  Up to
  256³: K1 in compose mode for hard shadows without GI, the extended frame
  in image layout for soft shadows, one-bounce and temporal GI (history f32
  inside, f16 at the exit), and render_frame_fast per iteration for
  multi-bounce GI.  The sliced path always takes render_frame_fast per
  iteration, as in the reference, so its history is f16 between frames.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.ca_step import step_packed, visibility_plane
from ..ops.occupancy import coarse_occupancy
from .camera import COT_HALF_FOV, get_ray, pixel_uvs
from .intersect import device_vec, ray_cube_intersect
from .render_fast import (
    MAX_GRID, P_ALPHA, P_EMIS, P_EMISS, P_GAMMA, P_LEN, P_LIGHT, P_O,
    P_OVERLAY, raytrace_tiles,
)
from .render_slab import (
    _hit_geometry,
    _pixel_uv,
    direct_occlusion,
    indirect_bounce,
    lighting_passes,
    prep_volume,
    raytrace_sliced,
)
from .renderer import RenderParams, RenderStatic, _get_reprojected_uv

__all__ = [
    "FastHistory",
    "init_fast_history",
    "trace_shaded",
    "reproject_history",
    "render_frame_fast",
    "make_fused_loop",
]


class FastHistory(NamedTuple):
    color: torch.Tensor    # [H, W, 3] float16 linear light
    hit_idx: torch.Tensor  # [H, W] int32 cell id (-1 = miss)


def init_fast_history(width: int, height: int, device) -> FastHistory:
    return FastHistory(
        color=torch.zeros((height, width, 3), dtype=torch.float16, device=device),
        hit_idx=torch.full((height, width), -1, dtype=torch.int32, device=device),
    )


def _sliced(s: RenderStatic) -> bool:
    """Whether the frame goes through the sliced path (K4 + K2) instead of
    K1."""
    return s.grid_size > MAX_GRID or s.force_sliced


def _cam_vec(params: RenderParams, w, fh, row0=0.0) -> np.ndarray:
    """Pack RenderParams into the kernel's parameter vector (host f32) for a
    window of ``w`` × ``fh`` pixels whose rendered rows start at ``row0``."""
    cam = np.concatenate(
        [
            np.asarray(params.view_mat, np.float32)[:3, :3].reshape(-1),
            np.asarray(params.view_mat, np.float32)[:3, 3],
            np.array([w, fh], np.float32),
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
            np.float32([row0]),
            np.float32([params.temporal_alpha]),
            np.float32([params.gamma]),
            np.float32([params.show_depth_overlay]),
            np.zeros((4,), np.float32),
        ]
    )
    assert cam.shape == (P_LEN,)
    return cam


def _extended_lighting(s: RenderStatic, packed, coarse, cam, rgb, depth, idx,
                       sample_idx):
    """Soft shadows and GI on top of K1's frame (renderer_fast.py:121-178):
    returns (rgb with occlusion and indirect light, the world ray
    direction d [H, W, 3])."""
    n, w, h = s.grid_size, s.width, s.height
    soft = s.soft_shadow_samples > 1
    gi = s.indirect_lighting
    temporal = s.gi_temporal and sample_idx is not None
    prepped = prep_volume(packed, coarse)
    q, origin, coords, found, d = _hit_geometry(cam, idx, depth, n, w, h)
    jitter_k = sample_idx % s.soft_shadow_samples if soft and temporal else None
    kw = dict(grid_size=n, width=w, height=h)
    if not gi or temporal or s.indirect_bounces == 1:
        # Every occlusion query of the frame (soft samples and GI slots)
        # rides one K2 launch.
        occl, gi_rgb = lighting_passes(
            cam, q, origin, coords, found, prepped,
            soft_k=s.soft_shadow_samples if soft else None, jitter_k=jitter_k,
            gi=gi, gi_slot=sample_idx % 4 if gi and temporal else None, **kw,
        )
    else:
        # Multi-bounce recursion: per-level passes.
        occl = (
            direct_occlusion(cam, q, coords, found, prepped,
                             soft_k=s.soft_shadow_samples, **kw)
            if soft else None
        )
        gi_rgb = indirect_bounce(
            packed, cam, q, origin, coords, found, prepped,
            bounces=s.indirect_bounces, **kw,
        )
    if occl is not None:
        # K1's rgb is unshadowed (but age-faded) direct light when soft;
        # occl multiplies it.
        rgb = rgb * occl[..., None]
    if gi_rgb is not None:
        rgb = rgb + torch.where(found[..., None], gi_rgb, 0.0)
    return rgb, d


def _shaded(s: RenderStatic, packed, cam, sample_idx, ages=None, total_states=2):
    """trace_shaded's (rgb, depth, idx) and, with K1's extended lighting,
    the world ray direction d [H, W, 3] (else None)."""
    d = None
    if _sliced(s):
        rgb, depth, idx = raytrace_sliced(
            packed, cam, ages, grid_size=s.grid_size, width=s.width,
            height=s.height, total_states=total_states,
            soft_shadow_samples=s.soft_shadow_samples,
            indirect=s.indirect_lighting, indirect_bounces=s.indirect_bounces,
            sample_idx=sample_idx if s.gi_temporal else None,
        )
    else:
        coarse = coarse_occupancy(packed)
        rgb, depth, idx = raytrace_tiles(
            packed, coarse, cam, grid_size=s.grid_size, width=s.width,
            height=s.height, shadow=s.soft_shadow_samples <= 1, ages=ages,
            total_states=total_states,
        )
        if s.soft_shadow_samples > 1 or s.indirect_lighting:
            rgb, d = _extended_lighting(s, packed, coarse, cam, rgb, depth, idx,
                                        sample_idx)
    emis = device_vec(cam[P_EMIS : P_EMIS + 3] * cam[P_EMISS], rgb.device)
    rgb = torch.where((idx >= 0)[..., None], rgb + emis, rgb)
    return rgb, depth, idx, d


def trace_shaded(s: RenderStatic, packed: torch.Tensor, cam: np.ndarray,
                 sample_idx=None, *, ages: torch.Tensor | None = None,
                 total_states: int = 2):
    """Traced + shaded scene: (rgb [H,W,3] linear light, depth, hit_idx).

    Up to 256³: K1 with the hard shadow (unshadowed when soft shadows
    replace it) and the extended lighting of ``render_slab`` when soft
    shadows or GI are on.  Above 256³ or with ``s.force_sliced``:
    ``render_slab.raytrace_sliced``.  Then emissive radiance on every hit,
    neither shadowed nor age-faded (renderer.py:263-264).  ``ages`` /
    ``total_states``: the age bit-planes of a multi-state rule (``packed``
    is then its visibility plane).  ``sample_idx``: the frame counter of
    the temporally amortized mode (``s.gi_temporal``), an int or an int
    tensor; it rotates the soft-shadow sample and the GI slot."""
    return _shaded(s, packed, cam, sample_idx, ages, total_states)[:3]


def reproject_history(history: FastHistory, rgb: torch.Tensor,
                      depth: torch.Tensor, idx: torch.Tensor,
                      params: RenderParams, w: int, h: int,
                      full_height: int | None = None, row0: int = 0):
    """The moving camera's temporal EMA (renderer_fast.py:265-293 of the JAX
    package; getReprojectedUV and mixWithReprojectedColor, wgsl:429-487).

    Each pixel's hit point ``camera_pos + view_ray · depth`` (the ray of the
    global window: ``row0`` / ``full_height`` place these ``h`` rows in a
    window of ``full_height`` rows) is projected through
    ``params.prev_proj_view``; the history's colour and id are gathered at the
    pixel it lands on, and the history is blended with ``temporal_alpha``
    where that pixel is in bounds (inside this shard's rows), this pixel hit
    a cell, and the ids agree.

    Returns (blended rgb [h, w, 3] f32, the source pixel ``py·w + px``
    [h, w] int64, -1 where out of bounds, the valid mask [h, w] bool).  Plain
    torch ops: elementwise products and sums, divisions by tensors and
    integer conversions, so the card and the CPU agree on the same inputs."""
    fh = h if full_height is None else full_height
    dev = rgb.device
    uv = pixel_uvs(w, h, device=dev, row0=row0, full_height=fh)
    # get_ray (camera.py) and the view rotation, one component at a time.
    r = float(np.float32(w) / np.float32(fh))
    rx = (uv[..., 0] - 0.5) * r
    ry = uv[..., 1] - 0.5
    rz = torch.full_like(rx, -float(np.float32(0.5) * COT_HALF_FOV))
    norm = torch.sqrt(rx * rx + ry * ry + rz * rz)
    rx, ry, rz = rx / norm, ry / norm, rz / norm
    view = np.asarray(params.view_mat, np.float32)
    hit = torch.stack([
        float(view[i, 3])
        + (rx * float(view[i, 0]) + ry * float(view[i, 1]) + rz * float(view[i, 2])) * depth
        for i in range(3)
    ], dim=-1)
    uv_r = _get_reprojected_uv(params.prev_proj_view, hit)
    ux, uy = uv_r[..., 0], uv_r[..., 1]
    in_bounds = (ux >= 0.0) & (ux <= 1.0) & (uy >= 0.0) & (uy <= 1.0)
    # astype(int32) truncates toward zero; out-of-bounds and NaN uv (a hit
    # point on the previous camera's plane) are zeroed first, so the
    # conversion never sees a value it leaves undefined.
    ux = torch.where(in_bounds, ux, 0.0)
    uy = torch.where(in_bounds, uy, 0.0)
    px = (ux * w).to(torch.int32).clamp(0, w - 1)
    py_g = (uy * fh).to(torch.int32) - int(row0)
    in_bounds = in_bounds & (py_g >= 0) & (py_g < h)
    flat = py_g.clamp(0, h - 1).to(torch.int64) * w + px
    prev = history.color.reshape(-1, 3)[flat].to(torch.float32)
    prev_idx = history.hit_idx.reshape(-1)[flat]
    valid = in_bounds & (idx >= 0) & (prev_idx == idx)
    alpha = float(np.float32(params.temporal_alpha))
    mixed = torch.clamp(prev + (rgb - prev) * alpha, 0.0, 1.0)
    out = torch.where(valid[..., None], mixed, rgb)
    return out, torch.where(in_bounds, flat, -1), valid


def render_frame_fast(s: RenderStatic, packed: torch.Tensor,
                      params: RenderParams, history: FastHistory,
                      camera_static: bool = True, sample_idx=None, *,
                      ages: torch.Tensor | None = None, total_states: int = 2,
                      row0: int = 0, full_height: int | None = None):
    """One fast-path frame.  Returns (presentation [H,W,3] f32, depth
    [H,W] f32, new FastHistory).  ``ages`` / ``total_states``: the age
    bit-planes of a multi-state rule (``packed`` is then its visibility
    plane).  ``sample_idx``: the frame counter of the
    temporally amortized lighting mode; the EMA converges to the full
    multi-sample lighting.  ``camera_static=False``: the camera moved since
    the history's frame, whose colour is reprojected
    (:func:`reproject_history`).  ``row0`` / ``full_height``: this call
    renders the ``s.height`` rows from ``row0`` of a window of
    ``full_height`` rows (a row shard: UVs and the frustum are the whole
    window's)."""
    h, w = s.height, s.width
    fh = h if full_height is None else full_height
    cam = _cam_vec(params, w, fh, row0)
    rgb, depth, idx = trace_shaded(s, packed, cam, sample_idx, ages=ages,
                                   total_states=total_states)
    dev = rgb.device

    uv = pixel_uvs(w, h, device=dev, row0=row0, full_height=fh)
    ray_cam = get_ray(uv, (w, fh))
    rot = torch.from_numpy(np.asarray(params.view_mat, np.float32)[:3, :3]).to(dev)
    view_ray = ray_cam @ rot.T
    camera_pos = torch.from_numpy(np.asarray(params.view_mat, np.float32)[:3, 3]).to(dev)

    # Temporal EMA (wgsl:429-471): same-cell history blended with alpha.
    if camera_static:
        prev = history.color.to(torch.float32)
        same_cell = (idx == history.hit_idx) & (idx >= 0)
        alpha = float(np.float32(params.temporal_alpha))
        mixed = torch.clamp(prev + (rgb - prev) * alpha, 0.0, 1.0)
        out = torch.where(same_cell[..., None], mixed, rgb)
    else:
        out, _, _ = reproject_history(history, rgb, depth, idx, params, w, h, fh, row0)

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


def _ext_frame(s: RenderStatic, vis, cam, hist, ages, total_states, sample_idx):
    """One extended-lighting frame (soft shadows, one-bounce or temporal
    GI) of the fused loop, composed in torch: trace_shaded (K1, one K2 and
    one K3 launch, emissive light), the id-checked EMA against the f32 history,
    the light cube, the depth overlay and gamma (_ext_frame_blocked,
    renderer_fast.py:318-407, in image layout).  Returns (presentation,
    new history (color f32, ids))."""
    rgb, depth, idx, d = _shaded(s, vis, cam, sample_idx, ages, total_states)
    dev = rgb.device
    found = idx >= 0
    prev, prev_idx = hist
    same = (idx == prev_idx) & found
    mixed = torch.clamp(prev + (rgb - prev) * float(cam[P_ALPHA]), 0.0, 1.0)
    out = torch.where(same[..., None], mixed, rgb)
    lt_near, lt_far = ray_cube_intersect(
        device_vec(cam[P_O : P_O + 3], dev), d,
        device_vec(cam[P_LIGHT : P_LIGHT + 3], dev), float(np.float32(0.005)),
    )
    light_hit = (lt_near <= lt_far) & (lt_far >= 0.0)
    black = (out == 0.0).all(dim=-1)
    out = torch.where((light_hit & black)[..., None], 1.0, out)
    new_hist = (out, idx)

    # Depth overlay before gamma, as render_frame_fast.
    ux, _ = _pixel_uv(cam, s.width, s.height, dev)
    overlay = (ux < 0.5) & bool(cam[P_OVERLAY] == 1.0)
    overlay_rgb = torch.stack([depth, torch.zeros_like(depth), torch.zeros_like(depth)], dim=-1)
    out = torch.where(overlay[..., None], overlay_rgb, out)
    pres = torch.pow(out, float(np.float32(1.0) / cam[P_GAMMA]))
    return pres, new_hist


def make_fused_loop(s: RenderStatic, spec, frames: int,
                    steps_per_frame: int = 1, reset_every: int = 0):
    """The production loop: ``frames`` iterations of (CA steps + one
    composed frame).

    Returns ``run(state, params, history) -> (state, history, last_frame)``.
    ``reset_every > 0`` restores the input state after every that many
    frames (the benchmark's pinned scene: every frame still steps and
    renders).  Static camera.  The input ``state`` is not modified.  With
    ``s.gi_temporal`` the sample index is the loop counter, from 0 on each
    call.  Binary and multi-state automata: a multi-state ``state`` is the
    age bit-planes ``[B, W, Z, Y]``, stepped by the multi-state step, and
    every frame renders its visibility plane with the ages handed to K1 or
    the sliced path (the reference's ``one_step`` and ``visibility``).

    Three branches, as in the reference: up to 256³, hard shadows without
    GI compose in K1 and soft shadows, one-bounce and temporal GI run
    :func:`_ext_frame` with an f32 history; multi-bounce GI and the sliced
    path run :func:`render_frame_fast` per iteration, whose history is f16
    between frames."""
    h, w, n = s.height, s.width, s.grid_size
    multistate = spec.total_states > 2
    total_states = spec.total_states
    use_compose = (not _sliced(s) and s.soft_shadow_samples <= 1
                   and not s.indirect_lighting)
    use_ext = not _sliced(s) and not use_compose and (
        not s.indirect_lighting or s.gi_temporal or s.indirect_bounces == 1
    )

    def steps(st):
        for _ in range(steps_per_frame):
            st = step_packed(st, spec)
        return st

    def reset(i, st, state):
        return state if reset_every > 0 and (i + 1) % reset_every == 0 else st

    def run(state, params: RenderParams, history: FastHistory):
        cam = _cam_vec(params, w, h)
        frame = torch.zeros((h, w, 3), dtype=torch.float32, device=state.device)
        st = state
        if not use_compose and not use_ext:
            hist = history
            for i in range(frames):
                st = steps(st)
                frame, _, hist = render_frame_fast(
                    s, visibility_plane(st, spec), params, hist, True,
                    i if s.gi_temporal else None,
                    ages=st if multistate else None, total_states=total_states,
                )
                st = reset(i, st, state)
            return st, hist, frame
        hist = (history.color.to(torch.float32), history.hit_idx)
        for i in range(frames):
            st = steps(st)
            vis = visibility_plane(st, spec)
            ages = st if multistate else None
            if use_compose:
                frame, _, idx, color = raytrace_tiles(
                    vis, coarse_occupancy(vis), cam, hist,
                    grid_size=n, width=w, height=h, shadow=True, ages=ages,
                    total_states=total_states,
                )
                hist = (color, idx)
            else:
                frame, hist = _ext_frame(
                    s, vis, cam, hist, ages, total_states,
                    i if s.gi_temporal else None,
                )
            st = reset(i, st, state)
        new_history = FastHistory(color=hist[0].to(torch.float16), hit_idx=hist[1])
        return st, new_history, frame

    return run
