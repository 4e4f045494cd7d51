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
  through K2 and K3, the temporally amortized mode, all as
  ``render_slab.lighting_passes``: the queries kernel, K3 and the
  level-mode queries launches level by level, K2 and the shade kernel).  Above 256³, or with
  ``RenderStatic.force_sliced``: ``render_slab.raytrace_sliced`` (K4's
  primary hits, then the same passes, the shade kernel computing the direct
  light too).  Then emissive light (in the shade kernel where it runs).
* :func:`render_frame_fast` -- one frame: trace_shaded, then its
  composition: the temporal EMA (validated by the stored hit-cell id; after
  a camera move the history is reprojected first), the light cube, the f16
  history, the depth overlay and gamma -- on the card
  :func:`compose_frame_cuda`, one launch of ``csrc/compose.cu``, on the
  CPU its plain twin :func:`compose_frame` (with :func:`reproject_history`).
* :func:`make_fused_loop` -- the production loop (CA steps + one composed
  frame per iteration, static camera) with the reset period as a runtime
  argument (``run(..., reset_period)``, ``reset_every`` by default).  Up to
  256³: K1 in compose mode for hard shadows without GI, the extended frame
  in image layout for soft shadows, one-bounce and temporal GI (K1, queries,
  K2, K3, and the shade kernel in compose mode; history f32 inside, f16 at
  the exit), and render_frame_fast per iteration for
  multi-bounce GI.  The sliced path always takes render_frame_fast per
  iteration, as in the reference, so its history is f16 between frames.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..ops.ca_step import step_packed, visibility_plane
from ..ops.occupancy import occupancy_rebuild
from ..utils.profiling import span
from .camera import COT_HALF_FOV, pixel_uvs
from .intersect import device_vec
from .render_fast import (
    MAX_GRID, P_EMIS, P_EMISS, P_LEN, descent_options, raytrace_tiles,
)
from .render_slab import (
    Lighting, Prepped, ema, finish_frame, lighting_passes, raytrace_sliced)
from .renderer import RenderParams, RenderStatic, _get_reprojected_uv

__all__ = [
    "FastHistory",
    "init_fast_history",
    "trace_shaded",
    "reproject_history",
    "reproject_history_cuda",
    "compose_frame",
    "compose_frame_cuda",
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


def _extended_lighting(s: RenderStatic, prepped, cam, rgb, depth, idx, sample_idx,
                       history=None):
    """Soft shadows and GI on top of K1's frame (renderer_fast.py:121-178),
    with the emissive light: the rgb [H, W, 3], or with ``history`` the
    fused loop's (presentation, new history color).  Every configuration is
    :func:`render_slab.lighting_passes` (the queries kernel, K3 level by
    level with the level-mode queries launches between, K2 on every query of
    the frame, the shade kernel); the temporal mode evaluates one bounce."""
    soft = s.soft_shadow_samples > 1
    gi = s.indirect_lighting
    temporal = s.gi_temporal and sample_idx is not None
    # K1's rgb is unshadowed (but age-faded) direct light when soft; the
    # quotient multiplies it.
    light = Lighting(
        soft_k=s.soft_shadow_samples if soft else None,
        jitter_k=sample_idx % s.soft_shadow_samples if soft and temporal else None,
        gi=gi, gi_slot=sample_idx % 4 if gi and temporal else None,
        bounces=max(1, int(s.indirect_bounces)) if gi and not temporal else 1,
    )
    return lighting_passes(cam, idx, depth, prepped, light, rgb=rgb, history=history,
                           grid_size=s.grid_size, width=s.width, height=s.height)


def _shaded(s: RenderStatic, packed, cam, sample_idx, ages=None, total_states=2,
            history=None):
    """trace_shaded's (rgb, depth, idx); with ``history`` (K1's extended
    frames in the fused loop) (presentation, depth, idx, new history
    color), composed by the shade kernel."""
    if _sliced(s):
        return raytrace_sliced(
            packed, cam, ages, grid_size=s.grid_size, width=s.width,
            height=s.height, total_states=total_states,
            soft_shadow_samples=s.soft_shadow_samples,
            indirect=s.indirect_lighting, indirect_bounces=s.indirect_bounces,
            sample_idx=sample_idx if s.gi_temporal else None,
        )
    # The extended lighting's K2 clips to the mip's box, and K1's mip1
    # descent reads the plane mip: the one launch of the occupancy
    # rebuild writes what the frame reads.
    extended = s.soft_shadow_samples > 1 or s.indirect_lighting
    mip1, slicegate = descent_options()
    with span("ca3d.occupancy"):
        occ = occupancy_rebuild(packed, box=extended, plane=mip1)
    with span("ca3d.k1"):
        rgb, depth, idx = raytrace_tiles(
            packed, occ.coarse, cam,
            grid_size=s.grid_size, width=s.width, height=s.height,
            shadow=s.soft_shadow_samples <= 1, ages=ages, total_states=total_states,
            mip1=mip1, slicegate=slicegate, plane=occ.plane,
        )
    if extended:
        prepped = Prepped(packed, occ.coarse, occ.box)
        lit = _extended_lighting(s, prepped, cam, rgb, depth, idx, sample_idx, history)
        if history is not None:
            return lit[0], depth, idx, lit[1]
        return lit, depth, idx
    emis = device_vec(cam[P_EMIS : P_EMIS + 3] * cam[P_EMISS], rgb.device)
    rgb = torch.where((idx >= 0)[..., None], rgb + emis, rgb)
    return rgb, depth, idx


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
    return _shaded(s, packed, cam, sample_idx, ages, total_states)


def _window_rays(w: int, h: int, fh: int, row0: int, view: np.ndarray, device):
    """(ux [h, w], (dx, dy, dz) each [h, w]): the window's u of each pixel
    (``pixel_uvs``) and its world ray, ``get_ray`` rotated by the view's
    3×3, one component at a time: ``(rx·v0 + ry·v1) + rz·v2`` after a
    division by the norm (the composition kernel's order; JAX writes the
    rotation as a matrix product, whose summation order is its own)."""
    uv = pixel_uvs(w, h, device=device, row0=row0, full_height=fh)
    r = float(np.float32(w) / np.float32(fh))
    rx = (uv[..., 0] - 0.5) * r
    ry = uv[..., 1] - 0.5
    rz = torch.full_like(rx, -float(np.float32(0.5) * COT_HALF_FOV))
    norm = torch.sqrt(rx * rx + ry * ry + rz * rz)
    rx, ry, rz = rx / norm, ry / norm, rz / norm
    d = tuple(rx * float(view[i, 0]) + ry * float(view[i, 1]) + rz * float(view[i, 2])
              for i in range(3))
    return uv[..., 0], d


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
    view = np.asarray(params.view_mat, np.float32)
    _, d = _window_rays(w, h, fh, row0, view, rgb.device)
    hit = torch.stack([float(view[i, 3]) + d[i] * depth for i in range(3)], dim=-1)
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
    return ema(rgb, prev, valid, params.temporal_alpha), torch.where(in_bounds, flat, -1), valid


def compose_frame(history: FastHistory, rgb: torch.Tensor, depth: torch.Tensor,
                  idx: torch.Tensor, params: RenderParams, w: int, h: int,
                  full_height: int | None = None, row0: int = 0,
                  camera_static: bool = True):
    """Plain twin of the composition kernel: ``render_frame_fast`` after
    ``trace_shaded`` (renderer_fast.py:250-315 of the JAX package) --
    the temporal EMA (static: where the history's id is this pixel's hit;
    moved: :func:`reproject_history`), the light-source cube on black pixels
    (wgsl:866-874), the new history colour as f16, the depth overlay
    (wgsl:880-883) and gamma.  ``row0`` / ``full_height``: as
    :func:`reproject_history`'s.  Returns (presentation [h, w, 3] f32, new
    history colour [h, w, 3] f16)."""
    with span("ca3d.compose"):
        fh = h if full_height is None else full_height
        view = np.asarray(params.view_mat, np.float32)
        ux, d = _window_rays(w, h, fh, row0, view, rgb.device)
        if camera_static:
            prev = history.color.to(torch.float32)
            out = ema(rgb, prev, (idx == history.hit_idx) & (idx >= 0), params.temporal_alpha)
        else:
            out, _, _ = reproject_history(history, rgb, depth, idx, params, w, h, fh, row0)
        pres, color = finish_frame(out, depth, view[:3, 3], torch.stack(d, dim=-1),
                                   params.light_pos, ux, params.show_depth_overlay, params.gamma)
        return pres, color.to(torch.float16)


def _compose_launch(history, rgb, depth, idx, params, w, h, full_height, row0, moved, *,
                    present=True, debug=False, with_source=False):
    """One launch of ``csrc/compose.cu`` on the frame's operands, checked:
    the presentation and the f16 history (``present``) and, moved only, the
    debug outputs (the blended rgb, with ``with_source`` the source pixel and
    the valid mask)."""
    fh = h if full_height is None else full_height
    for t, name, dtype, shape in (
        (history.color, "history.color", torch.float16, (h, w, 3)),
        (history.hit_idx, "history.hit_idx", torch.int32, (h, w)),
        (rgb, "rgb", torch.float32, (h, w, 3)),
        (depth, "depth", torch.float32, (h, w)),
        (idx, "idx", torch.int32, (h, w)),
    ):
        kernels.require(t, name, dtype, shape, align=t.element_size())
    if not (0 <= row0 and row0 + h <= fh):
        raise ValueError(f"rows {row0}..{row0 + h} do not fit a window of {fh} rows")
    f32 = np.float32
    consts = np.concatenate([
        np.asarray(params.view_mat, f32)[:3, :].reshape(-1),
        np.asarray(params.prev_proj_view, f32).reshape(-1),
        [f32(w) / f32(fh), -(f32(0.5) * COT_HALF_FOV), params.temporal_alpha],
        np.asarray(params.light_pos, f32).reshape(3),
        [f32(1.0) / f32(params.gamma), params.show_depth_overlay],
    ]).astype(f32)
    dev = rgb.device
    new = lambda dtype, *shape: torch.empty(shape, dtype=dtype, device=dev)  # noqa: E731
    pres = new(torch.float32, h, w, 3) if present else None
    color = new(torch.float16, h, w, 3) if present else None
    blend = new(torch.float32, h, w, 3) if debug else None
    src = new(torch.int64, h, w) if with_source else None
    valid = new(torch.bool, h, w) if with_source else None
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    err = kernels.library().ca3d_compose(
        dev.index or 0, history.color.data_ptr(), history.hit_idx.data_ptr(),
        rgb.data_ptr(), depth.data_ptr(), idx.data_ptr(), w, h, fh, int(row0), int(moved),
        consts.ctypes.data, ptr(pres), ptr(color), ptr(blend), ptr(src), ptr(valid),
        kernels.stream_of(rgb))
    kernels.check(err, "compose")
    return pres, color, blend, src, valid


def compose_frame_cuda(history: FastHistory, rgb: torch.Tensor, depth: torch.Tensor,
                       idx: torch.Tensor, params: RenderParams, w: int, h: int,
                       full_height: int | None = None, row0: int = 0,
                       camera_static: bool = True):
    """:func:`compose_frame` on the card in one launch (``csrc/compose.cu``,
    a thread a pixel, the twin's operations in its order).  Every operand
    must be a contiguous CUDA tensor of the frame's shape: ``rgb`` f32 [h,
    w, 3], ``depth`` f32 [h, w], ``idx`` and ``history.hit_idx`` int32 [h,
    w], ``history.color`` f16 [h, w, 3].  Returns (presentation, new history
    colour f16)."""
    with span("ca3d.compose"):
        pres, color, *_ = _compose_launch(history, rgb, depth, idx, params, w, h, full_height,
                                          row0, not camera_static)
    compose_frame_cuda.launches += 1
    return pres, color


compose_frame_cuda.launches = 0


def reproject_history_cuda(history: FastHistory, rgb: torch.Tensor,
                           depth: torch.Tensor, idx: torch.Tensor,
                           params: RenderParams, w: int, h: int,
                           full_height: int | None = None, row0: int = 0, *,
                           with_source: bool = False):
    """:func:`reproject_history` on the card: the composition kernel's moved
    mode writing only its debug outputs (no frame path calls it).  Operands
    as :func:`compose_frame_cuda`'s.  Returns the blended rgb; with
    ``with_source`` also the source pixel (int64, -1 out of bounds) and the
    valid mask, as the twin does."""
    *_, out, src, valid = _compose_launch(history, rgb, depth, idx, params, w, h, full_height,
                                          row0, True, present=False, debug=True,
                                          with_source=with_source)
    reproject_history_cuda.launches += 1
    return (out, src, valid) if with_source else out


reproject_history_cuda.launches = 0


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
    window's).  After :func:`trace_shaded` the frame is composed by
    :func:`compose_frame_cuda` on the card (one launch), by its twin
    :func:`compose_frame` on the CPU."""
    h, w = s.height, s.width
    fh = h if full_height is None else full_height
    cam = _cam_vec(params, w, fh, row0)
    rgb, depth, idx = trace_shaded(s, packed, cam, sample_idx, ages=ages,
                                   total_states=total_states)
    compose = compose_frame if rgb.device.type == "cpu" else compose_frame_cuda
    presentation, color = compose(history, rgb, depth, idx, params, w, h, fh, row0,
                                  camera_static)
    return presentation, depth, FastHistory(color=color, hit_idx=idx)


def _ext_frame(s: RenderStatic, vis, cam, hist, ages, total_states, sample_idx):
    """One extended-lighting frame (soft shadows, one-bounce or temporal
    GI) of the fused loop: K1, then the lighting passes whose shade kernel
    also composes the frame -- the emissive light, the id-checked EMA
    against the f32 history, the light cube, the depth overlay and gamma
    (_ext_frame_blocked, renderer_fast.py:318-407, in image layout).
    Returns (presentation, new history (color f32, ids))."""
    pres, _, idx, color = _shaded(s, vis, cam, sample_idx, ages, total_states, history=hist)
    return pres, (color, idx)


def make_fused_loop(s: RenderStatic, spec, frames: int,
                    steps_per_frame: int = 1, reset_every: int = 0):
    """The production loop: ``frames`` iterations of (CA steps + one
    composed frame).

    Returns ``run(state, params, history, reset_period=None) -> (state,
    history, last_frame)``.  A reset period ``rp > 0`` restores the input
    state after every ``rp`` frames (the benchmark's pinned scene: every
    frame still steps and renders); ``rp`` is ``reset_period`` when given,
    else ``reset_every``, so one loop runs the pinned and the dense lines
    (``bench_torch.py``), as the reference's runtime operand.  Static camera.  The input ``state`` is not modified.  With
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

    def run(state, params: RenderParams, history: FastHistory, reset_period=None):
        rp = reset_every if reset_period is None else int(reset_period)

        def reset(i, st):
            return state if rp > 0 and (i + 1) % rp == 0 else st

        cam = _cam_vec(params, w, h)
        frame = torch.zeros((h, w, 3), dtype=torch.float32, device=state.device)
        st = state
        if not use_compose and not use_ext:
            hist = history
            for i in range(frames):
                with span("ca3d.frame"):
                    st = steps(st)
                    frame, _, hist = render_frame_fast(
                        s, visibility_plane(st, spec), params, hist, True,
                        i if s.gi_temporal else None,
                        ages=st if multistate else None, total_states=total_states,
                    )
                    st = reset(i, st)
            return st, hist, frame
        hist = (history.color.to(torch.float32), history.hit_idx)
        for i in range(frames):
            with span("ca3d.frame"):
                st = steps(st)
                vis = visibility_plane(st, spec)
                ages = st if multistate else None
                if use_compose:
                    mip1, slicegate = descent_options()
                    occ = occupancy_rebuild(vis, plane=mip1)
                    frame, _, idx, color = raytrace_tiles(
                        vis, occ.coarse, cam, hist,
                        grid_size=n, width=w, height=h, shadow=True, ages=ages,
                        total_states=total_states, mip1=mip1, slicegate=slicegate,
                        plane=occ.plane,
                    )
                    hist = (color, idx)
                else:
                    frame, hist = _ext_frame(
                        s, vis, cam, hist, ages, total_states,
                        i if s.gi_temporal else None,
                    )
                st = reset(i, st)
        new_history = FastHistory(color=hist[0].to(torch.float16), hit_idx=hist[1])
        return st, new_history, frame

    return run
