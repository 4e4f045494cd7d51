"""The exact reference pipeline (``render_frame``), its render constants,
per-frame parameters and history.

Port of ``cellularautomatons3d_tpu.render.renderer``: one frame of the
active fragment shader (pathtraced_fragment_clustered.wgsl:800-890, and the
non-clustered pathtraced_fragment.wgsl as ``variant="simple"``): per-pixel
primary ray → volume slab test → stochastic first-hit march → temporal depth
refinement → direct lighting with a shadow march (Cook-Torrance, or the
simple variant's reflect + diffuse) → temporal colour reprojection → the
presentation image and the f16 colour / depth history.  It is a parity
oracle of the shader, quirks included, not a fast path: every step is a few
torch ops over the flat pixel axis (the reference runs it in XLA), so its
only hand kernels are the CA step's.

``RenderStatic`` and ``RenderParams`` are shared with the fast pipeline.
``RenderParams`` holds host values (numpy float32): the fast path packs them
into the kernel's parameter vector (``renderer_fast._cam_vec``), this one
reads them as float32 scalars.  Float rules as in :mod:`.intersect`; the
3×3 and 4×4 matrix products are written out per component, each row summed
left to right (:func:`_get_reprojected_uv`), the same on the card and the
CPU.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import brdf
from .camera import COT_HALF_FOV, pixel_uvs
from .intersect import (
    FULL_CUBE_SIZE,
    HALF_CUBE_SIZE,
    cell_from_sample_point,
    cube_face_normal,
    device_vec,
    get_cell_state,
    n1rand,
    normalize,
    ray_cube_intersect,
    scalar_tensor,
    sd_box,
    to_int32,
    vec_norm,
)
from .raymarch import ray_march_depth, ray_march_shadow

__all__ = ["RenderStatic", "RenderParams", "RenderHistory", "init_history", "render_frame"]


@dataclasses.dataclass(frozen=True)
class RenderStatic:
    """Render constants fixed between rebuilds: the reference pipeline's
    march step counts, the lighting model (hard or soft shadows, one- or
    multi-bounce GI, the fast path's temporally amortized mode) and the
    choice of the sliced path.  The JAX package's ``slab_planes`` and
    ``x_chunk_cells`` are TPU brick layout and do not come across."""

    width: int
    height: int
    grid_size: int
    # The reference pipeline's march steps (rayMarchDepth / rayMarchShadow
    # sample counts).
    depth_samples: int = 35
    shadow_samples: int = 30
    indirect_lighting: bool = False
    soft_shadow_samples: int = 1
    # Recursion depth of the indirect term: 1 = the reference's single
    # bounce (wgsl:307-377); b > 1 feeds each neighbour's own indirect
    # radiance into the next level (4^b neighbour evaluations).
    indirect_bounces: int = 1
    # One rotating soft-shadow sample and GI slot per frame, converged by
    # the temporal EMA; needs a frame counter (``sample_idx``) from the
    # caller and ignores ``indirect_bounces``.
    gi_temporal: bool = False
    # Render a grid of at most 256³ through the sliced path (K4 + K2 in a
    # frame, render_slab.raytrace_sliced) instead of K1, as grids above
    # 256³ always are.  Set only by the CPU parity tests against JAX at
    # small grids; EngineConfig does not expose it.
    force_sliced: bool = False


class RenderParams(NamedTuple):
    """Live per-frame operands — the uniform-arena contents
    (CommonBufferLayout, pathtraced_fragment_clustered.wgsl:17-34)."""

    view_mat: np.ndarray          # [4,4] camera-to-world
    prev_view_mat: np.ndarray     # [4,4]
    prev_proj_view: np.ndarray    # [4,4] -- "prevProjViewMatInv" (misnomer)
    elapsed_time: np.float32      # performance.now()*1e-4
    cell_size: np.float32         # visible-cube fraction
    temporal_alpha: np.float32
    gamma: np.float32             # output pow(c, 1/gamma)
    roughness: np.float32
    base_reflectivity: np.ndarray  # [3]
    material_color: np.ndarray    # [3] (all-zero ⇒ position rainbow)
    light_pos: np.ndarray         # [3]
    light_magnitude: np.float32
    show_depth_overlay: np.float32  # 1.0 = on
    light_radius: np.float32 = np.float32(0.0)
    emissive_color: np.ndarray = np.zeros(3, np.float32)
    emissive_strength: np.float32 = np.float32(0.0)


# Neighbour-offset layers for indirect lighting, by face (wgsl:110-169):
# order -x, +x, -y, +y, -z, +z; 4 edge-diagonal slots per face.
_INDIRECT_LAYERS = np.array(
    [
        [[-1, 1, 0], [-1, -1, 0], [-1, 0, 1], [-1, 0, -1]],
        [[1, 1, 0], [1, -1, 0], [1, 0, 1], [1, 0, -1]],
        [[-1, -1, 0], [1, -1, 0], [0, -1, 1], [0, -1, -1]],
        [[-1, 1, 0], [1, 1, 0], [0, 1, 1], [0, 1, -1]],
        [[0, 1, -1], [0, -1, -1], [-1, 0, -1], [1, 0, -1]],
        [[0, 1, 1], [0, -1, 1], [-1, 0, 1], [1, 0, 1]],
    ],
    dtype=np.int32,
)


def _get_reprojected_uv(prev_proj_view, p: torch.Tensor) -> torch.Tensor:
    """getReprojectedUV (wgsl:473-487, renderer.py:135-143 of the JAX
    package): project ``p`` [..., 3] through the previous view-projection
    [4, 4], divide by w, flip y into texture space.  Returns uv [..., 2].

    The 4×4 product is written out per component, each row summed left to
    right, and the perspective divide divides by a tensor: CUDA torch turns
    a scalar divisor into a reciprocal multiply, and a matmul may round
    differently on the card and the CPU.  Within 1 ulp of the reference,
    not bit for bit (XLA:CPU's dot orders its sums its own way)."""
    m = np.asarray(prev_proj_view, np.float32)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]

    def row(i):
        return x * float(m[i, 0]) + y * float(m[i, 1]) + z * float(m[i, 2]) + float(m[i, 3])

    w = row(3)
    cx = row(0) / w
    cy = row(1) / w
    return torch.stack([cx * 0.5 + 0.5, -cy * 0.5 + 0.5], dim=-1)


def _face_index(normal: torch.Tensor) -> torch.Tensor:
    """Face id (int64) from an axis-aligned normal: order -x,+x,-y,+y,-z,+z
    (the wgsl layer selection, wgsl:110-169)."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    return torch.where(
        nx.abs() > 0.5,
        torch.where(nx < 0, 0, 1),
        torch.where(ny.abs() > 0.5, torch.where(ny < 0, 2, 3), torch.where(nz < 0, 4, 5)),
    )


# ------------------------------------------------ the reference pipeline ---


class RenderHistory(NamedTuple):
    color: torch.Tensor  # [H, W, 4] float16 (rgba16float parity)
    depth: torch.Tensor  # [H, W, 2] float16 (rg16float parity)


def init_history(width: int, height: int, device) -> RenderHistory:
    """Zero history (WebGPU zero-initializes fresh textures)."""
    return RenderHistory(
        color=torch.zeros((height, width, 4), dtype=torch.float16, device=device),
        depth=torch.zeros((height, width, 2), dtype=torch.float16, device=device),
    )


def _f32(value) -> float:
    return float(np.float32(value))


def _texture_load(img, uv, width: int, height: int):
    """textureLoad(img, vec2i(uv * windowSize)): truncate, then clamp to the
    image (out-of-bounds loads are indeterminate in WebGPU; the reference
    clamps).  The truncation saturates as XLA's does (NaN to 0, ±inf to the
    ends), so a point on the previous camera's plane reads the same texel on
    the card and the CPU."""
    def texel(u, size):
        return to_int32(u * float(size)).clamp(0, size - 1)

    flat = texel(uv[..., 1], height) * width + texel(uv[..., 0], width)
    return img.reshape(-1, img.shape[-1])[flat.long()].to(torch.float32)


def _view_rays(view_mat, uv, w: int, h: int):
    """World-space rays [..., 3] of the pixels at ``uv``: get_ray (wgsl:188-197,
    normalised with the port's norm) rotated by ``view_mat[:3, :3]``, each
    row of the product summed left to right.  ``camera.get_ray`` is not
    reused: it divides by ``torch.linalg.vector_norm``, whose summation order
    the fast pipeline's frames (held to JAX's fast frame by their tests)
    depend on, while this pipeline sums ``(x² + y²) + z²`` as ``vec_norm``."""
    x = (uv[..., 0] - 0.5) * float(np.float32(w) / np.float32(h))
    y = uv[..., 1] - 0.5
    z = torch.full_like(x, -float(np.float32(0.5) * COT_HALF_FOV))
    ray = torch.stack([x, y, z], dim=-1)
    ray = normalize(ray)
    m = np.asarray(view_mat, np.float32)
    x, y, z = ray[..., 0], ray[..., 1], ray[..., 2]
    return torch.stack(
        [x * float(m[i, 0]) + y * float(m[i, 1]) + z * float(m[i, 2]) for i in range(3)],
        dim=-1,
    )


def _estimate_likely_depth(packed_flat, sample_point, prev_depth_reproj, camera_pos,
                           prev_camera_pos, view_ray, *, grid_size: int, cell_size_mul):
    """estimateLikelyDepth (wgsl:743-798): if the reprojected previous depth
    lands in a live cell that the current march overstepped, snap to that
    cell's exact intersection."""
    current_depth = vec_norm(sample_point - camera_pos)[..., 0]
    view_ray2 = normalize(sample_point - prev_camera_pos)
    reproj_point = prev_camera_pos + view_ray2 * prev_depth_reproj[..., None]
    r_coords, r_origin, r_idx = cell_from_sample_point(reproj_point, grid_size)
    _, _, c_idx = cell_from_sample_point(sample_point, grid_size)
    r_state = get_cell_state(packed_flat, r_coords, grid_size)
    vis_half = _f32(np.float32(FULL_CUBE_SIZE / grid_size) * np.float32(cell_size_mul)
                    * np.float32(0.5))
    t_near, t_far = ray_cube_intersect(camera_pos, view_ray, r_origin, vis_half)
    cond = ((r_state == 1) & (c_idx != r_idx) & (prev_depth_reproj < current_depth)
            & (t_near <= t_far) & (t_near >= 0.0))
    return torch.where(cond, t_near, current_depth)


def _cell_age(age_planes, coords, grid_size: int):
    """Per-pixel age from packed age bit-planes [B, W, Z, Y]."""
    age = None
    for i in range(age_planes.shape[0]):
        term = get_cell_state(age_planes[i].reshape(-1), coords, grid_size) << i
        age = term if age is None else age | term
    return age


def _lighting_and_occlusion(packed_flat, sample_point, uv, p: RenderParams,
                            s: RenderStatic, active, ages=None, total_states: int = 2,
                            variant: str = "clustered"):
    """calculateLightingAndOcclusionAt (wgsl:379-427): direct light times the
    shadow march's occlusion at lit surface points, soft shadows over
    jittered light positions, the multi-state age fade ``(S - age) / (S -
    1)``, the indirect term (clustered only) and emissive light; 0 where
    the point is not on a live cell's visible cube."""
    dev = sample_point.device
    cell_size = np.float32(FULL_CUBE_SIZE / s.grid_size)
    coords, origin, _ = cell_from_sample_point(sample_point, s.grid_size)
    state = get_cell_state(packed_flat, coords, s.grid_size)
    vis_half = _f32(cell_size * np.float32(p.cell_size) * np.float32(0.5))
    dist = sd_box(sample_point - origin, vis_half)
    lit = active & (state == 1) & (dist <= 0.001)

    rnd = n1rand(uv, p.elapsed_time)
    light_pos = device_vec(np.asarray(p.light_pos, np.float32).reshape(3), dev)

    def shadow_toward(target, rnd_offset):
        """One shadow march toward a (possibly jittered) light (wgsl:403-421)."""
        light_dir = normalize(target - sample_point)
        _, t_far = ray_cube_intersect(sample_point, light_dir, 0.0, HALF_CUBE_SIZE)
        volume_exit = sample_point + light_dir * t_far[..., None]
        return ray_march_shadow(
            packed_flat, sample_point, volume_exit, coords, rnd_offset,
            grid_size=s.grid_size, cell_size_mul=p.cell_size,
            shadow_samples=s.shadow_samples, active=lit,
            min_cell_step=variant == "clustered",
        )

    if s.soft_shadow_samples <= 1:
        occlusion = shadow_toward(light_pos, rnd)
    else:
        # Soft shadows: occlusion averaged over light positions jittered on
        # a cube of side 2 · light_radius.
        occlusion = torch.zeros_like(rnd)
        rad2 = _f32(np.float32(2.0) * np.float32(p.light_radius))
        for k in range(s.soft_shadow_samples):
            jitter = torch.stack([
                n1rand(uv + _f32(c), p.elapsed_time) - 0.5
                for c in (0.17 * k + 0.05, 0.29 * k + 0.11, 0.41 * k + 0.23)
            ], dim=-1) * rad2
            occlusion = occlusion + shadow_toward(light_pos + jitter, rnd)
        occlusion = occlusion / scalar_tensor(s.soft_shadow_samples, occlusion)

    camera_pos = device_vec(np.asarray(p.view_mat, np.float32)[:3, 3], dev)
    if variant == "clustered":
        color = brdf.calculate_lighting_at(
            sample_point, origin, coords, camera_pos, _f32(p.light_magnitude), light_pos,
            grid_size=s.grid_size, roughness=p.roughness,
            material_color=p.material_color, base_reflectivity=p.base_reflectivity,
        )
    else:
        color = brdf.calculate_lighting_at_simple(
            sample_point, origin, coords, camera_pos, light_pos, p.light_magnitude,
            grid_size=s.grid_size,
        )
    if ages is not None and total_states > 2:
        age = _cell_age(ages, coords, s.grid_size)
        fade = (total_states - age).to(torch.float32)
        fade = torch.clamp(fade / scalar_tensor(total_states - 1, fade), 0.0, 1.0)
        color = color * fade[..., None]
    out = occlusion[..., None] * color

    if s.indirect_lighting and variant == "clustered":
        out = out + _indirect_lighting(packed_flat, sample_point, origin, coords, rnd,
                                       camera_pos, light_pos, p, s, lit)

    out = out + _emissive(p, dev)
    return torch.where(lit[..., None], out, 0.0)


def _emissive(p: RenderParams, device) -> torch.Tensor:
    """Emissive radiance [3]: emissive_color · emissive_strength."""
    e = np.asarray(p.emissive_color, np.float32) * np.float32(p.emissive_strength)
    return device_vec(e.reshape(3), device)


def _indirect_lighting(packed_flat, sample_point, cell_origin, cell_coords, rnd,
                       camera_pos, light_pos, p: RenderParams, s: RenderStatic, lit):
    """Indirect light from the 4 face-adjacent neighbours
    (calculateIndirectLighting, wgsl:307-377, enabled where the reference
    leaves the call commented out at :424).  ``s.indirect_bounces`` > 1
    recurses: each neighbour's reflected radiance includes its own indirect
    term one level down (4^b neighbour evaluations)."""
    grid = s.grid_size
    cell_size = np.float32(FULL_CUBE_SIZE / grid)
    cs, cs_half = float(cell_size), float(cell_size * np.float32(0.5))
    vis_half = _f32(cell_size * np.float32(p.cell_size) * np.float32(0.5))
    # Made by fill kernels: a copy from the host would wait for the stream.
    layers = device_vec(_INDIRECT_LAYERS.reshape(-1), sample_point.device).to(
        torch.int32).view(6, 4, 3)
    magnitude = _f32(p.light_magnitude)
    emissive = _emissive(p, sample_point.device)
    shade = dict(grid_size=grid, roughness=p.roughness, material_color=p.material_color,
                 base_reflectivity=p.base_reflectivity)

    def indirect_from(point, origin, coords, viewer, active, depth_left):
        face = _face_index(cube_face_normal(point, origin))
        total = torch.zeros_like(point)
        for i in range(4):
            off = layers[:, i, :][face]
            n_coords = coords + off
            n_cl = torch.clamp(n_coords, min=0)
            n_state = get_cell_state(packed_flat, n_cl, grid)
            n_origin = n_coords.to(torch.float32) * cs + cs_half - HALF_CUBE_SIZE
            n_dir = off.to(torch.float32)  # unnormalized, as in the reference
            t_near, t_far = ray_cube_intersect(point, n_dir, n_origin, vis_half)
            ok = active & (n_state == 1) & (t_near <= t_far) & (t_far >= 0.0)
            n_point = point + n_dir * t_near[..., None]

            l_dir = normalize(light_pos - n_point)
            _, exit_far = ray_cube_intersect(n_point, l_dir, 0.0, HALF_CUBE_SIZE)
            n_exit = n_point + l_dir * exit_far[..., None]
            occ = ray_march_shadow(
                packed_flat, n_point, n_exit, n_cl, rnd, grid_size=grid,
                cell_size_mul=p.cell_size, shadow_samples=s.shadow_samples, active=ok,
            )
            reflected = occ[..., None] * brdf.calculate_lighting_at(
                n_point, n_origin, n_cl, point, magnitude, light_pos, **shade)
            reflected = reflected + emissive
            if depth_left > 1:
                reflected = reflected + indirect_from(n_point, n_origin, n_cl, point, ok,
                                                      depth_left - 1)
            bounce = brdf.calculate_lighting_at(point, origin, coords, viewer, reflected,
                                                n_point, **shade)
            total = total + torch.where(ok[..., None], bounce, 0.0)
        return total

    return indirect_from(sample_point, cell_origin, cell_coords, camera_pos, lit,
                         max(1, int(s.indirect_bounces)))


def _mix_reprojected_color(current, prev, sample_pos, uv_reproj, prev_depth_reproj,
                           prev_camera_pos, temporal_alpha, grid_size: int):
    """mixWithReprojectedColor (wgsl:429-471): blend with the history unless
    the reprojected uv leaves the screen or the reprojected depth names
    another cell."""
    d = normalize(sample_pos - prev_camera_pos)
    reproj_point = prev_camera_pos + d * prev_depth_reproj[..., None]
    _, _, r_idx = cell_from_sample_point(reproj_point, grid_size)
    _, _, c_idx = cell_from_sample_point(sample_pos, grid_size)
    u, v = uv_reproj[..., 0], uv_reproj[..., 1]
    reject = (u < 0.0) | (u > 1.0) | (v < 0.0) | (v > 1.0) | (c_idx != r_idx)
    mixed = torch.clamp(prev + (current - prev) * _f32(temporal_alpha), 0.0, 1.0)
    return torch.where(reject[..., None], current, mixed)


def render_frame(s: RenderStatic, packed: torch.Tensor, params: RenderParams,
                 history: RenderHistory, ages: torch.Tensor | None = None,
                 total_states: int = 2, variant: str = "clustered"):
    """One frame of the exact reference pipeline (wgsl fragment_main
    :800-890) on ``packed``'s device.

    ``packed``: int32 words ``[W, Z, Y]`` (for a multi-state rule its
    visibility plane, with the age bit-planes ``[B, W, Z, Y]`` as ``ages``);
    ``variant``: "clustered" (Cook-Torrance) or "simple" (the non-clustered
    shader: reflect + diffuse lighting, no GI, the shadow step without the
    cell-size floor, temporal alpha 0.1 and gamma 2.2).  Returns
    (presentation [H, W, 3] f32, new :class:`RenderHistory`): the
    presentation is gamma-corrected, the history holds the linear light and
    the refined depth, each at f16 texture precision."""
    if variant not in ("clustered", "simple"):
        raise ValueError(f"unknown render variant {variant!r}")
    h, w = s.height, s.width
    dev = packed.device
    packed_flat = packed.reshape(-1)
    uv = pixel_uvs(w, h, device=dev).reshape(-1, 2)
    camera_pos = device_vec(np.asarray(params.view_mat, np.float32)[:3, 3], dev)
    prev_camera_pos = device_vec(np.asarray(params.prev_view_mat, np.float32)[:3, 3], dev)

    view_ray = _view_rays(params.view_mat, uv, w, h)
    t_near, t_far = ray_cube_intersect(camera_pos, view_ray, 0.0, HALF_CUBE_SIZE)
    cube_hit = (t_near <= t_far) & (t_far >= 0.0)
    outside_box = sd_box(camera_pos, HALF_CUBE_SIZE) >= 0.0
    enter = torch.where((cube_hit & outside_box)[..., None],
                        camera_pos + view_ray * t_near[..., None], camera_pos)
    exit_ = camera_pos + view_ray * t_far[..., None]

    final_point, _ = ray_march_depth(
        packed_flat, enter, exit_, uv, params.elapsed_time, grid_size=s.grid_size,
        cell_size_mul=params.cell_size, depth_samples=s.depth_samples,
    )

    # The history at the reprojected position (:835-838).
    uv_reproj = _get_reprojected_uv(params.prev_proj_view, final_point)
    prev_depth_reproj = _texture_load(history.depth, uv_reproj, w, h)[..., 0]
    likely_depth = _estimate_likely_depth(
        packed_flat, final_point, prev_depth_reproj, camera_pos, prev_camera_pos,
        normalize(view_ray), grid_size=s.grid_size, cell_size_mul=params.cell_size,
    )
    accurate_point = camera_pos + view_ray * likely_depth[..., None]
    uv_reproj = _get_reprojected_uv(params.prev_proj_view, accurate_point)

    # The non-clustered variant pins temporalAlpha to 0.1 and gamma to 2.2
    # (pathtraced_fragment.wgsl:372,704).
    if variant == "simple":
        params = params._replace(temporal_alpha=np.float32(0.1), gamma=np.float32(2.2))
    lit_color = _lighting_and_occlusion(
        packed_flat, accurate_point, uv, params, s, cube_hit, ages=ages,
        total_states=total_states, variant=variant,
    )
    lit_rgba = torch.cat([lit_color, torch.ones_like(lit_color[..., :1])], dim=-1)
    prev_color = _texture_load(history.color, uv_reproj, w, h)
    mixed = _mix_reprojected_color(lit_rgba, prev_color, accurate_point, uv_reproj,
                                   prev_depth_reproj, prev_camera_pos,
                                   params.temporal_alpha, s.grid_size)
    out = torch.where(cube_hit[..., None], mixed, 0.0)
    mixed_depth = torch.where(cube_hit, likely_depth, 0.0)

    # Light-source cube (:866-874), drawn where the background is black.
    light_pos = device_vec(np.asarray(params.light_pos, np.float32).reshape(3), dev)
    lt_near, lt_far = ray_cube_intersect(camera_pos, view_ray, light_pos, _f32(0.005))
    light_hit = (lt_near <= lt_far) & (lt_far >= 0.0)
    black = (out[..., :3] == 0.0).all(dim=-1)
    out = torch.where((light_hit & black)[..., None], 1.0, out)

    # Depth overlay debug view (:880-883).
    if float(params.show_depth_overlay) == 1.0:
        zero = torch.zeros_like(mixed_depth)
        overlay_color = torch.stack([mixed_depth, zero, zero, torch.ones_like(zero)], dim=-1)
        out = torch.where((uv[..., 0] < 0.5)[..., None], overlay_color, out)

    # The render targets (:885-888).
    rgb = out[..., :3]
    light_out = torch.cat([rgb, torch.ones_like(out[..., :1])], dim=-1)
    depth_out = torch.stack([mixed_depth, torch.ones_like(mixed_depth)], dim=-1)
    presentation = torch.pow(rgb, _f32(np.float32(1.0) / np.float32(params.gamma)))
    new_history = RenderHistory(
        color=light_out.reshape(h, w, 4).to(torch.float16),
        depth=depth_out.reshape(h, w, 2).to(torch.float16),
    )
    return presentation.reshape(h, w, 3), new_history
