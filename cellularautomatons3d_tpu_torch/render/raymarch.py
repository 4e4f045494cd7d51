"""Ray-march loops of the exact reference pipeline: the depth march and the
shadow march, vectorized over pixels.

Port of ``cellularautomatons3d_tpu.render.raymarch`` (rayMarchDepth:
pathtraced_fragment_clustered.wgsl:682-741, rayMarchShadow: :635-680).  The
shader's per-pixel ``while`` loops become fixed-trip Python loops over the
step index, each step a handful of torch ops on every pixel, with a
per-pixel latch that keeps the first hit: ``depth_samples`` (35) and
``shadow_samples`` (30) steps, as in the reference's ``lax.fori_loop``.

Float rules as in :mod:`.intersect`: tensor divisors, saturating float→int
conversions, norms summed ``(x² + y²) + z²``.  Scalars come from the host as
float32 values.
"""

from __future__ import annotations

import numpy as np
import torch

from .intersect import (
    FULL_CUBE_SIZE,
    cell_coords_origin,
    get_cell_state,
    n1rand,
    ray_cube_intersect,
    scalar_tensor,
    vec_norm,
)

__all__ = ["ray_march_depth", "ray_march_shadow", "OCCLUSION_FACTOR"]

OCCLUSION_FACTOR = float(np.float32(0.0095))  # pathtraced_fragment_clustered.wgsl:72


def _segment(start, end):
    """(unit direction [..., 3], length [...]) of the segment start → end."""
    d = end - start
    length = vec_norm(d)
    return d / length, length[..., 0]


def _cell_probe(packed_flat, start, direction, depth, cell_t, vis_half, grid_size):
    """The sample at ``depth`` along the ray: its cell coords (clamped at 0),
    the cell's state and the slab test against its visible cube."""
    sample = start + direction * depth[..., None]
    coords, origin = cell_coords_origin(sample, grid_size, cell_t)
    state = get_cell_state(packed_flat, coords, grid_size)
    t_near, t_far = ray_cube_intersect(start, direction, origin, vis_half)
    return coords, state, t_near, t_far


def ray_march_depth(packed_flat, start, end, uv, elapsed_time, *, grid_size: int,
                    cell_size_mul, depth_samples: int):
    """First-hit march from ``start`` to ``end`` (wgsl:682-741).

    Returns (final sample point [..., 3], hit mask [...]).  On a hit the
    point is snapped to the exact visible-cube intersection (:717-729);
    with no hit it is ``end`` (:738)."""
    direction, march_depth = _segment(start, end)
    step_size = march_depth / scalar_tensor(depth_samples, march_depth)
    depth0 = step_size * n1rand(uv, elapsed_time) + 0.01

    cell_size = np.float32(FULL_CUBE_SIZE / grid_size)
    vis_half = float(cell_size * np.float32(cell_size_mul) * np.float32(0.5))
    cell_t = scalar_tensor(cell_size, start)
    found = torch.zeros_like(march_depth, dtype=torch.bool)
    hit_point = torch.zeros_like(start)
    for i in range(depth_samples):
        depth = depth0 + step_size * float(i)
        _, state, t_near, t_far = _cell_probe(packed_flat, start, direction, depth, cell_t,
                                              vis_half, grid_size)
        hit = ((depth < march_depth) & ~found & (state != 0) & (t_far >= 0.0)
               & (t_near <= t_far))
        snapped = start + direction * t_near[..., None]
        hit_point = torch.where(hit[..., None], snapped, hit_point)
        found = found | hit
    return torch.where(found[..., None], hit_point, end), found


def ray_march_shadow(packed_flat, start, end, start_cell_coords, rnd_offset, *,
                     grid_size: int, cell_size_mul, shadow_samples: int, active=None,
                     min_cell_step: bool = True):
    """Occlusion march toward the light (wgsl:635-680).

    Returns the occlusion factor [...]: 1.0 unoccluded, ``OCCLUSION_FACTOR``
    where a *different* live cell's visible cube blocks the segment.
    ``active`` masks the pixels that need the march; ``min_cell_step``
    takes the step as at least the visible cell size (the clustered
    shader, :644), else the plain quotient (pathtraced_fragment.wgsl:559,
    the simple variant)."""
    direction, march_depth = _segment(start, end)
    cell_size = np.float32(FULL_CUBE_SIZE / grid_size)
    vis_size = cell_size * np.float32(cell_size_mul)
    vis_half = float(vis_size * np.float32(0.5))
    step_size = march_depth / scalar_tensor(shadow_samples, march_depth)
    if min_cell_step:
        step_size = torch.clamp(step_size, min=float(vis_size))
    depth0 = step_size * rnd_offset + 0.0025
    if active is None:
        active = torch.ones_like(march_depth, dtype=torch.bool)

    cell_t = scalar_tensor(cell_size, start)
    occluded = torch.zeros_like(march_depth, dtype=torch.bool)
    for i in range(shadow_samples):
        depth = depth0 + step_size * float(i)
        coords, state, t_near, t_far = _cell_probe(
            packed_flat, start, direction, depth, cell_t, vis_half, grid_size)
        not_start = (coords != start_cell_coords).any(dim=-1)
        occluded = occluded | (active & (depth < march_depth) & not_start & (state == 1)
                               & (t_near <= t_far) & (t_near >= 0.0))
    return torch.where(occluded, OCCLUSION_FACTOR, 1.0)
