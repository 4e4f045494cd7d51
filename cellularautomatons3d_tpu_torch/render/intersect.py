"""Geometry primitives of the volume renderer, vectorized over pixels.

Port of the slab test of ``cellularautomatons3d_tpu.render.intersect``
(pathtraced_fragment_clustered.wgsl:212-225).  Vectors live on the trailing
axis of size 3 and broadcast over leading pixel axes.
"""

from __future__ import annotations

import torch

__all__ = ["HALF_CUBE_SIZE", "FULL_CUBE_SIZE", "ray_cube_intersect"]

HALF_CUBE_SIZE = 0.5   # pathtraced_fragment_clustered.wgsl:70
FULL_CUBE_SIZE = 1.0


def ray_cube_intersect(ray_origin, ray_dir, cube_center, cube_half_extents):
    """Slab test: (t_near, t_far), each [...]-shaped.  Division by zero
    follows IEEE (±inf) and NaN propagates through the min/max, as in the
    reference."""
    inv = 1.0 / ray_dir
    t_min = (cube_center - cube_half_extents - ray_origin) * inv
    t_max = (cube_center + cube_half_extents - ray_origin) * inv
    t1 = torch.minimum(t_min, t_max)
    t2 = torch.maximum(t_min, t_max)
    return torch.amax(t1, dim=-1), torch.amin(t2, dim=-1)
