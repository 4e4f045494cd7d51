"""Geometry primitives of the volume renderer, vectorized over pixels.

Port of the slab test and the cube face normal of
``cellularautomatons3d_tpu.render.intersect``
(pathtraced_fragment_clustered.wgsl:212-225, 227-254).  Vectors live on the
trailing axis of size 3 and broadcast over leading pixel axes.
"""

from __future__ import annotations

import torch

__all__ = [
    "HALF_CUBE_SIZE", "FULL_CUBE_SIZE", "ray_cube_intersect", "cube_face_normal",
    "vec_norm", "device_vec",
]

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


def vec_norm(v):
    """Euclidean length over the trailing axis, kept as a size-1 axis:
    ``sqrt((x² + y²) + z²)``, the reference's summation order."""
    sq = v * v
    return torch.sqrt(sq[..., 0:1] + sq[..., 1:2] + sq[..., 2:3])


def cube_face_normal(intersection_point, cube_origin):
    """Axis-aligned face normal from the dominant offset component
    (pathtraced_fragment_clustered.wgsl:227-254): the reference's if/else
    priority x, then y, else z, normalised by a divide."""
    d = intersection_point - cube_origin
    ad = d.abs()
    d_max = torch.amax(ad, dim=-1, keepdim=True)
    is_x = ad[..., 0:1] == d_max
    is_y = (ad[..., 1:2] == d_max) & ~is_x
    is_z = ~is_x & ~is_y
    n = torch.cat(
        [
            torch.where(is_x, d[..., 0:1], 0.0),
            torch.where(is_y, d[..., 1:2], 0.0),
            torch.where(is_z, d[..., 2:3], 0.0),
        ],
        dim=-1,
    )
    return n / vec_norm(n)


def device_vec(values, device) -> torch.Tensor:
    """Host values as a float32 [len(values)] tensor on ``device``, made by
    fill kernels: a copy from pageable host memory to the card would wait
    for the stream to drain."""
    return torch.stack(
        [torch.full((), float(v), dtype=torch.float32, device=device) for v in values]
    )
