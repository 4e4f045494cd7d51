"""Geometry primitives of the volume renderer, vectorized over pixels.

Port of ``cellularautomatons3d_tpu.render.intersect``
(pathtraced_fragment_clustered.wgsl): the slab test (:212-225), the box SDF
(:182-186), the cube face normal (:227-254), cell addressing (:292-304), the
packed-word cell-state fetch (:268-290) and the sin-fract hash (:171-180).
Vectors live on the trailing axis of size 3 and broadcast over leading pixel
axes.

Float rules, so the card and the CPU give the same answer: divisions have
tensor divisors (CUDA torch divides by a Python scalar as a multiply by its
reciprocal), float-to-int conversions saturate as XLA's do (:func:`to_int32`:
NaN to 0, out of range to the nearest int32; x86 truncation gives INT_MIN
and CUDA saturates), and the hash evaluates ``sin`` in float64 rounded once
to float32.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "HALF_CUBE_SIZE", "FULL_CUBE_SIZE", "ray_cube_intersect", "sd_box",
    "cube_face_normal", "cell_coords_origin", "cell_from_sample_point", "get_cell_state", "nrand",
    "n1rand", "vec_norm", "normalize", "device_vec", "scalar_tensor", "to_int32",
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


def sd_box(p, b):
    """Signed distance to a box of half extents ``b`` (a float or a [3]
    tensor) at the origin (pathtraced_fragment_clustered.wgsl:182-186)."""
    q = p.abs() - b
    outside = vec_norm(torch.clamp(q, min=0.0))[..., 0]
    inside = torch.clamp(torch.amax(q, dim=-1), max=0.0)
    return outside + inside


def normalize(v):
    """``v`` over its norm (:func:`vec_norm`), divided by a tensor."""
    return v / vec_norm(v)


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


def scalar_tensor(value, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d tensor on ``like``'s device: a divisor that keeps a
    division IEEE on the card."""
    return torch.full((), float(value), dtype=torch.float32, device=like.device)


def device_vec(values, device) -> torch.Tensor:
    """Host values as a float32 [len(values)] tensor on ``device``, made by
    fill kernels: a copy from pageable host memory to the card would wait
    for the stream to drain."""
    return torch.stack(
        [torch.full((), float(v), dtype=torch.float32, device=device) for v in values]
    )


_INT32_MAX = 2**31 - 1


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """Float32 → int32 by truncation, saturating as XLA converts: NaN to 0,
    values beyond the int32 range to its ends.  The CPU's plain conversion
    gives INT_MIN for all of these and CUDA's saturates, so the port
    converts through this on both."""
    y = torch.where(torch.isnan(x), 0.0, x).clamp(min=-(2.0**31), max=2147483520.0)
    return torch.where(x >= 2.0**31, _INT32_MAX, y.to(torch.int32))


def cell_coords_origin(sample_point, grid_size: int, cell_t):
    """The sample's cell coords (int32 [..., 3], clamped below at 0) and
    cell origin (f32 [..., 3]); ``cell_t`` is the cell size as a 0-d tensor
    (:func:`scalar_tensor`), made once by a caller that probes many samples."""
    cell_size = float(np.float32(FULL_CUBE_SIZE / grid_size))
    coords_f = torch.floor((sample_point + HALF_CUBE_SIZE) / cell_t)
    origin = coords_f * cell_size + cell_size * 0.5 - HALF_CUBE_SIZE
    return to_int32(torch.clamp(coords_f, min=0.0)), origin


def cell_from_sample_point(sample_point, grid_size: int):
    """(cell_coords int32 [..., 3], cell_origin f32 [..., 3], cell_idx int32)
    (pathtraced_fragment_clustered.wgsl:292-304).  ``cell_idx`` is the raw
    x + y·N + z·N² identifier, for equality tests only (int32, wrapping as
    in the reference); coordinates are clamped below at 0, as WGSL's
    float→uint conversion saturates."""
    cell_t = scalar_tensor(np.float32(FULL_CUBE_SIZE / grid_size), sample_point)
    coords, cell_origin = cell_coords_origin(sample_point, grid_size, cell_t)
    n = grid_size
    idx = coords[..., 0] + coords[..., 1] * n + coords[..., 2] * (n * n)
    return coords, cell_origin, idx


def get_cell_state(packed_flat, coords, grid_size: int):
    """Cell state (0/1 int32) at non-negative int32 coords [..., 3] of the
    port's packed words (``int32`` bits of ``uint32[W, Z, Y]``, flattened):
    x wraps by words, ``(x // 32) % W`` and bit ``x % 32``, y and z modulo
    n (pathtraced_fragment_clustered.wgsl:268-290), so any non-negative
    coordinate, however far outside the volume, reads a cell."""
    n = grid_size
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    w = torch.remainder(x >> 5, n // 32)
    flat = (w * n + torch.remainder(z, n)) * n + torch.remainder(y, n)
    words = packed_flat[flat.long()]
    # An arithmetic shift keeps bit ``x & 31`` in bit 0.
    return (words >> (x & 31)) & 1


def nrand(n):
    """The reference's hash (pathtraced_fragment_clustered.wgsl:171-175):
    fract(sin(dot(n, (12.9898, 78.233))) * 43758.5453), with ``sin``
    evaluated in float64 and rounded once."""
    d = n[..., 0] * 12.9898 + n[..., 1] * 78.233
    v = torch.sin(d.to(torch.float64)).to(torch.float32) * 43758.5453
    return v - torch.floor(v)


def n1rand(uv, elapsed_time):
    """The time-seeded hash (pathtraced_fragment_clustered.wgsl:177-180):
    ``nrand(0.07 · fract(t) + uv)``; ``elapsed_time`` a host float32."""
    t = np.float32(elapsed_time)
    return nrand(uv + float(np.float32(0.07) * (t - np.floor(t))))
