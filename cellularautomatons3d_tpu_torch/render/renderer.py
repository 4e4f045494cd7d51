"""Render constants, per-frame parameters and the GI neighbour layers.

Port of ``RenderStatic``, ``RenderParams``, ``_INDIRECT_LAYERS`` and
``_face_index`` from ``cellularautomatons3d_tpu.render.renderer``.  The exact
reference pipeline
(``render_frame``: stochastic march, reprojection) is not ported yet
(ROADMAP.md queue 1, item 11).

``RenderParams`` holds host values (numpy float32): they are packed into the
kernel's 40-float parameter vector each frame (``renderer_fast._cam_vec``)
and passed to the kernel by value.  Its previous-frame matrices feed the
moving camera's history reprojection (:func:`_get_reprojected_uv`,
``renderer_fast.reproject_history``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["RenderStatic", "RenderParams"]


@dataclasses.dataclass(frozen=True)
class RenderStatic:
    """Render constants fixed between rebuilds: the fast path's lighting
    model (hard or soft shadows, one- or multi-bounce GI, the temporally
    amortized mode) and the choice of the sliced path.  The JAX package's
    reference-pipeline sample counts come with ROADMAP item 11; its
    ``slab_planes`` and ``x_chunk_cells`` are TPU brick layout and do not
    come across."""

    width: int
    height: int
    grid_size: int
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
