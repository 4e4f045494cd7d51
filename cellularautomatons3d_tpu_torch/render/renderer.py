"""Render constants and per-frame parameters.

Port of ``RenderStatic`` and ``RenderParams`` from
``cellularautomatons3d_tpu.render.renderer``.  The exact reference pipeline
(``render_frame``: stochastic march, reprojection) is not ported yet
(ROADMAP.md queue 1, item 11).

``RenderParams`` holds host values (numpy float32): they are packed into the
kernel's 40-float parameter vector each frame (``renderer_fast._cam_vec``)
and passed to the kernel by value.  The previous-frame matrices of the JAX
package's record come with the moving camera (ROADMAP.md queue 1, item 8).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

__all__ = ["RenderStatic", "RenderParams"]


@dataclasses.dataclass(frozen=True)
class RenderStatic:
    """Render constants fixed between rebuilds.  The port renders only the
    hard-shadow fast path; the lighting extensions are kept so that asking
    for them raises (``renderer_fast.check_supported``) instead of being
    ignored.  The JAX package's reference-pipeline sample counts and
    sliced-path controls come with their ROADMAP items."""

    width: int
    height: int
    grid_size: int
    indirect_lighting: bool = False
    soft_shadow_samples: int = 1
    gi_temporal: bool = False


class RenderParams(NamedTuple):
    """Live per-frame operands — the uniform-arena contents
    (CommonBufferLayout, pathtraced_fragment_clustered.wgsl:17-34)."""

    view_mat: np.ndarray          # [4,4] camera-to-world
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
