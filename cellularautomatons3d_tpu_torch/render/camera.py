"""Camera: per-pixel UV/ray generation and the interactive camera rig.

Port of ``cellularautomatons3d_tpu.render.camera``: the fragment shader's
fixed 75° FOV ray from UV (pathtraced_fragment_clustered.wgsl:69,188-197),
the quad's UV convention (``(0,0)`` bottom-left, pixel row 0 has
uv.y ≈ 1) and the host-side :class:`CameraRig` (numpy matrices, copied).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import mat4

__all__ = ["COT_HALF_FOV", "pixel_uvs", "get_ray", "CameraRig"]

# COT_HALF_FOV: 1/tan(37.5°) — the shader hard-codes the half angle
# (pathtraced_fragment_clustered.wgsl:68-69).
PI_OVER_180 = np.float32(np.pi / 180.0)
COT_HALF_FOV = np.float32(1.0) / np.float32(np.tan(np.float32(37.5) * PI_OVER_180))

TRANSLATION_SPEED = 1.0   # main_pathtraced.js:6
ROTATION_SPEED = 1.25     # main_pathtraced.js:7
MIN_SPEED_MUL = 0.001     # main_pathtraced.js:8
MAX_SPEED_MUL = 100.0     # main_pathtraced.js:9


def pixel_uvs(width: int, height: int, device=None, row0: int = 0,
              full_height: int | None = None) -> torch.Tensor:
    """Per-pixel quad UVs, shape [H, W, 2], row 0 = top of screen:
    uv.x = (i+0.5)/W, uv.y = 1 - (j+row0+0.5)/full_height.  ``row0`` /
    ``full_height``: the rows of a horizontal shard of a taller window
    (renderer_fast.py:250-254 of the JAX package); by default the whole
    window of ``height`` rows."""
    fh = height if full_height is None else full_height
    xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    ys = torch.arange(height, dtype=torch.float32, device=device) + float(row0) + 0.5
    # Tensor divisors: CUDA torch divides by a Python scalar as a multiply
    # by its reciprocal, which is not IEEE division.
    xs = xs / torch.full_like(xs, width)
    ys = 1.0 - ys / torch.full_like(ys, fh)
    v, u = torch.meshgrid(ys, xs, indexing="ij")  # [H, W]
    return torch.stack([u, v], dim=-1)


def get_ray(uv: torch.Tensor, window_size) -> torch.Tensor:
    """Camera-space ray from UV (pathtraced_fragment_clustered.wgsl:188-197).

    uv: [..., 2]; window_size: (w, h).  Returns normalized [..., 3].
    """
    r = np.float32(window_size[0]) / np.float32(window_size[1])
    xy = uv - 0.5
    x = xy[..., 0] * float(r)
    y = xy[..., 1]
    z = torch.full_like(x, float(np.float32(0.5) * COT_HALF_FOV))
    ray = torch.stack([x, y, -z], dim=-1)
    return ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True)


class CameraRig:
    """Host-side interactive camera: the WASD/R/F translate, arrows/Q/E and
    mouse-look rotate, wheel speed-multiplier model of the reference
    (main_pathtraced.js:858-968,799-806).

    ``view_mat`` is the camera-to-world matrix consumed by the renderer
    (column 3 = camera position, pathtraced_fragment_clustered.wgsl:812).
    """

    def __init__(self):
        self.view_mat = mat4.initial_view_matrix()
        self.prev_view_mat = mat4.identity()
        self.prev_proj_view = mat4.identity()
        self.translation_speed_mul = 0.2  # main_pathtraced.js:115

    def translate(self, direction, dt_seconds: float):
        """direction: (x, y, z) in camera-local axes, each in {-1, 0, 1}."""
        v = np.asarray(direction, dtype=np.float32) * np.float32(
            TRANSLATION_SPEED * self.translation_speed_mul * dt_seconds
        )
        self.view_mat = mat4.translate(self.view_mat, v)

    def rotate(self, axis, dt_seconds: float, magnitude: float = ROTATION_SPEED):
        """Local-axis rotate (arrows/Q/E: main_pathtraced.js:894-942)."""
        self.view_mat = mat4.rotate(self.view_mat, axis, magnitude * dt_seconds)

    def mouse_look(self, dx: float, dy: float):
        """Pointer-lock mouse look (main_pathtraced.js:945-968)."""
        if dx == 0 and dy == 0:
            return
        magnitude = 0.001 * float(np.sqrt(dx * dx + dy * dy))
        self.view_mat = mat4.rotate(self.view_mat, (-dy, -dx, 0.0), magnitude)

    def wheel(self, delta_y: float):
        """Speed multiplier, clamped [0.001, 100] (main_pathtraced.js:799-806)."""
        mul = self.translation_speed_mul * float(np.sign(-delta_y)) * 0.1
        self.translation_speed_mul = float(
            np.clip(self.translation_speed_mul + mul, MIN_SPEED_MUL, MAX_SPEED_MUL)
        )

    def matrices(self, width: int, height: int):
        """(view, prev_view, proj_view, prev_proj_view) float32 [4,4]."""
        proj = mat4.initial_projection_matrix(width, height)
        proj_view = mat4.multiply(proj, mat4.inverse(self.view_mat))
        self._proj_view = proj_view
        return self.view_mat, self.prev_view_mat, proj_view, self.prev_proj_view

    def end_frame(self):
        """Save current as previous (main_pathtraced.js:520-524)."""
        self.prev_view_mat = self.view_mat.copy()
        if hasattr(self, "_proj_view"):
            self.prev_proj_view = self._proj_view.copy()
