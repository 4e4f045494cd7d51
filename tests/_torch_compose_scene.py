"""A light placed on one pixel's ray, so that the pixel, if black, shows the
light-source cube: the composition's tests (``tests/test_torch_compose.py``,
``tests/test_torch_cuda.py``) and ``chip_smoke.py`` phase (s).  Numpy only."""

import numpy as np

# 1 / tan(37.5°): the shader's fixed half field of view (render/camera.py).
COT_HALF_FOV = 1.0 / np.tan(np.radians(37.5))


def light_on_pixel(view, px, py, width, full_height, row0=0, distance=0.8):
    """A light position ``distance`` from the camera on the ray of pixel (px,
    py) of a window of ``width`` × ``full_height`` pixels (``row0``: the first
    row of a shard)."""
    u, v = (px + 0.5) / width, 1.0 - (py + row0 + 0.5) / full_height
    ray = np.array([(u - 0.5) * width / full_height, v - 0.5, -0.5 * COT_HALF_FOV])
    view = np.asarray(view, np.float64)
    return (view[:3, 3] + distance * (view[:3, :3] @ (ray / np.linalg.norm(ray)))).astype(
        np.float32)
