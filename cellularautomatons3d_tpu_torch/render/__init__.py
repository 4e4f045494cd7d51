from .camera import CameraRig, pixel_uvs, get_ray, COT_HALF_FOV
from .intersect import ray_cube_intersect
from .renderer import RenderStatic, RenderParams
from .render_fast import pack_cam, raytrace, raytrace_cuda, raytrace_tiles
from .renderer_fast import (
    FastHistory,
    init_fast_history,
    render_frame_fast,
    make_fused_loop,
)

__all__ = [
    "CameraRig",
    "pixel_uvs",
    "get_ray",
    "COT_HALF_FOV",
    "ray_cube_intersect",
    "RenderStatic",
    "RenderParams",
    "pack_cam",
    "raytrace",
    "raytrace_cuda",
    "raytrace_tiles",
    "FastHistory",
    "init_fast_history",
    "render_frame_fast",
    "make_fused_loop",
]
