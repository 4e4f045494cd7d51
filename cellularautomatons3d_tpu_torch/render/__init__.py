from .camera import CameraRig, pixel_uvs, get_ray, COT_HALF_FOV
from .intersect import (
    ray_cube_intersect,
    sd_box,
    cube_face_normal,
    cell_from_sample_point,
    get_cell_state,
    nrand,
    n1rand,
)
from .raymarch import ray_march_depth, ray_march_shadow, OCCLUSION_FACTOR
from .renderer import RenderStatic, RenderParams, RenderHistory, init_history, render_frame
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
    "sd_box",
    "cube_face_normal",
    "cell_from_sample_point",
    "get_cell_state",
    "nrand",
    "n1rand",
    "ray_march_depth",
    "ray_march_shadow",
    "OCCLUSION_FACTOR",
    "RenderStatic",
    "RenderParams",
    "RenderHistory",
    "init_history",
    "render_frame",
    "pack_cam",
    "raytrace",
    "raytrace_cuda",
    "raytrace_tiles",
    "FastHistory",
    "init_fast_history",
    "render_frame_fast",
    "make_fused_loop",
]
