"""Cook-Torrance BRDF and direct lighting, vectorized over pixels.

Port of ``cellularautomatons3d_tpu.render.brdf`` (the shading of the GI
bounces): Trowbridge-Reitz GGX NDF (pathtraced_fragment_clustered.wgsl:
537-545), Schlick-GGX geometry with the k-direct remap (:548-560),
Fresnel-Schlick with the reference's unclamped dot (:563-568),
``surface_brdf`` (:570-592) and ``calculate_lighting_at`` (:594-633) with
the position rainbow albedo when the material colour is all zero
(:598-603).  ``calculate_lighting_at_simple`` belongs to the reference
pipeline (ROADMAP.md queue 1, item 11) and is not ported yet.

Divisions follow IEEE like WGSL, the possibly-zero Cook-Torrance
denominator included.  The material parameters are host float32 values (the
kernel parameter vector); every division has a tensor divisor, because CUDA
torch divides by a Python scalar as a multiply by its reciprocal.
"""

from __future__ import annotations

import numpy as np
import torch

from .intersect import cube_face_normal, device_vec, vec_norm

__all__ = [
    "trowbridge_reitz_ggx",
    "schlick_ggx",
    "fresnel_schlick",
    "surface_brdf",
    "calculate_lighting_at",
]

PI = float(np.float32(3.14159265359))  # :65


def _dot(a, b):
    """Sum over the trailing axis, in the reference's order."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def _normalize(v):
    return v / vec_norm(v)


def trowbridge_reitz_ggx(surface_normal, halfway, roughness):
    """NDF (:537-545); a² = roughness² as in the reference."""
    r = np.float32(roughness)
    a2 = r * r
    noh = _dot(surface_normal, halfway)
    f = noh * noh * float(a2 - np.float32(1.0)) + 1.0
    return torch.full_like(f, float(a2)) / (f * PI * f)


def schlick_ggx(surface_normal, direction, roughness):
    """Geometry term with the k_direct remap (:548-560)."""
    n = np.float32(roughness) + np.float32(1.0)
    k_direct = (n * n) / np.float32(8.0)
    nov = torch.clamp(_dot(surface_normal, direction), min=0.0)
    return nov / (nov * float(np.float32(1.0) - k_direct) + float(k_direct))


def fresnel_schlick(halfway, view_dir, base_reflectivity):
    """(:563-568): ``(1 - h·v) ** 5`` with the unclamped dot, as
    ``lax.integer_pow`` multiplies it."""
    p1 = 1.0 - _dot(halfway, view_dir)
    p2 = p1 * p1
    p5 = p1 * (p2 * p2)
    base = np.asarray(base_reflectivity, np.float32)
    return _const(base, p5) + _const(np.float32(1.0) - base, p5) * p5[..., None]


def surface_brdf(light_dir, view_dir, surface_normal, roughness, albedo,
                 base_reflectivity):
    """Lambertian diffuse + Cook-Torrance specular (:570-592)."""
    halfway = _normalize(light_dir + view_dir)
    f_l = albedo / torch.full_like(albedo, PI)
    d = trowbridge_reitz_ggx(surface_normal, halfway, roughness)
    g = schlick_ggx(surface_normal, view_dir, roughness) * schlick_ggx(
        surface_normal, light_dir, roughness
    )
    f = fresnel_schlick(halfway, view_dir, base_reflectivity)
    denom = 4.0 * _dot(view_dir, surface_normal) * _dot(light_dir, surface_normal)
    f_ct = (d * g)[..., None] * f / denom[..., None]
    return f_l + f_ct


def calculate_lighting_at(sample_point, cell_origin, cell_coords, eye_pos,
                          incident_light, incident_light_pos, *, grid_size: int,
                          roughness, material_color, base_reflectivity):
    """Rendering-equation direct light at a cube surface point (:594-633).

    ``incident_light`` is an [..., 3] radiance (the light magnitude for
    direct light, or reflected light for an indirect bounce); ``eye_pos``
    and ``incident_light_pos`` are [3] or [..., 3] tensors."""
    surface_normal = cube_face_normal(sample_point, cell_origin)
    material = np.asarray(material_color, np.float32)
    if (material != 0.0).any():
        albedo = _const(material, sample_point).expand(sample_point.shape)
    else:
        c = cell_coords.to(torch.float32)
        c = c / torch.full_like(c, float(grid_size))
        albedo = torch.stack([c[..., 0], c[..., 1], 1.0 - c[..., 0]], dim=-1)
    view_dir = _normalize(eye_pos - sample_point)
    light_dir = _normalize(incident_light_pos - sample_point)
    brdf = surface_brdf(
        light_dir, view_dir, surface_normal, roughness, albedo, base_reflectivity
    )
    lr = brdf * incident_light * _dot(light_dir, surface_normal)[..., None]
    return torch.clamp(lr, min=0.0)


def _const(values, like):
    """Host float32 values as a tensor on ``like``'s device."""
    return device_vec(np.asarray(values, np.float32).reshape(-1), like.device)
