"""The plain reference of a frame: a frozen copy of the port's plain torch
twins, in one file that imports nothing of the port.

What is copied, and from where (``cellularautomatons3d_tpu_torch/``):

* K1's plain traversal and shading, ``render/render_fast.py`` ``raytrace``
  (``_pixel_rays``, ``_sweep``, ``_primary``, ``_shade``, and for a
  multi-state rule ``_hit_ages`` and ``_age_fade``, the hit's age fading the
  direct term): here :func:`k1_trace` (the hard-shadowed or unshadowed
  light, depth and hit ids) and :func:`k1_compose` (the fused loop's
  in-kernel composition), split so that a replay of many frames of one scene
  traces each scene once;
* the sliced frame, ``render/render_slab.py`` ``raytrace_sliced`` with the
  plain K4 ``primary_sweep`` (K1's primary sweep with the hit's age):
  :func:`sliced_trace`, whose lighting passes take the hard shadow as their
  one query (or the soft-shadow samples, and GI, where configured), compute
  the direct light (``_lighting_tail`` without K1's
  frame: the age fade, black on misses, the volume's exit as a miss's depth,
  ``_miss_depth``) and add the emissive light on hits;
* the lighting passes' plain twins, ``render/render_slab.py``
  (``lighting_queries_stacked``, ``gi_states`` with ``lighting_level_stacked``
  and ``cell_state``, the plain K2 ``shadow_sweep``, ``lighting_shade`` with
  ``_gi_light`` and ``_lighting_tail``): :func:`lighting_passes`, and
  ``render/brdf.py``'s ``calculate_lighting_at``;
* the composition's twin, ``render/renderer_fast.py`` ``compose_frame``
  with ``reproject_history``, and ``utils/mat4.py``'s projection: with a
  traced frame, ``render_frame_fast``'s frame, which the fused loop runs
  every frame on the sliced path and with multi-bounce GI, the history
  float16 between frames.

Only the paths the benchmark's cells can run are kept: no prepass mask, no
descents, every soft-shadow sample and GI slot per frame.  Left out: the
fused loop's extended frame (``renderer_fast._ext_frame``: soft shadows or
one-bounce GI at ≤ 256³, composed in the shade kernel against an f32
history) and the temporally amortized lighting (``gi_temporal``, its sample
index).  Every float expression keeps the twins' operation order, so on the
same inputs this file gives the twins' frames.

The compute dtype is :data:`FLOAT` (float32).  :func:`precision` switches it
for the control, which runs the same code one precision below (bfloat16).
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import numpy as np
import torch

FLOAT = torch.float32


@contextlib.contextmanager
def precision(dtype):
    """Run the block's reference arithmetic in ``dtype``."""
    global FLOAT
    old, FLOAT = FLOAT, dtype
    try:
        yield
    finally:
        FLOAT = old


# The kernels' parameter vector (render_fast.py P_*).
P_O, P_WIN, P_LIGHT, P_LMAG, P_CELLMUL, P_ROUGH = 9, 12, 14, 17, 18, 19
P_REFL, P_MATC, P_LRAD, P_EMIS, P_EMISS, P_TIME = 20, 23, 26, 27, 30, 31
P_ROW0, P_ALPHA, P_GAMMA, P_OVERLAY, P_LEN = 32, 33, 34, 35, 40

K1_COT_HALF_FOV = 1.3032254  # render_fast.py's literal
COT_HALF_FOV = np.float32(1.0) / np.float32(np.tan(np.float32(37.5) * np.float32(np.pi / 180.0)))
PI = 3.14159265359
BRDF_PI = float(np.float32(3.14159265359))
OCCLUDED = 0.0095
HALF_CUBE_SIZE = 0.5
FULL_CUBE_SIZE = 1.0
FOV_DEGREES = 75.0

INDIRECT_LAYERS = np.array(
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


# ------------------------------------------------------------ camera ---


def perspective(fov_y_radians, aspect, z_near, z_far):
    f32 = np.float32
    f = f32(np.tan(np.pi * 0.5 - 0.5 * fov_y_radians))
    m = np.zeros((4, 4), dtype=f32)
    m[0, 0] = f / f32(aspect)
    m[1, 1] = f
    m[3, 2] = f32(-1.0)
    range_inv = f32(1.0) / (f32(z_near) - f32(z_far))
    m[2, 2] = f32(z_far) * range_inv
    m[2, 3] = f32(z_far) * f32(z_near) * range_inv
    return m


def proj_view(view, width, height):
    """The previous frame's view-projection of a camera-to-world ``view``:
    the 75° projection times the view's inverse, float32."""
    proj = perspective(np.deg2rad(FOV_DEGREES), width / height, 0.01, 1000.0)
    inv = np.linalg.inv(np.asarray(view, np.float32)).astype(np.float32)
    return (proj @ inv).astype(np.float32)


class Params(NamedTuple):
    """A frame's render parameters (the port's ``RenderParams`` fields)."""
    view_mat: np.ndarray
    prev_proj_view: np.ndarray
    elapsed_time: np.float32
    cell_size: np.float32
    temporal_alpha: np.float32
    gamma: np.float32
    roughness: np.float32
    base_reflectivity: np.ndarray
    material_color: np.ndarray
    light_pos: np.ndarray
    light_magnitude: np.float32
    show_depth_overlay: np.float32
    light_radius: np.float32
    emissive_color: np.ndarray
    emissive_strength: np.float32


def cam_vec(p: Params, w, fh, row0=0.0) -> np.ndarray:
    """renderer_fast._cam_vec: the kernels' parameter vector."""
    f32 = np.float32
    cam = np.concatenate([
        np.asarray(p.view_mat, f32)[:3, :3].reshape(-1),
        np.asarray(p.view_mat, f32)[:3, 3],
        np.array([w, fh], f32),
        np.asarray(p.light_pos, f32).reshape(3),
        f32([p.light_magnitude]), f32([p.cell_size]), f32([p.roughness]),
        np.asarray(p.base_reflectivity, f32).reshape(3),
        np.asarray(p.material_color, f32).reshape(3),
        f32([p.light_radius]),
        np.asarray(p.emissive_color, f32).reshape(3),
        f32([p.emissive_strength]), f32([p.elapsed_time]), f32([row0]),
        f32([p.temporal_alpha]), f32([p.gamma]), f32([p.show_depth_overlay]),
        np.zeros((4,), f32),
    ])
    assert cam.shape == (P_LEN,)
    return cam


# ---------------------------------------------------------- helpers ---


def device_vec(values, device):
    return torch.stack([torch.full((), float(v), dtype=FLOAT, device=device) for v in values])


def vec_norm(v):
    sq = v * v
    return torch.sqrt(sq[..., 0:1] + sq[..., 1:2] + sq[..., 2:3])


def normalize(v):
    return v / vec_norm(v)


def ray_cube_intersect(ray_origin, ray_dir, cube_center, cube_half_extents):
    inv = 1.0 / ray_dir
    t_min = (cube_center - cube_half_extents - ray_origin) * inv
    t_max = (cube_center + cube_half_extents - ray_origin) * inv
    t1 = torch.minimum(t_min, t_max)
    t2 = torch.maximum(t_min, t_max)
    return torch.amax(t1, dim=-1), torch.amin(t2, dim=-1)


def cube_face_normal(intersection_point, cube_origin):
    d = intersection_point - cube_origin
    ad = d.abs()
    d_max = torch.amax(ad, dim=-1, keepdim=True)
    is_x = ad[..., 0:1] == d_max
    is_y = (ad[..., 1:2] == d_max) & ~is_x
    is_z = ~is_x & ~is_y
    n = torch.cat([torch.where(is_x, d[..., 0:1], 0.0), torch.where(is_y, d[..., 1:2], 0.0),
                   torch.where(is_z, d[..., 2:3], 0.0)], dim=-1)
    return n / vec_norm(n)


def face_index(normal):
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    return torch.where(
        nx.abs() > 0.5, torch.where(nx < 0, 0, 1),
        torch.where(ny.abs() > 0.5, torch.where(ny < 0, 2, 3), torch.where(nz < 0, 4, 5)))


def _normalize3(x, y, z):
    inv = 1.0 / torch.sqrt(x * x + y * y + z * z)
    return x * inv, y * inv, z * inv


def _vol_slab(o, d):
    inv = 1.0 / d
    t1 = (-0.5 - o) * inv
    t2 = (0.5 - o) * inv
    return torch.minimum(t1, t2), torch.maximum(t1, t2)


def _box(c, h, o, inv):
    t1 = (c - h - o) * inv
    t2 = (c + h - o) * inv
    return torch.minimum(t1, t2), torch.maximum(t1, t2)


def cell_half(cam, n: int) -> float:
    return float(np.float32(1.0 / n) * np.float32(cam[P_CELLMUL]) * np.float32(0.5))


# -------------------------------------------------------- traversal ---


def _pixel_rays(cam, width, height, device):
    f = lambda i: float(cam[i])  # noqa: E731
    win_w, win_h = cam[P_WIN], cam[P_WIN + 1]
    py = torch.arange(height, dtype=FLOAT, device=device)[:, None]
    px = torch.arange(width, dtype=FLOAT, device=device)[None, :]
    py, px = py.expand(height, width), px.expand(height, width)
    ux = (px + 0.5) / torch.full_like(px, float(win_w))
    uy = 1.0 - (py + f(P_ROW0) + 0.5) / torch.full_like(py, float(win_h))
    rx = (ux - 0.5) * float(win_w / win_h)
    ry = uy - 0.5
    rz = torch.full_like(rx, -0.5 * K1_COT_HALF_FOV)
    rx, ry, rz = _normalize3(rx, ry, rz)
    dx = f(0) * rx + f(1) * ry + f(2) * rz
    dy = f(3) * rx + f(4) * ry + f(5) * rz
    dz = f(6) * rx + f(7) * ry + f(8) * rz
    return ux, dx, dy, dz


def _sweep(vol_flat, n, half, o, d, t_start, t_end, active, exclude=None):
    """One plane-midpoint sweep over every z-plane (render_fast._sweep)."""
    ox, oy, oz = o
    dx, dy, dz = d
    inv_n = float(np.float32(1.0 / n))
    up = dz > 0
    pass_active = active & (up | (dz < 0))
    inv_dx, inv_dy, inv_dz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    found = torch.zeros_like(active)
    t_hit = torch.zeros_like(dx)
    hx = torch.zeros(dx.shape, dtype=torch.int32, device=dx.device)
    hy, hz = hx.clone(), hx.clone()
    for k in range(n):
        kk = torch.where(up, k, n - 1 - k).to(torch.int32)
        gzf = kk.to(FLOAT)
        ta = (gzf * inv_n - 0.5 - oz) * inv_dz
        tb = ((gzf + 1.0) * inv_n - 0.5 - oz) * inv_dz
        lo = torch.maximum(torch.minimum(ta, tb), t_start)
        hi = torch.minimum(torch.maximum(ta, tb), t_end)
        seg_ok = (lo < hi) & ~found & pass_active
        tm = 0.5 * (lo + hi)
        cxf = torch.clamp(torch.floor((ox + tm * dx + 0.5) * n), 0, n - 1)
        cyf = torch.clamp(torch.floor((oy + tm * dy + 0.5) * n), 0, n - 1)
        # The integer clamps change nothing in float32; below it (the
        # control) the float clamp's bound n − 1 may round up to n.
        cx = torch.where(seg_ok, cxf, 0.0).to(torch.int32).clamp(0, n - 1)
        cy = torch.where(seg_ok, cyf, 0.0).to(torch.int32).clamp(0, n - 1)
        word = vol_flat[((cx >> 5) * (n * n) + kk * n + cy).long()]
        cand = seg_ok & (((word >> (cx & 31)) & 1) == 1)
        if exclude is not None:
            cand = cand & ~((cx == exclude[0]) & (cy == exclude[1]) & (kk == exclude[2]))
        ccx = (cx.to(FLOAT) + 0.5) * inv_n - 0.5
        ccy = (cy.to(FLOAT) + 0.5) * inv_n - 0.5
        ccz = (gzf + 0.5) * inv_n - 0.5
        nx_, fx_ = _box(ccx, half, ox, inv_dx)
        ny_, fy_ = _box(ccy, half, oy, inv_dy)
        nz_, fz_ = _box(ccz, half, oz, inv_dz)
        tn = torch.maximum(torch.maximum(nx_, ny_), nz_)
        tf = torch.minimum(torch.minimum(fx_, fy_), fz_)
        if exclude is None:
            ok = (tn <= tf) & (tf >= t_start)
        else:
            ok = (tn <= tf) & (tn >= 0.0)
        hit = cand & ok
        found = found | hit
        t_hit = torch.where(hit, tn, t_hit)
        hx = torch.where(hit, cx, hx)
        hy = torch.where(hit, cy, hy)
        hz = torch.where(hit, kk, hz)
    return found, t_hit, hx, hy, hz


def _shade(cam, q, co, albedo, view_pos):
    """Cook-Torrance direct lighting (render_fast._shade)."""
    f = lambda i: float(cam[i])  # noqa: E731
    qx, qy, qz = q
    fxo, fyo, fzo = qx - co[0], qy - co[1], qz - co[2]
    ax_, ay_, az_ = fxo.abs(), fyo.abs(), fzo.abs()
    m = torch.maximum(torch.maximum(ax_, ay_), az_)
    is_x = ax_ == m
    is_y = (ay_ == m) & ~is_x
    is_z = ~is_x & ~is_y
    nxn = torch.where(is_x, torch.sign(fxo), 0.0)
    nyn = torch.where(is_y, torch.sign(fyo), 0.0)
    nzn = torch.where(is_z, torch.sign(fzo), 0.0)
    ldx, ldy, ldz = _normalize3(f(P_LIGHT) - qx, f(P_LIGHT + 1) - qy, f(P_LIGHT + 2) - qz)
    vx, vy, vz = _normalize3(view_pos[0] - qx, view_pos[1] - qy, view_pos[2] - qz)
    hwx, hwy, hwz = _normalize3(ldx + vx, ldy + vy, ldz + vz)
    rough = cam[P_ROUGH]
    a2 = float(rough * rough)
    kd = float((rough + np.float32(1.0)) * (rough + np.float32(1.0)) / np.float32(8.0))
    noh = nxn * hwx + nyn * hwy + nzn * hwz
    fterm = noh * noh * (a2 - 1.0) + 1.0
    dterm = torch.full_like(fterm, a2) / (PI * fterm * fterm)
    nov = torch.clamp(nxn * vx + nyn * vy + nzn * vz, min=0.0)
    nol_c = torch.clamp(nxn * ldx + nyn * ldy + nzn * ldz, min=0.0)
    gterm = (nov / (nov * float(np.float32(1.0) - np.float32(kd)) + kd)) * (
        nol_c / (nol_c * float(np.float32(1.0) - np.float32(kd)) + kd))
    hv = hwx * vx + hwy * vy + hwz * vz
    p1 = 1.0 - hv
    p2 = p1 * p1
    p5 = p1 * (p2 * p2)
    denom = 4.0 * (vx * nxn + vy * nyn + vz * nzn) * (ldx * nxn + ldy * nyn + ldz * nzn)
    nol = ldx * nxn + ldy * nyn + ldz * nzn
    spec = dterm * gterm / denom
    lm = f(P_LMAG)
    out = []
    for c in range(3):
        refl = cam[P_REFL + c]
        fres = float(refl) + float(np.float32(1.0) - refl) * p5
        alb = albedo[c] / torch.full_like(spec, PI)
        out.append(torch.clamp((alb + spec * fres) * lm * nol, min=0.0))
    return out


class Traced(NamedTuple):
    """K1's traced frame: the light [H, W, 3] (hard-shadowed, or
    unshadowed for the lighting passes), depth, hit ids (-1 = miss), the hit
    mask, and what the in-kernel composition reads of the rays."""
    rgb: torch.Tensor
    depth: torch.Tensor
    idx: torch.Tensor
    found: torch.Tensor
    ux: torch.Tensor
    rays: tuple


def _hit_ages(ages, n, found, hx, hy, hz):
    """render_fast._hit_ages: the age int32 [H, W] of each pixel's hit cell
    from the age bit-planes [B, n/32, n, n]; 1 where nothing was hit."""
    planes = ages.reshape(ages.shape[0], -1)
    word = ((hx >> 5) * (n * n) + hz * n + hy).long()
    age = torch.zeros_like(hx)
    for b in range(planes.shape[0]):
        age = age | (((planes[b][word] >> (hx & 31)) & 1) << b)
    return torch.where(found, age, 1).to(torch.int32)


def age_fade(age, total_states):
    """render_fast._age_fade: ``clip((S − age)/(S − 1), 0, 1)``."""
    num = (total_states - age).to(FLOAT)
    return torch.clamp(num / torch.full_like(num, float(total_states - 1)), 0.0, 1.0)


def _primary(vol_flat, cam, n, half, width, height, device):
    """render_fast._primary without a mask or a mip: (ux, o, d, active, tf,
    (found, t, hx, hy, hz)) of every pixel's camera ray."""
    f = lambda i: float(cam[i])  # noqa: E731
    ux, dx, dy, dz = _pixel_rays(cam, width, height, device)
    ox, oy, oz = (torch.full_like(dx, f(P_O + i)) for i in range(3))
    slabs = [_vol_slab(oi, di) for oi, di in zip((ox, oy, oz), (dx, dy, dz))]
    tn = torch.maximum(torch.maximum(slabs[0][0], slabs[1][0]), slabs[2][0])
    tf = torch.minimum(torch.minimum(slabs[0][1], slabs[1][1]), slabs[2][1])
    active = (tn <= tf) & (tf >= 0.0)
    t_start = torch.clamp(tn, min=0.0)
    hits = _sweep(vol_flat, n, half, (ox, oy, oz), (dx, dy, dz), t_start, tf, active)
    return ux, (ox, oy, oz), (dx, dy, dz), active, tf, hits


def k1_trace(vol, cam, *, grid_size, width, height, shadow=True, ages=None,
             total_states=2) -> Traced:
    """render_fast.raytrace without a history: the traced frame.  ``ages``:
    the age bit-planes of a multi-state rule with ``total_states``, of which
    ``vol`` is the visibility plane; the hit's age then fades the direct
    term."""
    cam = np.ascontiguousarray(cam, dtype=np.float32)
    n = grid_size
    dev = vol.device
    f = lambda i: float(cam[i])  # noqa: E731
    vol_flat = vol.reshape(-1)
    inv_n = float(np.float32(1.0 / n))
    half = float(np.float32(inv_n) * cam[P_CELLMUL] * np.float32(0.5))
    ux, (ox, oy, oz), (dx, dy, dz), active, tf, (found, t_hit, hx, hy, hz) = _primary(
        vol_flat, cam, n, half, width, height, dev)
    depth = torch.where(found, t_hit, torch.where(active, tf, 0.0))
    idx = torch.where(found, hx + hy * n + hz * (n * n), -1).to(torch.int32)
    qx, qy, qz = ox + t_hit * dx, oy + t_hit * dy, oz + t_hit * dz
    occl = torch.ones_like(dx)
    if shadow:
        sdx, sdy, sdz = _normalize3(f(P_LIGHT) - qx, f(P_LIGHT + 1) - qy, f(P_LIGHT + 2) - qz)
        sh_tf = torch.minimum(torch.minimum(_vol_slab(qx, sdx)[1], _vol_slab(qy, sdy)[1]),
                              _vol_slab(qz, sdz)[1])
        occluded = _sweep(vol_flat, n, half, (qx, qy, qz), (sdx, sdy, sdz),
                          torch.zeros_like(sh_tf), sh_tf, found, exclude=(hx, hy, hz))[0]
        occl = torch.where(occluded, OCCLUDED, 1.0)
    co = [(h.to(FLOAT) + 0.5) * inv_n - 0.5 for h in (hx, hy, hz)]
    if (cam[P_MATC : P_MATC + 3] != 0).any():
        albedo = [torch.full_like(dx, f(P_MATC + c)) for c in range(3)]
    else:
        cxn = hx.to(FLOAT) * inv_n
        albedo = [cxn, hy.to(FLOAT) * inv_n, 1.0 - cxn]
    lit = _shade(cam, (qx, qy, qz), co, albedo, (ox, oy, oz))
    if ages is not None:
        occl = occl * age_fade(_hit_ages(ages, n, found, hx, hy, hz), total_states)
    rgb = torch.stack([torch.where(found, c * occl, 0.0) for c in lit], dim=-1)
    return Traced(rgb, depth, idx, found, ux, ((ox, dx), (oy, dy), (oz, dz)))


def k1_compose(cam, tr: Traced, prev, prev_idx):
    """render_fast.raytrace's composition (the fused loop's K1 in compose
    mode) of a traced frame against the f32 history (``prev`` [H, W, 3],
    ``prev_idx`` [H, W]): (presentation, new history colour f32)."""
    f = lambda i: float(cam[i])  # noqa: E731
    found, idx, depth = tr.found, tr.idx, tr.depth
    emis_s = cam[P_EMISS]
    rgb = [torch.where(found, tr.rgb[..., c] + float(cam[P_EMIS + c] * emis_s), tr.rgb[..., c])
           for c in range(3)]
    same = (idx == prev_idx) & found
    alpha = f(P_ALPHA)
    light = []
    for c in range(3):
        p = prev[..., c]
        light.append(torch.where(same, torch.clamp(p + (rgb[c] - p) * alpha, 0.0, 1.0), rgb[c]))
    lrad = np.float32(0.005)
    ln, lf = [], []
    for c, (o, d) in enumerate(tr.rays):
        inv = 1.0 / d
        t1 = float(cam[P_LIGHT + c] - lrad) - o
        t2 = float(cam[P_LIGHT + c] + lrad) - o
        ln.append(torch.minimum(t1 * inv, t2 * inv))
        lf.append(torch.maximum(t1 * inv, t2 * inv))
    ltn = torch.maximum(torch.maximum(ln[0], ln[1]), ln[2])
    ltf = torch.minimum(torch.minimum(lf[0], lf[1]), lf[2])
    black = (light[0] == 0.0) & (light[1] == 0.0) & (light[2] == 0.0)
    cube = (ltn <= ltf) & (ltf >= 0.0) & black
    light = [torch.where(cube, 1.0, c) for c in light]
    new_hist = torch.stack(light, dim=-1)
    overlay = (tr.ux < 0.5) & bool(cam[P_OVERLAY] == 1.0)
    base = [torch.where(overlay, depth, light[0]), torch.where(overlay, 0.0, light[1]),
            torch.where(overlay, 0.0, light[2])]
    inv_g = float(np.float32(1.0) / cam[P_GAMMA])
    pres = torch.stack([torch.pow(b, inv_g) for b in base], dim=-1)
    return pres, new_hist


def with_emissive(cam, tr: Traced):
    """renderer_fast._shaded's K1-only frame: the emissive light on hits."""
    emis = device_vec(cam[P_EMIS : P_EMIS + 3] * cam[P_EMISS], tr.rgb.device)
    return torch.where((tr.idx >= 0)[..., None], tr.rgb + emis, tr.rgb)


# ---------------------------------------------------------- lighting ---


class Lighting(NamedTuple):
    """render_slab.Lighting without the temporal indices."""
    soft_k: int | None = None
    gi: bool = False
    bounces: int = 1

    @property
    def n_soft(self):
        return 0 if self.soft_k is None else max(1, self.soft_k)

    @property
    def n_slots(self):
        return self.level_span(self.bounces + 1)[0] if self.gi else 0

    @property
    def nq(self):
        return self.n_soft + self.n_slots

    @staticmethod
    def level_span(k):
        return (4**k - 4) // 3, 4**k

    @property
    def occ_div(self):
        return max(1, self.soft_k or 1)


def calculate_lighting_at(sample_point, cell_origin, cell_coords, eye_pos, incident_light,
                          incident_light_pos, *, grid_size, roughness, material_color,
                          base_reflectivity):
    """brdf.calculate_lighting_at."""
    def dot(a, b):
        p = a * b
        return p[..., 0] + p[..., 1] + p[..., 2]

    def const(values, like):
        return device_vec(np.asarray(values, np.float32).reshape(-1), like.device)

    surface_normal = cube_face_normal(sample_point, cell_origin)
    material = np.asarray(material_color, np.float32)
    if (material != 0.0).any():
        albedo = const(material, sample_point).expand(sample_point.shape)
    else:
        c = cell_coords.to(FLOAT)
        c = c / torch.full_like(c, float(grid_size))
        albedo = torch.stack([c[..., 0], c[..., 1], 1.0 - c[..., 0]], dim=-1)
    view_dir = normalize(eye_pos - sample_point)
    light_dir = normalize(incident_light_pos - sample_point)
    halfway = normalize(light_dir + view_dir)
    f_l = albedo / torch.full_like(albedo, BRDF_PI)
    r = np.float32(roughness)
    a2 = r * r
    noh = dot(surface_normal, halfway)
    fn = noh * noh * float(a2 - np.float32(1.0)) + 1.0
    d = torch.full_like(fn, float(a2)) / (fn * BRDF_PI * fn)
    nn = np.float32(roughness) + np.float32(1.0)
    k_direct = (nn * nn) / np.float32(8.0)

    def schlick(direction):
        nov = torch.clamp(dot(surface_normal, direction), min=0.0)
        return nov / (nov * float(np.float32(1.0) - k_direct) + float(k_direct))

    g = schlick(view_dir) * schlick(light_dir)
    p1 = 1.0 - dot(halfway, view_dir)
    p2 = p1 * p1
    p5 = p1 * (p2 * p2)
    base = np.asarray(base_reflectivity, np.float32)
    fr = const(base, p5) + const(np.float32(1.0) - base, p5) * p5[..., None]
    denom = 4.0 * dot(view_dir, surface_normal) * dot(light_dir, surface_normal)
    f_ct = (d * g)[..., None] * fr / denom[..., None]
    brdf = f_l + f_ct
    lr = brdf * incident_light * dot(light_dir, surface_normal)[..., None]
    return torch.clamp(lr, min=0.0)


def _shader(cam, n):
    return functools.partial(calculate_lighting_at, grid_size=n, roughness=cam[P_ROUGH],
                             material_color=cam[P_MATC : P_MATC + 3],
                             base_reflectivity=cam[P_REFL : P_REFL + 3])


def hit_geometry(cam, idx_img, t_img, n, width, height):
    """render_slab._hit_geometry: (q, origin, coords, found, d)."""
    dev = idx_img.device
    _, dx, dy, dz = _pixel_rays(cam, width, height, dev)
    d = torch.stack([dx, dy, dz], dim=-1)
    q = device_vec(cam[P_O : P_O + 3], dev) + d * t_img[..., None]
    coords = torch.stack([idx_img % n, (idx_img // n) % n, idx_img // (n * n)], dim=-1)
    cell = np.float32(FULL_CUBE_SIZE / n)
    origin = coords.to(FLOAT) * float(cell) + float(cell * np.float32(0.5)) - HALF_CUBE_SIZE
    return q, origin, coords, idx_img >= 0, d


def _pixel_uv(cam, width, height, device):
    win_w, win_h = float(cam[P_WIN]), float(cam[P_WIN + 1])
    px = torch.arange(width, dtype=FLOAT, device=device)[None, :].expand(height, width)
    py = torch.arange(height, dtype=FLOAT, device=device)[:, None].expand(height, width)
    ux = (px + 0.5) / torch.full_like(px, win_w)
    uy = 1.0 - (py + float(cam[P_ROW0]) + 0.5) / torch.full_like(py, win_h)
    return ux, uy


def soft_shadow_jitter(cam, kk: int, width, height, device):
    """render_slab.soft_shadow_jitter for a static sample index."""
    ux, uy = _pixel_uv(cam, width, height, device)
    t = np.float32(cam[P_TIME])
    base = float(np.float32(0.07) * (t - np.floor(t)))
    consts = [float(c) for c in (np.float32(0.17 * kk + 0.05), np.float32(0.29 * kk + 0.11),
                                 np.float32(0.41 * kk + 0.23))]

    def j1(cst):
        ax = (ux + base) + cst
        ay = (uy + base) + cst
        arg = ax * 12.9898 + ay * 78.233
        v = torch.sin(arg.to(torch.float64)).to(FLOAT) * 43758.5453
        return (v - torch.floor(v)) - 0.5

    rad2 = float(np.float32(2.0) * np.float32(cam[P_LRAD]))
    return torch.stack([j1(c) for c in consts], dim=-1) * rad2


def _slot_geometry(cam, n, point, pcoords, off, active):
    cell = np.float32(FULL_CUBE_SIZE / n)
    n_coords = pcoords + off
    n_cl = torch.clamp(n_coords, min=0)
    n_origin = (n_coords.to(FLOAT) * float(cell) + float(cell * np.float32(0.5))
                - HALF_CUBE_SIZE)
    n_dir = off.to(FLOAT)
    t_near, t_far = ray_cube_intersect(point, n_dir, n_origin, cell_half(cam, n))
    ok = active & (t_near <= t_far) & (t_far >= 0.0)
    n_point = point + n_dir * t_near[..., None]
    return n_cl, n_origin, n_point, ok


def _gi_slots(cam, n, q, origin, coords, found):
    layers = torch.from_numpy(INDIRECT_LAYERS).to(q.device)
    face = face_index(cube_face_normal(q, origin))
    offs = [layers[:, i, :][face] for i in range(4)]
    return [_slot_geometry(cam, n, q, coords, off, found) for off in offs]


def _stack3(vectors, shape):
    return torch.stack([torch.broadcast_to(v, shape).movedim(-1, 0) for v in vectors])


def lighting_queries_stacked(cam, idx, t, light: Lighting, *, grid_size, width, height):
    """The occlusion operands (start, target, excl, active) of a frame."""
    n = grid_size
    q, origin, coords, found, _ = hit_geometry(cam, idx, t, n, width, height)
    lpos = device_vec(cam[P_LIGHT : P_LIGHT + 3], q.device)
    queries = []
    if light.soft_k is not None:
        for kk in range(max(1, light.soft_k)):
            target = lpos
            if light.soft_k > 1:
                target = lpos + soft_shadow_jitter(cam, kk, width, height, q.device)
            queries.append((q, target, coords, found))
    if light.gi:
        for n_cl, _, n_point, ok in _gi_slots(cam, n, q, origin, coords, found):
            queries.append((n_point, lpos, n_cl, ok))
    shape = (height, width, 3)
    ops = (_stack3([x[0] for x in queries], shape), _stack3([x[1] for x in queries], shape),
           _stack3([x[2] for x in queries], shape).to(torch.int32),
           torch.stack([x[3] for x in queries]))
    deeper = light.nq - len(queries)
    if deeper:
        ops = tuple(torch.cat([op, op.new_zeros((deeper, *op.shape[1:]))]) for op in ops)
    return ops


def cell_state(vol, coords, active, *, grid_size):
    """The plain K3."""
    n = grid_size
    x, y, z = (torch.clamp(coords, min=0) % n).unbind(1)
    word = vol.reshape(-1)[(((x >> 5) * n + z) * n + y).long()]
    return torch.where(active, (word >> (x & 31)) & 1, 0).to(torch.uint8)


def shadow_sweep(vol, start, target, excl, active, *, grid_size, half):
    """The plain K2: occluded flags int32 [nq, H, W]."""
    def exit_t(s, d):
        return torch.maximum((-0.5 - s) / d, (0.5 - s) / d)

    sx, sy, sz = start.unbind(1)
    tx, ty, tz = target.unbind(1)
    dx, dy, dz = _normalize3(tx - sx, ty - sy, tz - sz)
    t1 = torch.minimum(torch.minimum(exit_t(sx, dx), exit_t(sy, dy)), exit_t(sz, dz))
    occluded = _sweep(vol.reshape(-1), grid_size, half, (sx, sy, sz), (dx, dy, dz),
                      torch.zeros_like(t1), t1, active, exclude=tuple(excl.unbind(1)))[0]
    return occluded.to(torch.int32)


def _slot_tree(cam, n, geo, states, levels):
    q, origin, coords, found = geo[:4]
    tree = []
    parents = [(coords, origin, q, found)]
    for k in range(1, levels + 1):
        r0, _ = Lighting.level_span(k)
        level = []
        for pcl, porigin, ppoint, pok in parents:
            level += _gi_slots(cam, n, ppoint, porigin, pcl, pok)
        level = [(cl, org, pt, ok & (states[r0 + s] == 1))
                 for s, (cl, org, pt, ok) in enumerate(level)]
        tree.append(level)
        parents = level
    return tree


def lighting_level_stacked(cam, idx, t, ops, states, light: Lighting, level, *, grid_size,
                           width, height):
    n = grid_size
    start, target, excl, active = ops
    geo = hit_geometry(cam, idx, t, n, width, height)
    parents = _slot_tree(cam, n, geo, states, level - 1)[-1]
    base = light.n_soft + Lighting.level_span(level - 1)[0]
    for s, (_, _, _, ok) in enumerate(parents):
        active[base + s] = ok
    lpos = device_vec(cam[P_LIGHT : P_LIGHT + 3], idx.device)[:, None, None]
    base = light.n_soft + Lighting.level_span(level)[0]
    for s, (pcl, porigin, ppoint, pok) in enumerate(parents):
        for j, (n_cl, _, n_point, ok_geo) in enumerate(
                _gi_slots(cam, n, ppoint, porigin, pcl, pok)):
            row = base + 4 * s + j
            start[row] = n_point.movedim(-1, 0)
            target[row] = lpos
            excl[row] = n_cl.movedim(-1, 0)
            active[row] = ok_geo
    return ops


def gi_states(cam, idx, t, ops, vol, light: Lighting, *, grid_size, width, height):
    _, _, excl, active = ops
    cells, masks = excl[light.n_soft:], active[light.n_soft:]
    if light.bounces == 1:
        return cell_state(vol, cells, masks, grid_size=grid_size)
    states = torch.empty((light.n_slots, height, width), dtype=torch.uint8, device=idx.device)
    for k in range(1, light.bounces + 1):
        r0, rows = Lighting.level_span(k)
        cells, masks = excl[light.n_soft:], active[light.n_soft:]
        states[r0 : r0 + rows] = cell_state(vol, cells[r0 : r0 + rows], masks[r0 : r0 + rows],
                                            grid_size=grid_size)
        if k < light.bounces:
            lighting_level_stacked(cam, idx, t, ops, states, light, k + 1, grid_size=grid_size,
                                   width=width, height=height)
    return states


def _occlusion_quotient(occluded):
    return torch.where(occluded, OCCLUDED, 1.0)


def _soft_occlusion(occs, div):
    occ_sum = torch.zeros(occs[0].shape, dtype=FLOAT, device=occs[0].device)
    for occluded in occs:
        occ_sum = occ_sum + _occlusion_quotient(occluded)
    return occ_sum / torch.full_like(occ_sum, float(div))


def _gi_light(cam, n, geo, gi_flags, states, light: Lighting):
    q, origin, coords, found = geo[:4]
    dev = q.device
    lpos = device_vec(cam[P_LIGHT : P_LIGHT + 3], dev)
    o = device_vec(cam[P_O : P_O + 3], dev)
    lmag3 = torch.full_like(q, float(cam[P_LMAG]))
    emis = device_vec(cam[P_EMIS : P_EMIS + 3] * cam[P_EMISS], dev)
    shade = _shader(cam, n)
    tree = _slot_tree(cam, n, geo, states, light.bounces)
    parents = [[(q, origin, coords, o)]]
    for k in range(1, light.bounces):
        parents.append([(pt, org, cl, parents[k - 1][s // 4][0])
                        for s, (cl, org, pt, _) in enumerate(tree[k - 1])])
    sums = None
    for k in range(light.bounces, 0, -1):
        r0, _ = Lighting.level_span(k)
        level_sums = []
        for p, (ppoint, porigin, pcl, viewer) in enumerate(parents[k - 1]):
            total = torch.zeros_like(q)
            for j in range(4):
                s = 4 * p + j
                n_cl, n_origin, n_point, ok = tree[k - 1][s]
                reflected = _occlusion_quotient(gi_flags[r0 + s] == 1)[..., None] * shade(
                    n_point, n_origin, n_cl, ppoint, lmag3, lpos)
                reflected = reflected + emis
                if sums is not None:
                    reflected = reflected + sums[s]
                bounce = shade(ppoint, porigin, pcl, viewer, reflected, n_point)
                total = total + torch.where(ok[..., None], bounce, 0.0)
            level_sums.append(total)
        sums = level_sums
    return sums[0]


def _miss_depth(cam, d):
    """render_slab._miss_depth: the volume exit depth [H, W] of the rays
    along ``d`` that cross the volume, 0 elsewhere."""
    o = np.asarray(cam[P_O : P_O + 3], np.float32)
    t1 = torch.stack([torch.full_like(d[..., i], float(np.float32(-0.5) - o[i])) / d[..., i]
                      for i in range(3)], dim=-1)
    t2 = torch.stack([torch.full_like(d[..., i], float(np.float32(0.5) - o[i])) / d[..., i]
                      for i in range(3)], dim=-1)
    tf = torch.amin(torch.maximum(t1, t2), dim=-1)
    tn = torch.amax(torch.minimum(t1, t2), dim=-1)
    crossed = (tn <= tf) & (tf >= 0.0)
    return torch.where(crossed, tf, 0.0)


def lighting_passes(cam, idx, t, vol, light: Lighting, rgb, *, grid_size, width, height,
                    age=None, total_states=2):
    """render_slab.lighting_passes: queries, the GI tree's states, the plain
    K2 on every query, the shade twin.  On K1's frame ``rgb`` (unshadowed,
    or hard-shadowed under GI alone) returns the frame's light [H, W, 3]
    with the emissive light.  With ``rgb`` None (the sliced frame, ``t``
    K4's) the direct light is computed here, faded by the hit's ``age``
    where given, black on misses: returns (light, depth), the depth t on
    hits and the volume's exit elsewhere."""
    n = grid_size
    ops = lighting_queries_stacked(cam, idx, t, light, grid_size=n, width=width, height=height)
    kw = dict(grid_size=n, width=width, height=height)
    states = None
    deep = light.n_slots > 0 and light.bounces > 1
    if deep:
        states = gi_states(cam, idx, t, ops, vol, light, **kw)
    flags = shadow_sweep(vol, *ops, grid_size=n, half=cell_half(cam, n))
    if light.n_slots and not deep:
        states = gi_states(cam, idx, t, ops, vol, light, **kw)
    del ops
    geo = hit_geometry(cam, idx, t, n, width, height)
    n_soft = light.n_soft
    occl = _soft_occlusion(list(flags[:n_soft] == 1), light.occ_div) if n_soft else None
    gi_rgb = _gi_light(cam, n, geo, flags[n_soft:], states, light) if light.gi else None
    q, origin, coords, found, d = geo
    if rgb is None:
        dev = q.device
        lpos = device_vec(cam[P_LIGHT : P_LIGHT + 3], dev)
        o = device_vec(cam[P_O : P_O + 3], dev)
        color = _shader(cam, n)(q, origin, coords, o, torch.full_like(q, float(cam[P_LMAG])),
                                lpos)
        out = torch.clamp(color, min=0.0)
        if age is not None:
            fade = age_fade(age, total_states)
            occl = fade if occl is None else occl * fade
        if occl is not None:
            out = out * occl[..., None]
        if gi_rgb is not None:
            out = out + gi_rgb
        out = torch.where(found[..., None], out, 0.0)
        depth = torch.where(found, t, _miss_depth(cam, d))
    else:
        out = rgb
        if occl is not None:
            out = out * occl[..., None]
        if gi_rgb is not None:
            out = out + torch.where(found[..., None], gi_rgb, 0.0)
    emis = device_vec(cam[P_EMIS : P_EMIS + 3] * cam[P_EMISS], q.device)
    out = torch.where(found[..., None], out + emis, out)
    return out if rgb is not None else (out, depth)


def sliced_trace(vol, cam, light: Lighting, ages=None, *, grid_size, width, height,
                 total_states=2):
    """render_slab.raytrace_sliced: the plain K4 (every pixel's primary hit:
    the visible cube's entry t, 0 on a miss, the id, with ``ages`` the hit's
    age), then :func:`lighting_passes` without K1's frame.  Returns (light
    [H, W, 3] with the emissive light, depth, ids)."""
    cam = np.ascontiguousarray(cam, dtype=np.float32)
    n = grid_size
    *_, (found, t_hit, hx, hy, hz) = _primary(vol.reshape(-1), cam, n, cell_half(cam, n), width,
                                              height, vol.device)
    idx = torch.where(found, hx + hy * n + hz * (n * n), -1).to(torch.int32)
    age = None if ages is None else _hit_ages(ages, n, found, hx, hy, hz)
    rgb, depth = lighting_passes(cam, idx, t_hit, vol, light, None, grid_size=n, width=width,
                                 height=height, age=age, total_states=total_states)
    return rgb, depth, idx


# ------------------------------------------------------- composition ---


def _window_rays(w, h, view, device):
    xs = torch.arange(w, dtype=FLOAT, device=device) + 0.5
    ys = torch.arange(h, dtype=FLOAT, device=device) + 0.5
    xs = xs / torch.full_like(xs, w)
    ys = 1.0 - ys / torch.full_like(ys, h)
    v, u = torch.meshgrid(ys, xs, indexing="ij")
    r = float(np.float32(w) / np.float32(h))
    rx = (u - 0.5) * r
    ry = v - 0.5
    rz = torch.full_like(rx, -float(np.float32(0.5) * COT_HALF_FOV))
    norm = torch.sqrt(rx * rx + ry * ry + rz * rz)
    rx, ry, rz = rx / norm, ry / norm, rz / norm
    d = tuple(rx * float(view[i, 0]) + ry * float(view[i, 1]) + rz * float(view[i, 2])
              for i in range(3))
    return u, d


def ema(rgb, prev, same, alpha):
    mixed = torch.clamp(prev + (rgb - prev) * float(np.float32(alpha)), 0.0, 1.0)
    return torch.where(same[..., None], mixed, rgb)


def _reprojected_uv(prev_proj_view, p):
    m = np.asarray(prev_proj_view, np.float32)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]

    def row(i):
        return x * float(m[i, 0]) + y * float(m[i, 1]) + z * float(m[i, 2]) + float(m[i, 3])

    w = row(3)
    return torch.stack([row(0) / w * 0.5 + 0.5, -(row(1) / w) * 0.5 + 0.5], dim=-1)


def compose_frame(hist_color, hist_idx, rgb, depth, idx, p: Params, w, h, camera_static):
    """renderer_fast.compose_frame (one window, row 0): (presentation f32,
    new history colour f16)."""
    view = np.asarray(p.view_mat, np.float32)
    ux, d = _window_rays(w, h, view, rgb.device)
    if camera_static:
        prev = hist_color.to(FLOAT)
        out = ema(rgb, prev, (idx == hist_idx) & (idx >= 0), p.temporal_alpha)
    else:
        hit = torch.stack([float(view[i, 3]) + d[i] * depth for i in range(3)], dim=-1)
        uv_r = _reprojected_uv(p.prev_proj_view, hit)
        rx, ry = uv_r[..., 0], uv_r[..., 1]
        in_bounds = (rx >= 0.0) & (rx <= 1.0) & (ry >= 0.0) & (ry <= 1.0)
        rx = torch.where(in_bounds, rx, 0.0)
        ry = torch.where(in_bounds, ry, 0.0)
        px = (rx * w).to(torch.int32).clamp(0, w - 1)
        py_g = (ry * h).to(torch.int32)
        in_bounds = in_bounds & (py_g >= 0) & (py_g < h)
        flat = py_g.clamp(0, h - 1).to(torch.int64) * w + px
        prev = hist_color.reshape(-1, 3)[flat].to(FLOAT)
        prev_idx = hist_idx.reshape(-1)[flat]
        valid = in_bounds & (idx >= 0) & (prev_idx == idx)
        out = ema(rgb, prev, valid, p.temporal_alpha)
    lt_near, lt_far = ray_cube_intersect(device_vec(view[:3, 3], rgb.device),
                                         torch.stack(d, dim=-1),
                                         device_vec(p.light_pos, rgb.device),
                                         float(np.float32(0.005)))
    light_hit = (lt_near <= lt_far) & (lt_far >= 0.0)
    black = (out == 0.0).all(dim=-1)
    out = torch.where((light_hit & black)[..., None], 1.0, out)
    color = out
    if float(p.show_depth_overlay) == 1.0:
        overlay = torch.stack([depth, torch.zeros_like(depth), torch.zeros_like(depth)], dim=-1)
        out = torch.where((ux < 0.5)[..., None], overlay, out)
    pres = torch.pow(out, float(np.float32(1.0) / np.float32(p.gamma)))
    return pres, color.to(torch.float16)
