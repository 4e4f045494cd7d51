"""Fast path: the fused frame kernel K1 (plane-midpoint DDA + shading).

Port of ``cellularautomatons3d_tpu.render.render_fast`` for grids ≤ 256³.
Per pixel: camera ray, volume slab entry/exit, the primary sweep, the
hard-shadow sweep toward the light (start cell excluded), Cook-Torrance
shading with position albedo; in compose mode also emissive light, the
cell-id-checked temporal EMA, the light cube, the new history, the depth
overlay and gamma.

Two implementations with one contract:

* :func:`raytrace` -- plain torch, vectorized over pixels with a loop over
  z-planes; no skip structure.  It runs for CPU tensors and is the CUDA
  kernel's reference.
* :func:`raytrace_cuda` -- the hand-written kernel ``csrc/render_fast.cu``
  (one thread per pixel, coarse-mip column skipping).

:func:`raytrace_tiles` picks by the volume's device, like the JAX wrapper
of the same name; the TPU's tile-blocked pixel layout does not come across,
so images are ``[H, W]`` / ``[H, W, 3]`` in image order.

Traversal semantics (the written spec is ``oracle_dda`` in
tests/test_render_fast.py): a +z pass for dz > 0 and a −z pass for dz < 0
(rays with dz == 0 never hit), one probe per z-plane at the midpoint of the
ray's segment in it, the visible-cube accept rules, first hit in plane
order.  Every float expression keeps the JAX kernel's operation order, and
min/max propagate NaN.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

__all__ = [
    "raytrace_tiles",
    "raytrace",
    "raytrace_cuda",
    "P_LEN",
    "pack_cam",
]

# cam/params vector layout (f32), as in the JAX package.
P_R00 = 0       # view rotation, row-major 3x3 (camera→world)
P_O = 9         # camera origin xyz
P_WIN = 12      # window w, h
P_LIGHT = 14    # light pos xyz
P_LMAG = 17     # light magnitude
P_CELLMUL = 18  # visible-cube fraction (uCellSize)
P_ROUGH = 19
P_REFL = 20     # base reflectivity rgb
P_MATC = 23     # material color rgb
P_LRAD = 26     # area-light radius (soft shadows)
P_EMIS = 27     # emissive color rgb
P_EMISS = 30    # emissive strength
P_TIME = 31     # elapsed time (jitter RNG seed)
P_ROW0 = 32     # global row of this shard's first pixel row (mesh render)
P_ALPHA = 33    # temporal EMA alpha (in-kernel composition)
P_GAMMA = 34    # gamma (presentation = pow(light, 1/gamma))
P_OVERLAY = 35  # 1.0 = left-half depth debug overlay
P_LEN = 40

COT_HALF_FOV = 1.3032254  # 1/tan(37.5°), wgsl:69
PI = 3.14159265359
OCCLUDED = 0.0095         # blocked-shadow quotient (wgsl:635-680)
MAX_GRID = 256


def pack_cam(view_mat, width, height, light_pos, light_magnitude, cell_size,
             roughness, base_reflectivity, material_color,
             light_radius=0.0, emissive_color=(0.0, 0.0, 0.0),
             emissive_strength=0.0, elapsed_time=0.0, row0=0.0,
             temporal_alpha=0.1, gamma=2.0, show_overlay=0.0):
    """Host-side packing of the kernel's parameter vector (numpy f32)."""
    cam = np.zeros((P_LEN,), np.float32)
    cam[P_R00 : P_R00 + 9] = np.asarray(view_mat, np.float32)[:3, :3].reshape(-1)
    cam[P_O : P_O + 3] = np.asarray(view_mat, np.float32)[:3, 3]
    cam[P_WIN : P_WIN + 2] = (width, height)
    cam[P_LIGHT : P_LIGHT + 3] = light_pos
    cam[P_LMAG] = light_magnitude
    cam[P_CELLMUL] = cell_size
    cam[P_ROUGH] = roughness
    cam[P_REFL : P_REFL + 3] = base_reflectivity
    cam[P_MATC : P_MATC + 3] = material_color
    cam[P_LRAD] = light_radius
    cam[P_EMIS : P_EMIS + 3] = emissive_color
    cam[P_EMISS] = emissive_strength
    cam[P_TIME] = elapsed_time
    cam[P_ROW0] = row0
    cam[P_ALPHA] = temporal_alpha
    cam[P_GAMMA] = gamma
    cam[P_OVERLAY] = show_overlay
    return cam


def _check_args(grid_size, width, height, cam):
    if grid_size > MAX_GRID:
        raise NotImplementedError(
            f"grid_size {grid_size} > {MAX_GRID} is not ported yet "
            "(ROADMAP.md queue 1, item 7)"
        )
    if grid_size < 32 or grid_size % 32:
        raise ValueError(f"grid_size must be a multiple of 32, got {grid_size}")
    if width < 1 or height < 1:
        raise ValueError(f"bad window {width}x{height}")
    cam = np.ascontiguousarray(cam, dtype=np.float32)
    if cam.shape != (P_LEN,):
        raise ValueError(f"cam must be float32[{P_LEN}], got shape {cam.shape}")
    return cam


# --------------------------------------------------------------- plain ---


def _normalize3(x, y, z):
    inv = 1.0 / torch.sqrt(x * x + y * y + z * z)
    return x * inv, y * inv, z * inv


def _vol_slab(o, d):
    inv = 1.0 / d
    t1 = (-0.5 - o) * inv
    t2 = (0.5 - o) * inv
    return torch.minimum(t1, t2), torch.maximum(t1, t2)


def _box(c, h, o, inv):
    """Per-axis slab times of the box [c - h, c + h] (min, max)."""
    t1 = (c - h - o) * inv
    t2 = (c + h - o) * inv
    return torch.minimum(t1, t2), torch.maximum(t1, t2)


def _pixel_rays(cam, width, height, device):
    """(ux, dx, dy, dz) per pixel: render_fast.py pixel_rays."""
    f = lambda i: float(cam[i])  # noqa: E731  (exact f32 values)
    win_w, win_h = cam[P_WIN], cam[P_WIN + 1]
    py = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    px = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    py, px = py.expand(height, width), px.expand(height, width)
    # Divide by tensors: CUDA torch turns division by a Python scalar into
    # a multiply by its reciprocal, which is not IEEE division.
    ux = (px + 0.5) / torch.full_like(px, float(win_w))
    uy = 1.0 - (py + f(P_ROW0) + 0.5) / torch.full_like(py, float(win_h))
    rx = (ux - 0.5) * float(win_w / win_h)
    ry = uy - 0.5
    rz = torch.full_like(rx, -0.5 * COT_HALF_FOV)
    rx, ry, rz = _normalize3(rx, ry, rz)
    dx = f(0) * rx + f(1) * ry + f(2) * rz
    dy = f(3) * rx + f(4) * ry + f(5) * rz
    dz = f(6) * rx + f(7) * ry + f(8) * rz
    return ux, dx, dy, dz


def _sweep(vol_flat, n, cell_half, o, d, t_start, t_end, active, exclude=None):
    """One plane-midpoint sweep over every z-plane, all pixels at once.

    ``exclude`` is None for the primary sweep (accept tN ≤ tF ∧ tF ≥
    t_start); for the shadow sweep it is the start cell (hx, hy, hz),
    skipped component-wise, and the accept rule is tN ≤ tF ∧ tN ≥ 0.
    Returns (found, t, hx, hy, hz)."""
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
        gzf = kk.to(torch.float32)
        ta = (gzf * inv_n - 0.5 - oz) * inv_dz
        tb = ((gzf + 1.0) * inv_n - 0.5 - oz) * inv_dz
        lo = torch.maximum(torch.minimum(ta, tb), t_start)
        hi = torch.minimum(torch.maximum(ta, tb), t_end)
        seg_ok = (lo < hi) & ~found & pass_active
        tm = 0.5 * (lo + hi)
        cxf = torch.clamp(torch.floor((ox + tm * dx + 0.5) * n), 0, n - 1)
        cyf = torch.clamp(torch.floor((oy + tm * dy + 0.5) * n), 0, n - 1)
        # Only seg_ok lanes may depend on the (possibly non-finite) probe.
        cx = torch.where(seg_ok, cxf, 0.0).to(torch.int32)
        cy = torch.where(seg_ok, cyf, 0.0).to(torch.int32)
        word = vol_flat[((cx >> 5) * (n * n) + kk * n + cy).long()]
        cand = seg_ok & (((word >> (cx & 31)) & 1) == 1)
        if exclude is not None:
            cand = cand & ~(
                (cx == exclude[0]) & (cy == exclude[1]) & (kk == exclude[2])
            )
        ccx = (cx.to(torch.float32) + 0.5) * inv_n - 0.5
        ccy = (cy.to(torch.float32) + 0.5) * inv_n - 0.5
        ccz = (gzf + 0.5) * inv_n - 0.5
        nx_, fx_ = _box(ccx, cell_half, ox, inv_dx)
        ny_, fy_ = _box(ccy, cell_half, oy, inv_dy)
        nz_, fz_ = _box(ccz, cell_half, oz, inv_dz)
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
    """Cook-Torrance direct lighting (wgsl:537-633), render_fast.shade."""
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
        nol_c / (nol_c * float(np.float32(1.0) - np.float32(kd)) + kd)
    )
    hv = hwx * vx + hwy * vy + hwz * vz
    p1 = 1.0 - hv
    p2 = p1 * p1
    p5 = p1 * (p2 * p2)  # lax.integer_pow(x, 5) order
    denom = 4.0 * (vx * nxn + vy * nyn + vz * nzn) * (ldx * nxn + ldy * nyn + ldz * nzn)
    nol = ldx * nxn + ldy * nyn + ldz * nzn  # un-clamped (wgsl:623)
    spec = dterm * gterm / denom
    lm = f(P_LMAG)
    out = []
    for c in range(3):
        refl = cam[P_REFL + c]
        fres = float(refl) + float(np.float32(1.0) - refl) * p5
        alb = albedo[c] / torch.full_like(spec, PI)
        out.append(torch.clamp((alb + spec * fres) * lm * nol, min=0.0))
    return out


def raytrace(vol, coarse, cam, history=None, *, grid_size, width, height,
             shadow=True):
    """Plain torch K1 (the kernel's reference; ``coarse`` is unused).

    Without ``history``: returns (rgb [H,W,3] linear light, depth [H,W],
    idx [H,W] int32; -1 = miss).  With ``history = (color [H,W,3] f32,
    hit_idx [H,W] int32)``: composes the frame and returns (presentation
    [H,W,3], depth, idx, new history color [H,W,3] f32)."""
    cam = _check_args(grid_size, width, height, cam)
    n = grid_size
    dev = vol.device
    f = lambda i: float(cam[i])  # noqa: E731
    vol_flat = vol.reshape(-1)
    inv_n = float(np.float32(1.0 / n))
    cell_half = float(np.float32(inv_n) * cam[P_CELLMUL] * np.float32(0.5))

    ux, dx, dy, dz = _pixel_rays(cam, width, height, dev)
    ox = torch.full_like(dx, f(P_O))
    oy = torch.full_like(dx, f(P_O + 1))
    oz = torch.full_like(dx, f(P_O + 2))
    nx_, fx_ = _vol_slab(ox, dx)
    ny_, fy_ = _vol_slab(oy, dy)
    nz_, fz_ = _vol_slab(oz, dz)
    tn = torch.maximum(torch.maximum(nx_, ny_), nz_)
    tf = torch.minimum(torch.minimum(fx_, fy_), fz_)
    active = (tn <= tf) & (tf >= 0.0)
    t_start = torch.clamp(tn, min=0.0)
    found, t_hit, hx, hy, hz = _sweep(
        vol_flat, n, cell_half, (ox, oy, oz), (dx, dy, dz), t_start, tf, active
    )
    depth = torch.where(found, t_hit, torch.where(active, tf, 0.0))
    idx = torch.where(found, hx + hy * n + hz * (n * n), -1).to(torch.int32)

    qx, qy, qz = ox + t_hit * dx, oy + t_hit * dy, oz + t_hit * dz
    occl = torch.ones_like(dx)
    if shadow:
        sdx, sdy, sdz = _normalize3(f(P_LIGHT) - qx, f(P_LIGHT + 1) - qy, f(P_LIGHT + 2) - qz)
        sh_tf = torch.minimum(
            torch.minimum(_vol_slab(qx, sdx)[1], _vol_slab(qy, sdy)[1]),
            _vol_slab(qz, sdz)[1],
        )
        occluded = _sweep(
            vol_flat, n, cell_half, (qx, qy, qz), (sdx, sdy, sdz),
            torch.zeros_like(sh_tf), sh_tf, found, exclude=(hx, hy, hz),
        )[0]
        occl = torch.where(occluded, OCCLUDED, 1.0)
    co = [(h.to(torch.float32) + 0.5) * inv_n - 0.5 for h in (hx, hy, hz)]
    if (cam[P_MATC : P_MATC + 3] != 0).any():
        albedo = [torch.full_like(dx, f(P_MATC + c)) for c in range(3)]
    else:
        cxn = hx.to(torch.float32) * inv_n
        albedo = [cxn, hy.to(torch.float32) * inv_n, 1.0 - cxn]
    lit = _shade(cam, (qx, qy, qz), co, albedo, (ox, oy, oz))
    rgb = [torch.where(found, c * occl, 0.0) for c in lit]
    if history is None:
        return torch.stack(rgb, dim=-1), depth, idx

    # ---- frame composition (render_frame_fast semantics) ----
    prev, prev_idx = history
    emis_s = cam[P_EMISS]
    rgb = [
        torch.where(found, rgb[c] + float(cam[P_EMIS + c] * emis_s), rgb[c])
        for c in range(3)
    ]
    same = (idx == prev_idx) & found
    alpha = f(P_ALPHA)
    light = []
    for c in range(3):
        p = prev[..., c]
        light.append(torch.where(same, torch.clamp(p + (rgb[c] - p) * alpha, 0.0, 1.0), rgb[c]))
    lrad = np.float32(0.005)
    ln = []
    lf = []
    for c, (o, d) in enumerate(((ox, dx), (oy, dy), (oz, dz))):
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
    overlay = (ux < 0.5) & bool(cam[P_OVERLAY] == 1.0)
    base = [
        torch.where(overlay, depth, light[0]),
        torch.where(overlay, 0.0, light[1]),
        torch.where(overlay, 0.0, light[2]),
    ]
    inv_g = float(np.float32(1.0) / cam[P_GAMMA])
    pres = torch.stack([torch.pow(b, inv_g) for b in base], dim=-1)
    return pres, depth, idx, new_hist


# ---------------------------------------------------------------- CUDA ---


def raytrace_cuda(vol, coarse, cam, history=None, *, grid_size, width, height,
                  shadow=True):
    """K1 on the card (``csrc/render_fast.cu``): same contract as
    :func:`raytrace`; every tensor must be a contiguous CUDA tensor."""
    cam = _check_args(grid_size, width, height, cam)
    n = grid_size
    kernels.require(vol, "vol", torch.int32, (n // 32, n, n))
    kernels.require(coarse, "coarse", torch.int32, (n // 8, n // 8))
    lib = kernels.library()
    dev = vol.device
    out_rgb = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    idx = torch.empty((height, width), dtype=torch.int32, device=dev)
    if history is not None:
        prev, prev_idx = history
        kernels.require(prev, "history color", torch.float32, (height, width, 3))
        kernels.require(prev_idx, "history ids", torch.int32, (height, width))
        new_hist = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
        ptrs = (prev.data_ptr(), prev_idx.data_ptr(), new_hist.data_ptr())
    else:
        ptrs = (None, None, None)
    err = lib.ca3d_render_fast(
        dev.index or 0, vol.data_ptr(), coarse.data_ptr(), n, width, height,
        cam.ctypes.data, int(shadow), int(history is not None),
        ptrs[0], ptrs[1], out_rgb.data_ptr(), depth.data_ptr(),
        idx.data_ptr(), ptrs[2], kernels.stream_of(vol),
    )
    kernels.check(err, "render_fast")
    raytrace_cuda.launches += 1
    if history is None:
        return out_rgb, depth, idx
    return out_rgb, depth, idx, new_hist


raytrace_cuda.launches = 0


def raytrace_tiles(vol, coarse, cam, history=None, *, grid_size, width,
                   height, shadow=True):
    """Trace (and with ``history``, compose) one frame: the plain version
    for a CPU volume, the CUDA kernel for any other."""
    fn = raytrace if vol.device.type == "cpu" else raytrace_cuda
    return fn(vol, coarse, cam, history, grid_size=grid_size, width=width,
              height=height, shadow=shadow)
