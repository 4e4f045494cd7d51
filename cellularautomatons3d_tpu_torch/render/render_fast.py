"""Fast path: the fused frame kernel K1 (plane-midpoint DDA + shading).

Port of ``cellularautomatons3d_tpu.render.render_fast`` for grids ≤ 256³
(larger grids render through ``render_slab.raytrace_sliced``, whose
primary pass K4 reuses this module's plain sweep).  Per pixel: camera
ray, volume slab entry/exit, the primary sweep, the
hard-shadow sweep toward the light (start cell excluded), Cook-Torrance
shading with position albedo; in compose mode also emissive light, the
cell-id-checked temporal EMA, the light cube, the new history, the depth
overlay and gamma.  For a multi-state rule ``vol`` is the visibility plane
(age ≥ 1) and ``ages`` the age bit-planes: the hit cell's age is fetched
from them and dims the direct term by ``clip((S − age)/(S − 1), 0, 1)``;
the emissive term is neither shadowed nor faded.

Two implementations with one contract:

* :func:`raytrace` -- plain torch, vectorized over pixels with a loop over
  z-planes; no skip structure.  It runs for CPU tensors and is the CUDA
  kernel's reference.
* :func:`raytrace_cuda` -- the hand-written kernel ``csrc/render_fast.cu``
  (one thread per pixel, coarse-mip column skipping).

:func:`raytrace_tiles` picks by the volume's device, like the JAX wrapper
of the same name; the TPU's tile-blocked pixel layout does not come across,
so images are ``[H, W]`` / ``[H, W, 3]`` in image order.

The opt-in patch prepass (``raytrace_tiles(use_prepass=True)``, kernel K6)
gives each 8×8-pixel patch a mask of the 8-plane columns its rays may hit,
from the coarse mip dilated twice (``ops.occupancy.dilate_occupancy``); K1
then gates its primary sweep's columns by the mask of the pixel's patch
instead of the mip.  The Engine never sets it, as in the reference.  On
the card the prepass frame is one launch: K1 computes its blocks' masks
itself (:func:`raytrace_cuda` with ``prepass=True``; a group of lanes per
patch, the undilated mip dilated on read, ``csrc/prepass.cuh``).  The same device
function runs alone as :func:`prepass_cuda` (``csrc/prepass.cu``), which
gives the masks as a tensor (``colmask``).  On the CPU the frame runs the
two plain dilations, the plain :func:`prepass` and the plain K1 with
``colmask``; :func:`prepass_columns` is the plain twin of the card's
per-column formulation.  Pixel (px, py) reads its mask at ``[py // 8, px // 8]``: the
reference's upsampling to a tile-blocked image does not come across.  The
masks cover a patch only while its rays spread by at most ``_PRE_DEV`` per
unit t, which holds from ~1014 window rows up (1080p); on a smaller window
:func:`mask_gate_forced` is true and the gate descends every column (the
reference's tile-wide descent hides this; a per-pixel gate does not).

The reference's three opt-in traversal options, each exact (every frame
equals the default's), are read by :func:`raytrace_tiles` from the
environment at every call, as the reference reads them at trace time, so
the Engine, the fused loop and the viewer follow them without a restart:

* ``CA3D_MIP1=1``: each probe of a descended column first tests its
  1×8×8 block in the plane mip (``ops.occupancy.plane_occupancy``) and
  fetches the fine word only where that block is occupied; both sweeps.
  The reference probes one unclamped midpoint block per lane group and so
  reads the mip dilated in x and y; a thread here tests its probe's own
  clamped cell, so the kernel and the twin read the undilated mip.
* ``CA3D_SLICEGATE=1``: each descended column's in-segment plane words
  are loaded before any is tested, then the hit pass walks them in plane
  order (the reference gathers the column's flagged slices into a scratch,
  then consumes it); both sweeps.  It switches ``CA3D_MIP1`` off, as in
  the reference.
* ``CA3D_ALIVE_GATE=1`` needs no variable here: the reference's sticky
  any-ray-alive scalar skips a tile's later column groups once none of its
  rays is alive; a thread of K1 leaves its column loop at its own hit and a
  warp when its last live lane does, which is that gate at 32 lanes.

On the card each option is its own instantiation of K1
(:func:`raytrace_cuda` with ``mip1`` or ``slicegate``).  The plain twin
gates by the plane mip (the bit of each probe's cell); it needs no form of
the other two, since it fetches every plane's word and keeps the first hit.
:func:`raytrace_cuda` with ``column_skip=False`` runs K1 with every column
of the occupied box descended (the coarse mip reports every column
occupied), to measure what the column skip saves; no frame path sets it.

``no_sweep`` (both implementations) skips both sweeps -- nothing is hit and
nothing is shadowed, so the frame is that of an empty volume -- to time the
ray set-up, composition and stores alone (the reference's
``_debug_no_sweep``); no caller on the main path sets it.

Traversal semantics (the written spec is ``oracle_dda`` in
tests/test_render_fast.py): a +z pass for dz > 0 and a −z pass for dz < 0
(rays with dz == 0 never hit), one probe per z-plane at the midpoint of the
ray's segment in it, the visible-cube accept rules, first hit in plane
order.  Every float expression keeps the JAX kernel's operation order, and
min/max propagate NaN.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import kernels
from ..ops.occupancy import (
    dilate_occupancy, dilated_bits, plane_occupancy, plane_occupancy_cuda)

__all__ = [
    "raytrace_tiles",
    "raytrace",
    "raytrace_cuda",
    "prepass",
    "prepass_cuda",
    "prepass_columns",
    "prepass_mask",
    "mask_gate_forced",
    "descent_options",
    "PATCH",
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
PATCH = 8            # prepass patch edge (pixels)
_PRE_DEV = 0.0075    # per-unit-t bound on a patch bundle's ray deviation
_PRE_MARGIN = 0.035  # grown-box margin of the prepass ray


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


def mask_gate_forced(cam) -> bool:
    """Whether K1's prepass-mask gate must descend every column at this
    window: the prepass probes a patch's centre ray, and its covering
    argument bounds the other rays of the 8×8 patch to ``_PRE_DEV`` per unit
    t.  A pixel lies at most 3.5 pixels from the centre in x and y, a pixel
    is ``1 / win_h`` of the unnormalised ray (``rz = -0.5·cot``), and
    normalising a vector at least that long shrinks a difference by
    ``0.5·cot``: the spread is ``3.5·√2 / (win_h · 0.5·cot)``, 0.00703 at
    1080 rows, above ``_PRE_DEV`` below ~1014 rows.  Decided once per
    launch from the window in ``cam``, like the reference's per-patch
    ``far`` / ``steep`` flags."""
    spread = 3.5 * np.sqrt(2.0) / (float(cam[P_WIN + 1]) * 0.5 * COT_HALF_FOV)
    return bool(spread > _PRE_DEV)


def _check_args(grid_size, width, height, cam):
    if grid_size > MAX_GRID:
        raise ValueError(f"grid_size {grid_size} > {MAX_GRID}; larger grids "
                         "render through render_slab.raytrace_sliced")
    return _check_window(grid_size, width, height, cam)


def _check_window(grid_size, width, height, cam):
    """The checks K1 shares with the sliced path: grid shape, window, cam."""
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


def _sweep(vol_flat, n, cell_half, o, d, t_start, t_end, active, exclude=None,
           colmask=None, forced=False, mip1=None):
    """One plane-midpoint sweep over every z-plane, all pixels at once.

    ``exclude`` is None for the primary sweep (accept tN ≤ tF ∧ tF ≥
    t_start); for a shadow sweep it is the start cell (hx, hy, hz), skipped
    component-wise, or (K5) its packed id x + y·n + z·n² with −1 for none,
    and the accept rule is tN ≤ tF ∧ tN ≥ 0.  ``colmask``: the per-pixel
    prepass mask [H, W] int32; plane k is then probed only if its 8-plane
    column c = k // 8 passes K1's mask gate (a non-empty clipped column
    segment, and bit c set, a steep ray or ``forced``: see
    :func:`mask_gate_forced`).  ``mip1``: the plane mip
    (:func:`~cellularautomatons3d_tpu_torch.ops.occupancy.plane_occupancy`);
    a probe then counts only where bit (cx >> 3, cy >> 3) of its plane is
    set, (cx, cy) its own clamped cell: the mip1 descent's gate, exact on
    the undilated mip.  The slice-gated descent and the any-ray-alive gate
    need no twin: this sweep fetches every plane's word and keeps the first
    hit, which is what those descents compute.  Returns (found, t, hx, hy,
    hz)."""
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
    if colmask is not None:
        adz2 = 2.0 * dz.abs()
        steep = (dx.abs() > adz2) | (dy.abs() > adz2) | forced
    for k in range(n):
        kk = torch.where(up, k, n - 1 - k).to(torch.int32)
        gzf = kk.to(torch.float32)
        ta = (gzf * inv_n - 0.5 - oz) * inv_dz
        tb = ((gzf + 1.0) * inv_n - 0.5 - oz) * inv_dz
        lo = torch.maximum(torch.minimum(ta, tb), t_start)
        hi = torch.minimum(torch.maximum(ta, tb), t_end)
        seg_ok = (lo < hi) & ~found & pass_active
        if colmask is not None:
            c = kk >> 3
            ga = (c * 8).to(torch.float32)
            ca = (ga * inv_n - 0.5 - oz) * inv_dz
            cb = ((ga + 8.0) * inv_n - 0.5 - oz) * inv_dz
            c_lo = torch.maximum(torch.minimum(ca, cb), t_start)
            c_hi = torch.minimum(torch.maximum(ca, cb), t_end)
            bit = ((colmask >> c) & 1) == 1
            seg_ok = seg_ok & (c_lo < c_hi) & (bit | steep)
        tm = 0.5 * (lo + hi)
        cxf = torch.clamp(torch.floor((ox + tm * dx + 0.5) * n), 0, n - 1)
        cyf = torch.clamp(torch.floor((oy + tm * dy + 0.5) * n), 0, n - 1)
        # Only seg_ok lanes may depend on the (possibly non-finite) probe.
        cx = torch.where(seg_ok, cxf, 0.0).to(torch.int32)
        cy = torch.where(seg_ok, cyf, 0.0).to(torch.int32)
        word = vol_flat[((cx >> 5) * (n * n) + kk * n + cy).long()]
        cand = seg_ok & (((word >> (cx & 31)) & 1) == 1)
        if mip1 is not None:
            at = kk * mip1.shape[1] + (cx >> 8) * (n // 8) + (cy >> 3)
            block = mip1.reshape(-1)[at.long()]
            cand = cand & (((block >> ((cx >> 3) & 31)) & 1) == 1)
        if isinstance(exclude, torch.Tensor):
            cand = cand & ((cx + cy * n + kk * (n * n)) != exclude)
        elif exclude is not None:
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


def _hit_ages(ages, n, found, hx, hy, hz):
    """The age int32 [H, W] of each pixel's hit cell from the age bit-planes
    ``ages`` [B, n/32, n, n]: bit ``hx & 31`` of word ``[b, hx >> 5, hz,
    hy]`` of each plane b; 1 where nothing was hit."""
    planes = ages.reshape(ages.shape[0], -1)
    word = ((hx >> 5) * (n * n) + hz * n + hy).long()
    age = torch.zeros_like(hx)
    for b in range(planes.shape[0]):
        age = age | (((planes[b][word] >> (hx & 31)) & 1) << b)
    return torch.where(found, age, 1).to(torch.int32)


def _age_fade(age, total_states):
    """The direct term's age fade ``clip((S − age)/(S − 1), 0, 1)`` (f32;
    the divisor is a tensor so the division is IEEE on the card too)."""
    num = (total_states - age).to(torch.float32)
    return torch.clamp(num / torch.full_like(num, float(total_states - 1)), 0.0, 1.0)


def _check_plane_mip(mip1, n):
    if tuple(mip1.shape) != (n, n // 8) or mip1.dtype != torch.int32:
        raise ValueError(f"mip1 must be the int32 plane mip [{n}, {n // 8}], got "
                         f"{mip1.dtype} {tuple(mip1.shape)}")


def _check_ages(ages, vol, total_states=2):
    if ages.ndim != 4 or tuple(ages.shape[1:]) != tuple(vol.shape) or total_states < 2:
        raise ValueError(
            f"ages must be [B, {', '.join(map(str, vol.shape))}] age planes of a "
            f"rule with total_states >= 2, got {tuple(ages.shape)} / {total_states}"
        )


def _primary(vol, cam, n, width, height, colmask=None, ages=None, no_sweep=False, mip1=None):
    """Camera rays, volume entry and exit, and the primary sweep of every
    pixel: ((ux, o, d, active, tf), (found, t, hx, hy, hz), age), each [H,
    W] (o and d are xyz triples).  ``colmask``: the prepass's patch masks
    [⌈H/8⌉, ⌈W/8⌉], which then gate the sweep's columns.  ``ages``: the age
    bit-planes; ``age`` is then each hit's age (:func:`_hit_ages`), else
    None.  ``no_sweep``: no sweep, nothing found.  ``mip1``: the plane mip
    that gates the sweep's probes (:func:`_sweep`)."""
    dev = vol.device
    f = lambda i: float(cam[i])  # noqa: E731
    cell_half = float(np.float32(1.0 / n) * cam[P_CELLMUL] * np.float32(0.5))
    ux, dx, dy, dz = _pixel_rays(cam, width, height, dev)
    o = tuple(torch.full_like(dx, f(P_O + i)) for i in range(3))
    d = (dx, dy, dz)
    slabs = [_vol_slab(oi, di) for oi, di in zip(o, d)]
    tn = torch.maximum(torch.maximum(slabs[0][0], slabs[1][0]), slabs[2][0])
    tf = torch.minimum(torch.minimum(slabs[0][1], slabs[1][1]), slabs[2][1])
    active = (tn <= tf) & (tf >= 0.0)
    t_start = torch.clamp(tn, min=0.0)
    if colmask is not None:
        colmask = colmask.repeat_interleave(PATCH, 0).repeat_interleave(PATCH, 1)
        colmask = colmask[:height, :width]
    if no_sweep:
        zero = torch.zeros(dx.shape, dtype=torch.int32, device=dev)
        hits = (torch.zeros_like(active), torch.zeros_like(dx), zero, zero, zero)
    else:
        hits = _sweep(vol.reshape(-1), n, cell_half, o, d, t_start, tf, active,
                      colmask=colmask, forced=colmask is not None and mask_gate_forced(cam),
                      mip1=mip1)
    age = None if ages is None else _hit_ages(ages, n, hits[0], *hits[2:])
    return (ux, o, d, active, tf), hits, age


def raytrace(vol, coarse, cam, history=None, *, grid_size, width, height,
             shadow=True, colmask=None, ages=None, total_states=2, no_sweep=False,
             mip1=None):
    """Plain torch K1 (the kernel's reference; ``coarse`` is unused).

    Without ``history``: returns (rgb [H,W,3] linear light, depth [H,W],
    idx [H,W] int32; -1 = miss).  With ``history = (color [H,W,3] f32,
    hit_idx [H,W] int32)``: composes the frame and returns (presentation
    [H,W,3], depth, idx, new history color [H,W,3] f32).  ``colmask``: the
    prepass's int32 patch masks [⌈H/8⌉, ⌈W/8⌉] (:func:`prepass`), which
    then gate the primary sweep's columns (every column on a window where
    :func:`mask_gate_forced`).  ``ages``: the age bit-planes
    int32 [B, n/32, n, n] of a rule with ``total_states`` > 2, of which
    ``vol`` is the visibility plane; the hit's age then fades the direct
    term (with ``shadow=False``: the unshadowed but faded direct term).
    ``no_sweep``: skip both sweeps (the frame of an empty volume).
    ``mip1``: the plane mip int32 [n, n/8] of ``vol``
    (:func:`~cellularautomatons3d_tpu_torch.ops.occupancy.plane_occupancy`),
    which then gates both sweeps' probes (the twin of the card's mip1
    descent; the frame is the same)."""
    cam = _check_args(grid_size, width, height, cam)
    n = grid_size
    if ages is not None:
        _check_ages(ages, vol, total_states)
    if mip1 is not None:
        _check_plane_mip(mip1, n)
    f = lambda i: float(cam[i])  # noqa: E731
    vol_flat = vol.reshape(-1)
    inv_n = float(np.float32(1.0 / n))
    cell_half = float(np.float32(inv_n) * cam[P_CELLMUL] * np.float32(0.5))

    (ux, (ox, oy, oz), (dx, dy, dz), active, tf), (found, t_hit, hx, hy, hz), age = (
        _primary(vol, cam, n, width, height, colmask, ages, no_sweep, mip1)
    )
    depth = torch.where(found, t_hit, torch.where(active, tf, 0.0))
    idx = torch.where(found, hx + hy * n + hz * (n * n), -1).to(torch.int32)

    qx, qy, qz = ox + t_hit * dx, oy + t_hit * dy, oz + t_hit * dz
    occl = torch.ones_like(dx)
    if shadow and not no_sweep:
        sdx, sdy, sdz = _normalize3(f(P_LIGHT) - qx, f(P_LIGHT + 1) - qy, f(P_LIGHT + 2) - qz)
        sh_tf = torch.minimum(
            torch.minimum(_vol_slab(qx, sdx)[1], _vol_slab(qy, sdy)[1]),
            _vol_slab(qz, sdz)[1],
        )
        occluded = _sweep(
            vol_flat, n, cell_half, (qx, qy, qz), (sdx, sdy, sdz),
            torch.zeros_like(sh_tf), sh_tf, found, exclude=(hx, hy, hz), mip1=mip1,
        )[0]
        occl = torch.where(occluded, OCCLUDED, 1.0)
    co = [(h.to(torch.float32) + 0.5) * inv_n - 0.5 for h in (hx, hy, hz)]
    if (cam[P_MATC : P_MATC + 3] != 0).any():
        albedo = [torch.full_like(dx, f(P_MATC + c)) for c in range(3)]
    else:
        cxn = hx.to(torch.float32) * inv_n
        albedo = [cxn, hy.to(torch.float32) * inv_n, 1.0 - cxn]
    lit = _shade(cam, (qx, qy, qz), co, albedo, (ox, oy, oz))
    if age is not None:
        occl = occl * _age_fade(age, total_states)
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
                  shadow=True, colmask=None, prepass=False, ages=None, total_states=2,
                  no_sweep=False, mip1=None, slicegate=False, column_skip=True):
    """K1 on the card (``csrc/render_fast.cu``): same contract as
    :func:`raytrace`; every tensor must be a contiguous CUDA tensor.
    ``prepass``: gate the primary sweep by the patch masks K1 computes
    itself from ``coarse`` (the frame of ``colmask=prepass_mask(...)`` in
    one launch); not with ``colmask`` or ``no_sweep``.  Such launches are
    also counted in ``raytrace_cuda.prepass_launches``, and compose-mode
    launches (with ``history``) in ``raytrace_cuda.compose_launches``.

    The descents (the frame is the same in every one): ``mip1``, the plane
    mip int32 [n, n/8] of ``vol`` (``ops.occupancy.plane_occupancy``), gates
    each probe's fine fetch by its block's bit; ``slicegate`` loads each
    descended column's plane words before testing them; ``column_skip=False``
    descends every column of the occupied box (the attribution run of the
    coarse column skip).  At most one of them, with or without ``prepass``
    (``column_skip=False`` without), never with ``colmask`` or
    ``no_sweep``; their launches are also counted in
    ``raytrace_cuda.mip1_launches``, ``slicegate_launches`` and
    ``noskip_launches``."""
    cam = _check_args(grid_size, width, height, cam)
    if prepass and (colmask is not None or no_sweep):
        raise ValueError("prepass computes the masks: no colmask, no no_sweep")
    options = (mip1 is not None) + bool(slicegate) + (not column_skip)
    if options > 1:
        raise ValueError("mip1, slicegate and column_skip=False are separate descents")
    if options and (colmask is not None or no_sweep or (prepass and not column_skip)):
        raise ValueError("the descent options run with or without prepass only "
                         "(column_skip=False without it), never with colmask or no_sweep")
    n = grid_size
    kernels.require(vol, "vol", torch.int32, (n // 32, n, n))
    age_bits = 0
    if ages is not None:
        _check_ages(ages, vol, total_states)
        age_bits = ages.shape[0]
        kernels.require(ages, "ages", torch.int32, (age_bits, n // 32, n, n))
    kernels.require(coarse, "coarse", torch.int32, (n // 8, n // 8))
    if colmask is not None:
        kernels.require(colmask, "colmask", torch.int32, _patch_grid(width, height))
    if mip1 is not None:
        kernels.require(mip1, "mip1", torch.int32, (n, n // 8))
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
        cam.ctypes.data, int(shadow),
        None if colmask is None else colmask.data_ptr(), int(prepass),
        int((colmask is not None or prepass) and mask_gate_forced(cam)),
        int(history is not None),
        ptrs[0], ptrs[1], out_rgb.data_ptr(), depth.data_ptr(),
        idx.data_ptr(), ptrs[2],
        None if ages is None else ages.data_ptr(), age_bits, total_states,
        int(no_sweep), None if mip1 is None else mip1.data_ptr(), int(bool(slicegate)),
        int(bool(column_skip)), kernels.stream_of(vol),
    )
    kernels.check(err, "render_fast")
    raytrace_cuda.launches += 1
    raytrace_cuda.prepass_launches += int(prepass)
    raytrace_cuda.compose_launches += int(history is not None)
    raytrace_cuda.mip1_launches += int(mip1 is not None)
    raytrace_cuda.slicegate_launches += int(bool(slicegate))
    raytrace_cuda.noskip_launches += int(not column_skip)
    if history is None:
        return out_rgb, depth, idx
    return out_rgb, depth, idx, new_hist


raytrace_cuda.launches = 0
raytrace_cuda.prepass_launches = 0
raytrace_cuda.compose_launches = 0
raytrace_cuda.mip1_launches = 0
raytrace_cuda.slicegate_launches = 0
raytrace_cuda.noskip_launches = 0


# ------------------------------------------------------- K6: prepass ---


def _patch_grid(width, height):
    """Shape of the prepass's mask image: [⌈H/8⌉, ⌈W/8⌉] patches."""
    return -(-height // PATCH), -(-width // PATCH)


def _f32(x) -> float:
    """A host value rounded to float32 once (the reference's weak-typed
    Python scalars enter its f32 arithmetic this way)."""
    return float(np.float32(x))


def _patch_rays(cam, n, width, height, dev):
    """The prepass ray of every patch's centre pixel (``(p mod pw)·8 + 4``,
    no +0.5) over the volume box grown by 0.035: (o, d, inv, t0, tf,
    active, special), o three float32 scalars, the rest [⌈H/8⌉, ⌈W/8⌉]
    tensors (d and inv xyz triples); ``special``: a steep or far patch."""
    ph, pw = _patch_grid(width, height)
    win_w, win_h = cam[P_WIN], cam[P_WIN + 1]
    py = (torch.arange(ph, dtype=torch.float32, device=dev) * PATCH + PATCH // 2)
    px = (torch.arange(pw, dtype=torch.float32, device=dev) * PATCH + PATCH // 2)
    py, px = py[:, None].expand(ph, pw), px[None, :].expand(ph, pw)
    ux = px / torch.full_like(px, float(win_w))
    uy = 1.0 - (py + float(cam[P_ROW0])) / torch.full_like(py, float(win_h))
    rx = (ux - 0.5) * float(win_w / win_h)
    ry = uy - 0.5
    rz = torch.full_like(rx, -0.5 * COT_HALF_FOV)
    rx, ry, rz = _normalize3(rx, ry, rz)
    f = lambda i: float(cam[i])  # noqa: E731
    d = (f(0) * rx + f(1) * ry + f(2) * rz,
         f(3) * rx + f(4) * ry + f(5) * rz,
         f(6) * rx + f(7) * ry + f(8) * rz)
    o = [np.float32(cam[P_O + i]) for i in range(3)]
    hm = np.float32(0.5 + _PRE_MARGIN)
    inv = [1.0 / di for di in d]
    # The box grown by the margin: per axis (min, max) of its two faces' t.
    slabs = [(torch.minimum(float(-hm - oi) * ii, float(hm - oi) * ii),
              torch.maximum(float(-hm - oi) * ii, float(hm - oi) * ii))
             for oi, ii in zip(o, inv)]
    tn = torch.maximum(torch.maximum(slabs[0][0], slabs[1][0]), slabs[2][0])
    tf = torch.minimum(torch.minimum(slabs[0][1], slabs[1][1]), slabs[2][1])
    active = (tn <= tf) & (tf >= 0.0)
    t0 = torch.clamp(tn, min=0.0)
    adx, ady, adz = (di.abs() for di in d)
    steep = (adx > 2.0 * adz - _f32(0.03)) | (ady > 2.0 * adz - _f32(0.03))
    far = tf * _f32(_PRE_DEV * n) > 7.0
    return o, d, inv, t0, tf, active, steep | far


def _patch_masks(bits, active, special):
    """The int32 masks from the column bits (int64 holding uint32): −1 for
    a special patch, 0 for a patch whose ray misses the grown box."""
    mask = torch.where(special & active, -1, torch.where(active, bits, 0))
    return torch.where(mask >= 2**31, mask - 2**32, mask).to(torch.int32)


def prepass(coarse_pre, cam, *, grid_size, width, height):
    """Plain torch K6 (render_fast.py ``_make_prepass``): the int32 column
    mask of every 8×8 patch, [⌈H/8⌉, ⌈W/8⌉].  The ray of the patch's
    centre pixel (``(p mod pw)·8 + 4``, no +0.5) over the volume box grown
    by 0.035 sets bit c when one of three probes of its segment in 8-plane
    column c lands in an occupied block of ``coarse_pre`` (the coarse mip
    dilated ±2 blocks in x and ±1 in y, int32 [n/8, n/8]); steep, far or
    degenerate patches get −1 (every column), patches whose ray misses the
    box 0."""
    cam = _check_args(grid_size, width, height, cam)
    n = grid_size
    nbk = n // 8
    dev = coarse_pre.device
    o, d, inv, t0, tf, active, special = _patch_rays(cam, n, width, height, dev)
    words = coarse_pre.reshape(-1).to(torch.int64)
    mask = torch.zeros(active.shape, dtype=torch.int64, device=dev)
    for c in range(nbk):
        za = np.float32(c * 8 * (1.0 / n) - 0.5)
        zb = np.float32((c * 8 + 8) * (1.0 / n) - 0.5)
        ta = float(za - o[2]) * inv[2]
        tb = float(zb - o[2]) * inv[2]
        lo = torch.maximum(torch.minimum(ta, tb), t0)
        hi = torch.minimum(torch.maximum(ta, tb), tf)
        seg = (lo < hi) & active
        occ = torch.zeros_like(seg)
        for tp in (lo, 0.5 * (lo + hi), hi):
            b = [torch.clamp(torch.floor((tp * di + float(oi) + 0.5) * nbk), 0, nbk - 1)
                 for di, oi in zip(d[:2], o[:2])]
            bx, by = (torch.where(seg, bi, 0.0).to(torch.int64) for bi in b)
            occ = occ | (seg & (((words[c * nbk + by] >> bx) & 1) == 1))
        mask = mask | (occ.to(torch.int64) << c)
    return _patch_masks(mask, active, special)


def prepass_columns(coarse, cam, *, grid_size, width, height):
    """The masks of :func:`prepass` on the twice-dilated mip, computed as the
    card does (``csrc/prepass.cuh`` ``patch_mask``) from the undilated mip
    ``coarse`` [n/8, n/8]: all 8-plane columns of every patch at once (the
    kernel spreads them over a group of lanes), each probe's block read
    through :func:`~cellularautomatons3d_tpu_torch.ops.occupancy.dilated_bits`,
    the column bits ORed together.  Plain twin of the kernel's formulation,
    for the CPU tests; no frame path calls it."""
    cam = _check_args(grid_size, width, height, cam)
    n = grid_size
    nbk = n // 8
    dev = coarse.device
    o, d, inv, t0, tf, active, special = _patch_rays(cam, n, width, height, dev)
    cols = np.arange(nbk)
    c = torch.from_numpy(cols).to(dev)
    za = torch.from_numpy((cols * 8 * (1.0 / n) - 0.5).astype(np.float32)).to(dev)
    zb = torch.from_numpy(((cols * 8 + 8) * (1.0 / n) - 0.5).astype(np.float32)).to(dev)
    ta = (za - float(o[2])) * inv[2][..., None]
    tb = (zb - float(o[2])) * inv[2][..., None]
    lo = torch.maximum(torch.minimum(ta, tb), t0[..., None])
    hi = torch.minimum(torch.maximum(ta, tb), tf[..., None])
    seg = (lo < hi) & active[..., None]
    occ = torch.zeros_like(seg)
    for tp in (lo, 0.5 * (lo + hi), hi):
        b = [torch.clamp(torch.floor((tp * di[..., None] + float(oi) + 0.5) * nbk), 0, nbk - 1)
             for di, oi in zip(d[:2], o[:2])]
        bx, by = (torch.where(seg, bi, 0.0).to(torch.int64) for bi in b)
        occ = occ | (seg & dilated_bits(coarse, c, by, bx))
    return _patch_masks((occ.to(torch.int64) << c).sum(-1), active, special)


def prepass_cuda(coarse, cam, *, grid_size, width, height):
    """K6 on the card (``csrc/prepass.cu``, 4 lanes per patch): the masks of
    :func:`prepass` on the twice-dilated mip, from the undilated mip
    ``coarse`` [n/8, n/8] (a contiguous CUDA tensor), dilated on read."""
    cam = _check_args(grid_size, width, height, cam)
    n = grid_size
    kernels.require(coarse, "coarse", torch.int32, (n // 8, n // 8))
    out = torch.empty(_patch_grid(width, height), dtype=torch.int32,
                      device=coarse.device)
    err = kernels.library().ca3d_prepass(
        coarse.device.index or 0, coarse.data_ptr(), n, width, height,
        cam.ctypes.data, out.data_ptr(), kernels.stream_of(coarse),
    )
    kernels.check(err, "prepass")
    prepass_cuda.launches += 1
    return out


prepass_cuda.launches = 0


def prepass_mask(coarse, cam, *, grid_size, width, height):
    """The patch masks of a frame (render_fast.py ``_prepass_mask``) from
    the coarse mip ``coarse``: for a CPU mip the plain K6 on the mip
    dilated ±1 block in x and y, then ±1 more in x; for any other K6,
    which dilates on read."""
    kw = dict(grid_size=grid_size, width=width, height=height)
    if coarse.device.type != "cpu":
        return prepass_cuda(coarse, cam, **kw)
    coarse_pre = dilate_occupancy(coarse, dilate_z=False, dilate_y=True)
    coarse_pre = dilate_occupancy(coarse_pre, dilate_z=False, dilate_y=False)
    return prepass(coarse_pre, cam, **kw)


def descent_options(mip1=None, slicegate=None) -> tuple[bool, bool]:
    """K1's (mip1, slicegate) descent: each argument left None is read from
    the environment now (``CA3D_MIP1``, ``CA3D_SLICEGATE``: ``1`` is on), as
    the reference reads them at trace time; slicegate switches mip1 off
    (render_fast.py:1441-1443)."""
    if slicegate is None:
        slicegate = os.environ.get("CA3D_SLICEGATE", "0") == "1"
    if mip1 is None:
        mip1 = os.environ.get("CA3D_MIP1", "0") == "1"
    return bool(mip1) and not slicegate, bool(slicegate)


def raytrace_tiles(vol, coarse, cam, history=None, *, grid_size, width,
                   height, shadow=True, use_prepass=False, ages=None,
                   total_states=2, mip1=None, slicegate=None):
    """Trace (and with ``history``, compose) one frame: the plain version
    for a CPU volume, the CUDA kernel for any other.  ``use_prepass``: gate
    the primary sweep by the patch prepass's column masks (every column
    where :func:`mask_gate_forced`); opt-in, as in the reference.  On the
    CPU the masks are :func:`prepass_mask`'s; on the card K1 computes them
    itself, so the frame is one launch.  ``ages`` / ``total_states``: the
    age bit-planes of a multi-state rule (``vol`` is then its visibility
    plane), whose hit ages fade the direct term.  ``mip1`` / ``slicegate``:
    K1's opt-in descents (module docstring), read from ``CA3D_MIP1`` /
    ``CA3D_SLICEGATE`` at this call where None (:func:`descent_options`);
    with mip1 the frame computes the plane mip of ``vol`` (on the card
    ``plane_occupancy_cuda``, one launch); on the CPU slicegate changes
    nothing (the plain sweep needs no form of it)."""
    kw = dict(grid_size=grid_size, width=width, height=height, shadow=shadow, ages=ages,
              total_states=total_states)
    mip1, slicegate = descent_options(mip1, slicegate)
    if vol.device.type != "cpu":
        return raytrace_cuda(vol, coarse, cam, history, prepass=use_prepass,
                             mip1=plane_occupancy_cuda(vol) if mip1 else None,
                             slicegate=slicegate, **kw)
    colmask = (prepass_mask(coarse, cam, grid_size=grid_size, width=width, height=height)
               if use_prepass else None)
    return raytrace(vol, coarse, cam, history, colmask=colmask,
                    mip1=plane_occupancy(vol) if mip1 else None, **kw)
