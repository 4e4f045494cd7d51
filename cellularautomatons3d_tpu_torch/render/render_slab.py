"""The sliced fast path (grids above 256³, up to 1024³) and the extended
lighting at every grid size: soft shadows and GI.

Port of ``cellularautomatons3d_tpu.render.render_slab``: the primary pass
of a frame (kernel K4), the hit geometry of a traced frame, the
soft-shadow jitter, batched cell-exact occlusion (kernel K2), batched
cell-state lookups (kernel K3), the direct-light occlusion quotient, the
recursive indirect bounce, the one-launch lighting passes, and
:func:`raytrace_sliced`, the whole frame of a grid that K1 does not take.

On the card one launch traces the whole volume of any grid up to 1024³
(128 MiB of packed words at 1024³), so the reference's z-slab / x-brick
machinery does not come across: ``slab_extent``, ``brick_layout`` and its
test overrides (``slab_planes``, ``x_chunk_cells``), ``SlabGroup``,
``prep_slabs``, ``_scan_bricks``, the brick skip and visibility conds, the
min-t composite over bricks with its cross-brick best-t carry, and the
view-dependent brick-order flip are TPU VMEM layout, not kernels.
``prepped`` is the packed volume (for a multi-state rule its visibility
plane, age ≥ 1; the age bit-planes go to K4 and nowhere else) and its
coarse occupancy mip (:func:`prep_volume`); images are ``[H, W]`` / ``[H, W, 3]`` in image
order.  Exact-t ties between distinct cells, where the reference keeps
the first brick processed, keep the first cell in plane order here.

Four kernels, each with a plain torch version of the same contract that
runs for CPU tensors and is the kernel's reference:

* K4, primary hits (:func:`primary_sweep` / :func:`primary_sweep_cuda`,
  ``csrc/primary_sweep.cu``): the reference's per-brick primary kernel,
  over the whole volume, with its age output for multi-state rules;
* K2, occlusion (:func:`shadow_sweep` / :func:`shadow_sweep_cuda`,
  ``csrc/shadow_sweep.cu``): the default sweep backend of the reference's
  ``shadow_occlusion_batch``;
* K5, multi-query occlusion (:func:`shadow_sweep_multi` /
  :func:`shadow_sweep_multi_cuda`, ``csrc/shadow_multi.cu``): the opt-in
  backend of ``shadow_occlusion_batch`` (``CA3D_OCC_SWEEP=0``), up to
  ``CA3D_OCC_NQ`` queries a launch; its flags equal K2's;
* K3, cell state (:func:`cell_state` / :func:`cell_state_cuda`,
  ``csrc/cell_state.cu``).

K4, K2 and K5 are clipped on the card to the box of occupied blocks that a
one-block kernel (``csrc/occupied_box.cu``, plain twin
``ops.occupancy.occupied_box``) reduces from the mip just before each of
them, in the same entry point; the plain versions clip nothing.  K2 takes
its queries stacked by :func:`stack_occlusion_queries`; K5 and K3 take each
query's tensors where the lighting passes leave them (start, cells [H, W,
3], a target [H, W, 3] or the light's [3], active [H, W]), through a table
of pointers and strides (``csrc/queries.cuh``), and their plain versions
take the same queries stacked.

:func:`primary_hits`, :func:`shadow_occlusion_batch` and
:func:`cell_state_batch` pick by device.

Float rules: ray directions are normalised with ``1/sqrt`` (the reference
uses ``lax.rsqrt``, which XLA:CPU does not round as IEEE; see PERF.md),
every division has a tensor divisor (CUDA torch divides by a Python scalar
as a multiply by its reciprocal), and the jitter hash evaluates ``sin`` in
float64 rounded to float32, so the CPU and the card agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..ops.occupancy import BOX_WORDS, coarse_occupancy, coarse_shape, occupied_box_cuda
from . import brdf
from .intersect import (
    FULL_CUBE_SIZE,
    HALF_CUBE_SIZE,
    cube_face_normal,
    device_vec,
    ray_cube_intersect,
)
from .render_fast import (
    OCCLUDED,
    P_CELLMUL,
    P_EMIS,
    P_EMISS,
    P_LIGHT,
    P_LMAG,
    P_LRAD,
    P_MATC,
    P_O,
    P_REFL,
    P_ROUGH,
    P_ROW0,
    P_TIME,
    P_WIN,
    _age_fade,
    _check_ages,
    _check_window,
    _normalize3,
    _pixel_rays,
    _primary,
    _sweep,
)
from .renderer import _INDIRECT_LAYERS, _face_index

__all__ = [
    "MAX_SLICED_GRID",
    "Prepped",
    "prep_volume",
    "primary_sweep",
    "primary_sweep_cuda",
    "primary_hits",
    "raytrace_sliced",
    "hit_geometry",
    "soft_shadow_jitter",
    "shadow_sweep",
    "shadow_sweep_cuda",
    "shadow_sweep_multi",
    "shadow_sweep_multi_cuda",
    "pack_exclusion",
    "stack_occlusion_queries",
    "shadow_occlusion_batch",
    "cell_state",
    "cell_state_cuda",
    "stack_cell_queries",
    "cell_state_batch",
    "direct_occlusion",
    "indirect_bounce",
    "lighting_queries",
    "lighting_passes",
]


MAX_SLICED_GRID = 1024  # reference UI ceiling (main_pathtraced.js:274-277)


class Prepped(NamedTuple):
    """The volume as the traced passes take it."""

    vol: torch.Tensor     # packed words int32 [n/32, n, n]
    coarse: torch.Tensor  # coarse occupancy mip int32 [n/8, XG·n/8] (the skip)


def prep_volume(packed: torch.Tensor, coarse: torch.Tensor | None = None) -> Prepped:
    """The whole-volume counterpart of the reference's ``prep_slabs``."""
    return Prepped(packed, coarse_occupancy(packed) if coarse is None else coarse)


def _check_sliced(grid_size, width, height, cam):
    if grid_size > MAX_SLICED_GRID:
        raise ValueError(f"grid_size {grid_size} > {MAX_SLICED_GRID}")
    return _check_window(grid_size, width, height, cam)


def _cell_half(cam, n: int) -> float:
    """Visible-cube half size, ``(1/n) * cell_size * 0.5`` in float32."""
    return float(np.float32(1.0 / n) * np.float32(cam[P_CELLMUL]) * np.float32(0.5))


# ------------------------------------------------------ K4: primary ---


def primary_sweep(vol, cam, ages=None, *, grid_size, width, height):
    """Plain torch K4: the primary hit of every pixel over the whole volume,
    (t f32 [H, W], id int32 [H, W]): t is the hit's visible-cube entry and
    the id x + y·n + z·n²; a miss gives t = 0 and id −1.  With ``ages`` (the
    age bit-planes int32 [B, n/32, n, n] of which ``vol`` is the visibility
    plane) a third output, the hit cell's age int32 [H, W], 1 for a miss."""
    cam = _check_sliced(grid_size, width, height, cam)
    n = grid_size
    if ages is not None:
        _check_ages(ages, vol)
    _, (found, t_hit, hx, hy, hz), age = _primary(vol, cam, n, width, height,
                                                  ages=ages)
    idx = torch.where(found, hx + hy * n + hz * (n * n), -1).to(torch.int32)
    # The sweep leaves t = 0 where nothing was hit.
    return (t_hit, idx) if ages is None else (t_hit, idx, age)


def _box_scratch(coarse):
    """The 8 words K2's, K4's and K5's entry points have the box kernel
    (``csrc/occupied_box.cu``) write before their own kernel reads them, and
    the host int the entry point adds one to once it has launched it."""
    return (torch.empty(BOX_WORDS, dtype=torch.int32, device=coarse.device),
            ctypes.c_int(0))


def primary_sweep_cuda(vol, coarse, cam, ages=None, *, grid_size, width, height,
                       column_skip=True):
    """K4 on the card (``csrc/primary_sweep.cu``): same contract as
    :func:`primary_sweep`; ``vol``, ``coarse`` and ``ages`` must be
    contiguous CUDA tensors (``coarse`` 16-byte aligned).  Each call
    launches the box kernel, then K4.  ``column_skip=False`` descends every
    column of the occupied box (the same hits; the attribution run of the
    coarse column skip, which no frame path makes), also counted in
    ``primary_sweep_cuda.noskip_launches``."""
    cam = _check_sliced(grid_size, width, height, cam)
    n = grid_size
    kernels.require(vol, "vol", torch.int32, (n // 32, n, n))
    kernels.require(coarse, "coarse", torch.int32, coarse_shape(n), align=16)
    t = torch.empty((height, width), dtype=torch.float32, device=vol.device)
    idx = torch.empty((height, width), dtype=torch.int32, device=vol.device)
    age, age_bits = None, 0
    if ages is not None:
        _check_ages(ages, vol)
        age_bits = ages.shape[0]
        kernels.require(ages, "ages", torch.int32, (age_bits, n // 32, n, n))
        age = torch.empty((height, width), dtype=torch.int32, device=vol.device)
    box, box_launches = _box_scratch(coarse)
    err = kernels.library().ca3d_primary_sweep_ages(
        vol.device.index or 0, vol.data_ptr(), coarse.data_ptr(), n, width,
        height, cam.ctypes.data, t.data_ptr(), idx.data_ptr(),
        None if ages is None else ages.data_ptr(), age_bits,
        None if age is None else age.data_ptr(), int(bool(column_skip)), box.data_ptr(),
        ctypes.byref(box_launches), kernels.stream_of(vol),
    )
    occupied_box_cuda.launches += box_launches.value
    kernels.check(err, "primary_sweep")
    primary_sweep_cuda.launches += 1
    primary_sweep_cuda.noskip_launches += int(not column_skip)
    return (t, idx) if ages is None else (t, idx, age)


primary_sweep_cuda.launches = 0
primary_sweep_cuda.noskip_launches = 0


def primary_hits(cam, prepped: Prepped, ages=None, *, grid_size, width, height):
    """(t, id) of every pixel's primary hit, and with ``ages`` its age: the
    plain version for a CPU volume, K4 for any other."""
    kw = dict(grid_size=grid_size, width=width, height=height)
    if prepped.vol.device.type == "cpu":
        return primary_sweep(prepped.vol, cam, ages, **kw)
    return primary_sweep_cuda(prepped.vol, prepped.coarse, cam, ages, **kw)


# ------------------------------------------------------------ geometry ---


def _hit_geometry(cam, idx_img, t_img, n, width, height):
    """(q, origin, coords, found, d): hit_geometry's first four outputs and
    the per-pixel world ray direction d [H, W, 3]."""
    dev = idx_img.device
    _, dx, dy, dz = _pixel_rays(cam, width, height, dev)
    d = torch.stack([dx, dy, dz], dim=-1)
    q = device_vec(cam[P_O : P_O + 3], dev) + d * t_img[..., None]
    coords = torch.stack([idx_img % n, (idx_img // n) % n, idx_img // (n * n)], dim=-1)
    cell = np.float32(FULL_CUBE_SIZE / n)
    origin = coords.to(torch.float32) * float(cell) + float(cell * np.float32(0.5)) - HALF_CUBE_SIZE
    return q, origin, coords, idx_img >= 0, d


def hit_geometry(cam, idx_img, t_img, *, grid_size, width, height):
    """(q, origin, coords, found, tf_miss) from a traced hit image: the
    surface point, its cell's centre and integer coordinates (a miss, id -1,
    decodes to (n-1, n-1, -1)), the hit mask, and the volume exit depth of
    the rays that cross the volume (0 elsewhere)."""
    q, origin, coords, found, d = _hit_geometry(cam, idx_img, t_img, grid_size, width, height)
    o = np.asarray(cam[P_O : P_O + 3], np.float32)
    t1 = torch.stack([torch.full_like(d[..., i], float(np.float32(-0.5) - o[i])) / d[..., i]
                      for i in range(3)], dim=-1)
    t2 = torch.stack([torch.full_like(d[..., i], float(np.float32(0.5) - o[i])) / d[..., i]
                      for i in range(3)], dim=-1)
    tf = torch.amin(torch.maximum(t1, t2), dim=-1)
    tn = torch.amax(torch.minimum(t1, t2), dim=-1)
    crossed = (tn <= tf) & (tf >= 0.0)
    return q, origin, coords, found, torch.where(crossed, tf, 0.0)


def _pixel_uv(cam, width, height, device):
    """Global-window pixel uvs (ux, uy), each [H, W]."""
    win_w, win_h = float(cam[P_WIN]), float(cam[P_WIN + 1])
    px = torch.arange(width, dtype=torch.float32, device=device)[None, :].expand(height, width)
    py = torch.arange(height, dtype=torch.float32, device=device)[:, None].expand(height, width)
    ux = (px + 0.5) / torch.full_like(px, win_w)
    uy = 1.0 - (py + float(cam[P_ROW0]) + 0.5) / torch.full_like(py, win_h)
    return ux, uy


def _jitter_constants(k: int):
    """The hash offsets of soft-shadow sample ``k``, rounded to float32
    once (a 1-ulp change would decorrelate the sin-fract hash)."""
    return (np.float32(0.17 * k + 0.05), np.float32(0.29 * k + 0.11),
            np.float32(0.41 * k + 0.23))


def soft_shadow_jitter(cam, kk, width, height, nk=None, device=None):
    """Jittered area-light offset [H, W, 3] for soft-shadow sample ``kk``:
    the reference's sin-fract hash over global-window uvs (n1rand,
    wgsl:171-180; renderer.py:218-222).

    ``kk`` is an int, or an int tensor in [0, nk) (the temporally amortized
    mode's rotating index): the per-sample constants then come from a table
    of the same float32 values, so each rotated sample equals the static
    one bit for bit."""
    ux, uy = _pixel_uv(cam, width, height, device)
    t = np.float32(cam[P_TIME])
    base = float(np.float32(0.07) * (t - np.floor(t)))
    if isinstance(kk, (int, np.integer)):
        consts = [float(c) for c in _jitter_constants(int(kk))]
    else:
        if nk is None:
            raise ValueError("a tensor sample index requires nk")
        table = device_vec(
            np.concatenate([_jitter_constants(k) for k in range(nk)]), ux.device
        ).view(nk, 3)[kk]
        consts = [table[0], table[1], table[2]]

    def j1(cst):
        ax = (ux + base) + cst
        ay = (uy + base) + cst
        arg = ax * 12.9898 + ay * 78.233
        v = torch.sin(arg.to(torch.float64)).to(torch.float32) * 43758.5453
        return (v - torch.floor(v)) - 0.5

    rad2 = float(np.float32(2.0) * np.float32(cam[P_LRAD]))
    return torch.stack([j1(c) for c in consts], dim=-1) * rad2


# ------------------------------------------------------ K2: occlusion ---


def _exit_t(s, d):
    return torch.maximum((-0.5 - s) / d, (0.5 - s) / d)


def _occlusion(vol, start, target, active, exclude, grid_size, cell_half):
    """The occluded flags of K2 and K5: each ray from ``start`` toward
    ``target``, normalised, over t in [0, volume exit]."""
    sx, sy, sz = start.unbind(1)
    tx, ty, tz = target.unbind(1)
    dx, dy, dz = _normalize3(tx - sx, ty - sy, tz - sz)
    t1 = torch.minimum(torch.minimum(_exit_t(sx, dx), _exit_t(sy, dy)), _exit_t(sz, dz))
    occluded = _sweep(
        vol.reshape(-1), grid_size, cell_half, (sx, sy, sz), (dx, dy, dz),
        torch.zeros_like(t1), t1, active, exclude=exclude,
    )[0]
    return occluded.to(torch.int32)


def shadow_sweep(vol, start, target, excl, active, *, grid_size, cell_half):
    """Plain torch K2: occluded flags int32 [nq, H, W] of the shadow rays
    from ``start`` toward ``target`` (f32 [nq, 3, H, W]) over t in [0,
    volume exit], skipping the cell ``excl`` (int32 [nq, 3, H, W]) component
    by component; inactive lanes (``active`` bool [nq, H, W]) give 0."""
    return _occlusion(vol, start, target, active, tuple(excl.unbind(1)),
                      grid_size, cell_half)


def shadow_sweep_cuda(vol, coarse, start, target, excl, active, *, grid_size,
                      cell_half, column_skip=True):
    """K2 on the card (``csrc/shadow_sweep.cu``): same contract as
    :func:`shadow_sweep`; every tensor must be a contiguous CUDA tensor
    (``coarse`` 16-byte aligned).  Each call launches the box kernel, then
    K2.  ``column_skip=False`` descends every column of the occupied box
    (the same flags; the attribution run of the coarse column skip, which no
    frame path makes), also counted in ``shadow_sweep_cuda.noskip_launches``."""
    n = grid_size
    nq, _, h, w = start.shape
    kernels.require(vol, "vol", torch.int32, (n // 32, n, n))
    kernels.require(coarse, "coarse", torch.int32, coarse_shape(n), align=16)
    kernels.require(start, "start", torch.float32, (nq, 3, h, w))
    kernels.require(target, "target", torch.float32, (nq, 3, h, w))
    kernels.require(excl, "excl", torch.int32, (nq, 3, h, w))
    kernels.require(active, "active", torch.bool, (nq, h, w))
    out = torch.empty((nq, h, w), dtype=torch.int32, device=start.device)
    box, box_launches = _box_scratch(coarse)
    err = kernels.library().ca3d_shadow_sweep(
        start.device.index or 0, vol.data_ptr(), coarse.data_ptr(), n,
        float(cell_half), w, h, nq, start.data_ptr(), target.data_ptr(),
        excl.data_ptr(), active.data_ptr(), out.data_ptr(), int(bool(column_skip)),
        box.data_ptr(), ctypes.byref(box_launches), kernels.stream_of(start),
    )
    occupied_box_cuda.launches += box_launches.value
    kernels.check(err, "shadow_sweep")
    shadow_sweep_cuda.launches += 1
    shadow_sweep_cuda.noskip_launches += int(not column_skip)
    return out


shadow_sweep_cuda.launches = 0
shadow_sweep_cuda.noskip_launches = 0


# -------------------------------------------- K5: multi-query occlusion ---

MAX_MULTI_QUERIES = 8  # queries per launch of K5 and K3 (csrc/queries.cuh)


def pack_exclusion(excl, n):
    """K5's excluded-cell ids int32 [nq, H, W] from K2's cells int32 [nq,
    3, H, W]: x + y·n + z·n², and −1 where a coordinate is outside [0, n)
    (render_slab.py shadow_occlusion_batch: a plain packing would alias,
    e.g. x == n to the real cell (0, y+1, z)).  Probe ids are ≥ 0, so −1
    never matches, as an out-of-range coordinate never matches in K2."""
    x, y, z = excl.unbind(1)
    in_range = ((excl >= 0) & (excl < n)).all(dim=1)
    return torch.where(in_range, x + y * n + z * (n * n), -1).to(torch.int32)


def shadow_sweep_multi(vol, start, target, exid, active, *, grid_size,
                       cell_half):
    """Plain torch K5: :func:`shadow_sweep`'s flags with the excluded cell
    given by its packed id ``exid`` (int32 [nq, H, W], :func:`pack_exclusion`)."""
    return _occlusion(vol, start, target, active, exid, grid_size, cell_half)


def _pixel_operand(t, name, h, w, dtypes, shared=False):
    """[pointer, pixel stride, component stride] of a per-query operand of
    K5 or K3 (``csrc/queries.cuh``): a CUDA tensor [H, W, 3] whose pixel
    (y, x) lies y·W + x pixel strides from its start (a contiguous tensor,
    or a [3, H, W] slice seen as [H, W, 3]), or with ``shared`` one [3]
    vector for every pixel (pixel stride 0)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
    st = t.stride()
    if shared and t.shape == (3,):
        return [t.data_ptr(), 0, st[0]]
    if t.shape != (h, w, 3) or st[0] != w * st[1]:
        raise ValueError(f"{name} must be [{h}, {w}, 3]{' or [3]' if shared else ''} "
                         f"with rows of {w} pixels, got shape {tuple(t.shape)} and "
                         f"strides {st}")
    return [t.data_ptr(), st[1], st[2]]


def _mask_pointer(a, name, h, w):
    """The address of a query's active mask, a contiguous CUDA bool [H, W]
    tensor (checked by :func:`kernels.require` when it is not one)."""
    if not (a.is_cuda and a.dtype == torch.bool and a.shape == (h, w) and a.is_contiguous()):
        kernels.require(a, name, torch.bool, (h, w))
    return a.data_ptr()


def _query_table(rows):
    """The int64 rows of K5's or K3's query table as a ctypes array."""
    return (ctypes.c_longlong * len(rows))(*rows)


_CELL_TYPES = (torch.int32, torch.int64)


def shadow_sweep_multi_cuda(vol, coarse, start, target, excl, active, *,
                            grid_size, cell_half):
    """K5 on the card (``csrc/shadow_multi.cu``): :func:`shadow_sweep_multi`'s
    flags int32 [nq, H, W] of 1 to 8 queries given where the lighting passes
    leave them: ``start``, ``target``, ``excl`` and ``active`` are
    sequences of nq tensors (or tensors with nq rows), start f32 [H, W, 3],
    target f32 [H, W, 3] or [3], excl int32 or int64 [H, W, 3] (the cell
    the ray skips; none when a coordinate is outside [0, n), as
    :func:`pack_exclusion` gives −1), active bool [H, W]; all CUDA tensors
    (``vol`` and ``active`` contiguous, ``coarse`` 16-byte aligned), the
    vector operands with rows of W pixels.  Each call launches the box
    kernel, then K5."""
    n = grid_size
    nq = len(start)
    if not 1 <= nq <= MAX_MULTI_QUERIES:
        raise ValueError(f"K5 takes 1 to {MAX_MULTI_QUERIES} queries, got {nq}")
    if not len(target) == len(excl) == len(active) == nq:
        raise ValueError("start, target, excl and active must hold one entry per query")
    kernels.require(vol, "vol", torch.int32, (n // 32, n, n))
    kernels.require(coarse, "coarse", torch.int32, coarse_shape(n), align=16)
    h, w = active[0].shape
    rows = []
    for i in range(nq):
        rows += _pixel_operand(start[i], f"start[{i}]", h, w, (torch.float32,))
        rows += _pixel_operand(target[i], f"target[{i}]", h, w, (torch.float32,),
                               shared=True)
        rows += _pixel_operand(excl[i], f"excl[{i}]", h, w, _CELL_TYPES)
        rows += [excl[i].dtype == torch.int64, _mask_pointer(active[i], f"active[{i}]", h, w)]
    out = torch.empty((nq, h, w), dtype=torch.int32, device=vol.device)
    box, box_launches = _box_scratch(coarse)
    err = kernels.library().ca3d_shadow_multi(
        vol.device.index or 0, vol.data_ptr(), coarse.data_ptr(), n,
        float(cell_half), w, h, nq, _query_table(rows), out.data_ptr(),
        box.data_ptr(), ctypes.byref(box_launches), kernels.stream_of(vol),
    )
    occupied_box_cuda.launches += box_launches.value
    kernels.check(err, "shadow_multi")
    shadow_sweep_multi_cuda.launches += 1
    return out


shadow_sweep_multi_cuda.launches = 0


def _stack3(vectors, shape):
    """[H, W, 3] (or broadcastable) tensors → contiguous [nq, 3, H, W]."""
    return torch.stack([torch.broadcast_to(v, shape).movedim(-1, 0) for v in vectors])


def stack_occlusion_queries(queries, width, height):
    """(start, target, excl, active) operands of K2 from a list of
    (start [H,W,3], target [H,W,3] or [3], excl [H,W,3] int, active [H,W]
    bool) queries."""
    shape = (height, width, 3)
    return (
        _stack3([q[0] for q in queries], shape),
        _stack3([q[1] for q in queries], shape),
        _stack3([q[2] for q in queries], shape).to(torch.int32),
        torch.stack([q[3] for q in queries]),
    )


def _occlusion_k2(prepped, ops, kw):
    if ops[0].device.type == "cpu":
        return shadow_sweep(prepped.vol, *ops, **kw)
    return shadow_sweep_cuda(prepped.vol, prepped.coarse, *ops, **kw)


def _occlusion_k5(prepped, queries, kw, width, height):
    """K5's flags of a chunk of queries: the kernel on the queries' own
    tensors, or for CPU tensors the plain K5 on them stacked."""
    if queries[0][0].device.type == "cpu":
        start, target, excl, active = stack_occlusion_queries(queries, width, height)
        exid = pack_exclusion(excl, kw["grid_size"])
        return shadow_sweep_multi(prepped.vol, start, target, exid, active, **kw)
    return shadow_sweep_multi_cuda(prepped.vol, prepped.coarse, *zip(*queries), **kw)


def shadow_occlusion_batch(cam, queries, prepped: Prepped, *, grid_size, width,
                           height):
    """Cell-exact occlusion for a batch of per-pixel ray queries (e.g. the
    k jittered soft-shadow samples and the 4 GI slots).  Returns one bool
    [H, W] occlusion mask per query.

    Backends, chosen as the reference chooses them, from environment
    variables read on every call: by default every query goes to K2, here
    in one launch.  With ``CA3D_OCC_SWEEP`` other than ``1`` the batch is
    cut into chunks of ``CA3D_OCC_NQ`` (default 4) queries, and a chunk
    goes to K5 (one launch for the chunk's queries) unless it holds one
    query and ``CA3D_OCC_NQ1_SWEEP`` is ``1`` (the default), when
    it goes to K2.  Both give the same flags.  K2 takes its queries stacked,
    K5 as they are."""
    kw = dict(grid_size=grid_size, cell_half=_cell_half(cam, grid_size))
    if os.environ.get("CA3D_OCC_SWEEP", "1") == "1":
        ops = stack_occlusion_queries(queries, width, height)
        return list(_occlusion_k2(prepped, ops, kw) == 1)
    nq_max = int(os.environ.get("CA3D_OCC_NQ", "4"))
    nq1_sweep = os.environ.get("CA3D_OCC_NQ1_SWEEP", "1") == "1"
    out = []
    for i in range(0, len(queries), nq_max):
        chunk = queries[i : i + nq_max]
        if len(chunk) == 1 and nq1_sweep:
            occ = _occlusion_k2(prepped, stack_occlusion_queries(chunk, width, height), kw)
        else:
            occ = _occlusion_k5(prepped, chunk, kw, width, height)
        out += list(occ == 1)
    return out


# ----------------------------------------------------- K3: cell state ---


def cell_state(vol, coords, active, *, grid_size):
    """Plain torch K3: uint8 [nq, H, W] cell states ``state(max(c, 0) mod
    n)`` at ``coords`` (integer [nq, 3, H, W]); inactive lanes give 0."""
    n = grid_size
    x, y, z = (torch.clamp(coords, min=0) % n).unbind(1)
    word = vol.reshape(-1)[(((x >> 5) * n + z) * n + y).long()]
    return torch.where(active, (word >> (x & 31)) & 1, 0).to(torch.uint8)


def cell_state_cuda(vol, coords, active, *, grid_size):
    """K3 on the card (``csrc/cell_state.cu``): :func:`cell_state`'s states
    uint8 [nq, H, W] of 1 to 8 lookups given where the lighting passes leave
    them: ``coords`` and ``active`` are sequences of nq tensors (or tensors
    with nq rows), coords int32 or int64 [H, W, 3] with rows of W pixels,
    active bool [H, W]; all CUDA tensors (``vol`` and ``active``
    contiguous)."""
    n = grid_size
    nq = len(coords)
    if not 1 <= nq <= MAX_MULTI_QUERIES:
        raise ValueError(f"K3 takes 1 to {MAX_MULTI_QUERIES} lookups, got {nq}")
    if len(active) != nq:
        raise ValueError("coords and active must hold one entry per lookup")
    kernels.require(vol, "vol", torch.int32, (n // 32, n, n))
    h, w = active[0].shape
    rows = []
    for i in range(nq):
        rows += _pixel_operand(coords[i], f"coords[{i}]", h, w, _CELL_TYPES)
        rows += [coords[i].dtype == torch.int64, _mask_pointer(active[i], f"active[{i}]", h, w)]
    out = torch.empty((nq, h, w), dtype=torch.uint8, device=vol.device)
    err = kernels.library().ca3d_cell_state(
        vol.device.index or 0, vol.data_ptr(), n, w, h, nq, _query_table(rows),
        out.data_ptr(), kernels.stream_of(vol),
    )
    kernels.check(err, "cell_state")
    cell_state_cuda.launches += 1
    return out


cell_state_cuda.launches = 0


def stack_cell_queries(queries, width, height):
    """(coords, active) operands of the plain K3 from a list of (coords
    [H, W, 3] int, active [H, W] bool) queries."""
    coords = _stack3([c for c, _ in queries], (height, width, 3)).to(torch.int32)
    return coords, torch.stack([a for _, a in queries])


def cell_state_batch(queries, prepped: Prepped, *, grid_size, width, height):
    """Cell states for a batch of per-pixel coordinate queries, in one
    launch.  ``queries``: list of (coords [H, W, 3] int, active [H, W]
    bool).  Returns one uint8 [H, W] state image per query: K3 on the
    queries' own tensors, or for CPU tensors the plain K3 on them stacked."""
    if queries[0][0].device.type == "cpu":
        coords, active = stack_cell_queries(queries, width, height)
        return list(cell_state(prepped.vol, coords, active, grid_size=grid_size))
    coords, active = zip(*queries)
    return list(cell_state_cuda(prepped.vol, coords, active, grid_size=grid_size))


# ------------------------------------------------------------ lighting ---


@functools.lru_cache(maxsize=8)
def _layers(device) -> torch.Tensor:
    return torch.from_numpy(_INDIRECT_LAYERS).to(device)


def _occlusion_quotient(occluded):
    return torch.where(occluded, OCCLUDED, 1.0)


def _shader(cam, n):
    """calculate_lighting_at with this frame's material."""
    return functools.partial(
        brdf.calculate_lighting_at, grid_size=n, roughness=cam[P_ROUGH],
        material_color=cam[P_MATC : P_MATC + 3],
        base_reflectivity=cam[P_REFL : P_REFL + 3],
    )


def _slot_geometry(cam, n, point, pcoords, off, active):
    """(n_cl, n_origin, n_point, ok) of one GI neighbour slot: the clamped
    neighbour coordinates, its cell centre, where the ray along the
    (unnormalised) offset enters its visible cube, and whether it does."""
    cell = np.float32(FULL_CUBE_SIZE / n)
    n_coords = pcoords + off
    n_cl = torch.clamp(n_coords, min=0)
    n_origin = (
        n_coords.to(torch.float32) * float(cell) + float(cell * np.float32(0.5))
        - HALF_CUBE_SIZE
    )
    n_dir = off.to(torch.float32)
    t_near, t_far = ray_cube_intersect(point, n_dir, n_origin, _cell_half(cam, n))
    ok = active & (t_near <= t_far) & (t_far >= 0.0)
    n_point = point + n_dir * t_near[..., None]
    return n_cl, n_origin, n_point, ok


def direct_occlusion(cam, q, coords, found, prepped, *, grid_size, width,
                     height, soft_k=1, jitter_k=None):
    """Direct-light occlusion quotient [H, W]: hard (one ray per pixel) or
    soft (``soft_k`` jittered area-light samples averaged,
    renderer.py:212-224), all samples in one launch.  ``jitter_k``: the
    temporally amortized mode's sample index in [0, soft_k), one jittered
    sample per frame.  The direct-shadow half of :func:`lighting_passes`."""
    return lighting_passes(
        cam, q, None, coords, found, prepped, grid_size=grid_size,
        width=width, height=height, soft_k=soft_k, jitter_k=jitter_k,
    )[0]


def indirect_bounce(vol, cam, q, origin, coords, found, prepped, *, grid_size,
                    width, height, bounces=1, slot=None):
    """Indirect GI (wgsl:307-377; renderer._indirect_lighting with the
    stochastic shadow march replaced by cell-exact occlusion), each level's
    4 neighbour slots batched into one K3 and one K2 launch.  ``bounces``
    > 1 recursively adds each neighbour's own indirect term (4^b occlusion
    queries).  ``slot``: the temporally amortized mode's single slot (int
    or int tensor), scaled ×4, an unbiased estimate of the 4-slot sum;
    requires ``bounces == 1``.  Returns rgb [H, W, 3].  (``vol`` is unused,
    as in the reference.)"""
    n = grid_size
    dev = q.device
    light = device_vec(cam[P_LIGHT : P_LIGHT + 3], dev)
    o = device_vec(cam[P_O : P_O + 3], dev)
    lmag3 = torch.full_like(q, float(cam[P_LMAG]))
    emis = device_vec(cam[P_EMIS : P_EMIS + 3] * cam[P_EMISS], dev)
    layers = _layers(dev)
    shade = _shader(cam, n)

    def indirect_from(point, porigin, pcoords, viewer, active, depth_left):
        face = _face_index(cube_face_normal(point, porigin))
        if slot is None:
            offs = [layers[:, i, :][face] for i in range(4)]
        else:
            offs = [layers[:, slot, :][face]]
        slot_cl = [torch.clamp(pcoords + off, min=0) for off in offs]
        slot_states = cell_state_batch(
            [(cl, active) for cl in slot_cl], prepped, grid_size=n,
            width=width, height=height,
        )
        slots = []
        queries = []
        for off, n_state in zip(offs, slot_states):
            n_cl, n_origin, n_point, ok = _slot_geometry(
                cam, n, point, pcoords, off, active & (n_state == 1)
            )
            slots.append((n_cl, n_origin, n_point, ok))
            queries.append((n_point, light, n_cl, ok))
        occs = shadow_occlusion_batch(
            cam, queries, prepped, grid_size=n, width=width, height=height
        )
        total = torch.zeros_like(point)
        for (n_cl, n_origin, n_point, ok), occluded in zip(slots, occs):
            reflected = _occlusion_quotient(occluded)[..., None] * shade(
                n_point, n_origin, n_cl, point, lmag3, light
            )
            reflected = reflected + emis
            if depth_left > 1:
                reflected = reflected + indirect_from(
                    n_point, n_origin, n_cl, point, ok, depth_left - 1
                )
            bounce = shade(point, porigin, pcoords, viewer, reflected, n_point)
            total = total + torch.where(ok[..., None], bounce, 0.0)
        if slot is not None:
            total = total * 4.0  # unbiased 1-of-4 estimator
        return total

    if slot is not None and int(bounces) > 1:
        raise ValueError("temporal slot sampling requires bounces == 1")
    return indirect_from(q, origin, coords, o, found, max(1, int(bounces)))


def lighting_queries(cam, q, origin, coords, found, *, grid_size, width,
                     height, soft_k=1, jitter_k=None, gi=False, gi_slot=None):
    """The occlusion queries of :func:`lighting_passes`: (queries, slots,
    n_soft) -- the ``n_soft`` direct-shadow queries (soft-shadow samples,
    or the hard shadow) followed by one per GI slot, and each slot's
    (n_cl, n_origin, n_point, ok_geo)."""
    n = grid_size
    dev = q.device
    light = device_vec(cam[P_LIGHT : P_LIGHT + 3], dev)
    queries = []

    n_soft = 0
    if soft_k is not None:
        if jitter_k is not None:
            target = light + soft_shadow_jitter(
                cam, jitter_k, width, height, nk=max(1, soft_k), device=dev
            )
            queries.append((q, target, coords, found))
            n_soft = 1
        else:
            for kk in range(max(1, soft_k)):
                if soft_k > 1:
                    target = light + soft_shadow_jitter(cam, kk, width, height, device=dev)
                else:
                    target = light
                queries.append((q, target, coords, found))
            n_soft = max(1, soft_k)

    slots = []
    if gi:
        layers = _layers(dev)
        face = _face_index(cube_face_normal(q, origin))
        if gi_slot is None:
            offs = [layers[:, i, :][face] for i in range(4)]
        else:
            offs = [layers[:, gi_slot, :][face]]
        for off in offs:
            slot = _slot_geometry(cam, n, q, coords, off, found)
            slots.append(slot)
            queries.append((slot[2], light, slot[0], slot[3]))
    return queries, slots, n_soft


def lighting_passes(cam, q, origin, coords, found, prepped, *, grid_size,
                    width, height, soft_k=1, jitter_k=None, gi=False,
                    gi_slot=None):
    """Soft-shadow occlusion and one-bounce GI with every occlusion query of
    the frame in one K2 launch and the GI slots' states in one K3 launch.

    The GI slots' occlusion rays depend only on the hit geometry, not on the
    neighbour's state, which only gates whether a slot contributes, so the
    ``soft_k`` jittered samples and the 4 slots (1 with ``gi_slot``) share
    the launch.  Covers ``bounces == 1`` and the temporally amortized mode;
    deeper recursion is :func:`indirect_bounce`.  ``soft_k=None``: no
    direct-shadow queries.  Returns (occl [H, W] or None, gi_rgb [H, W, 3]
    or None)."""
    n = grid_size
    dev = q.device
    kw = dict(grid_size=n, width=width, height=height)
    queries, slots, n_soft = lighting_queries(
        cam, q, origin, coords, found, soft_k=soft_k, jitter_k=jitter_k,
        gi=gi, gi_slot=gi_slot, **kw,
    )
    if not queries:
        return None, None
    occs = shadow_occlusion_batch(cam, queries, prepped, **kw)

    occl = None
    if n_soft:
        occ_sum = torch.zeros_like(q[..., 0])
        for occluded in occs[:n_soft]:
            occ_sum = occ_sum + _occlusion_quotient(occluded)
        div = 1 if jitter_k is not None else max(1, soft_k)
        occl = occ_sum / torch.full_like(occ_sum, float(div))

    gi_rgb = None
    if gi:
        light = device_vec(cam[P_LIGHT : P_LIGHT + 3], dev)
        o = device_vec(cam[P_O : P_O + 3], dev)
        lmag3 = torch.full_like(q, float(cam[P_LMAG]))
        emis = device_vec(cam[P_EMIS : P_EMIS + 3] * cam[P_EMISS], dev)
        shade = _shader(cam, n)
        slot_states = cell_state_batch(
            [(n_cl, ok_geo) for n_cl, _, _, ok_geo in slots], prepped, **kw
        )
        total = torch.zeros_like(q)
        for (n_cl, n_origin, n_point, ok_geo), st, occluded in zip(
            slots, slot_states, occs[n_soft:]
        ):
            ok = ok_geo & (st == 1)
            reflected = _occlusion_quotient(occluded)[..., None] * shade(
                n_point, n_origin, n_cl, q, lmag3, light
            ) + emis
            bounce = shade(q, origin, coords, o, reflected, n_point)
            total = total + torch.where(ok[..., None], bounce, 0.0)
        if gi_slot is not None:
            total = total * 4.0  # unbiased 1-of-4 estimator
        gi_rgb = total

    return occl, gi_rgb


# ------------------------------------------------------- sliced frame ---


def raytrace_sliced(vol, cam, ages=None, *, grid_size, width, height,
                    shadow=True, total_states=2, soft_shadow_samples=1,
                    indirect=False, indirect_bounces=1, sample_idx=None):
    """One frame of any grid up to 1024³ (render_slab.raytrace_sliced):
    (light_rgb [H, W, 3], depth [H, W], hit_idx [H, W] int32; −1 = miss),
    without emissive light (the caller adds it).  ``ages`` /
    ``total_states``: the age bit-planes of a multi-state rule, of which
    ``vol`` is the visibility plane; K4 then also returns each hit's age,
    whose fade ``clip((S − age)/(S − 1), 0, 1)`` multiplies the direct term
    (the occlusion quotient) and not the GI added after it.

    K4 finds the primary hits; the hard shadow (``soft_shadow_samples`` ≤
    1), the soft-shadow samples and the GI slots ride one K2 launch and the
    GI lookups one K3 launch (:func:`lighting_passes`), or, for
    ``indirect_bounces`` > 1, :func:`direct_occlusion` and
    :func:`indirect_bounce`; the direct light is the reference's
    Cook-Torrance BRDF in torch.  ``sample_idx``: the frame counter of the
    temporally amortized mode, which evaluates one rotating soft-shadow
    sample and one GI slot per frame (one bounce)."""
    n = grid_size
    cam = _check_sliced(n, width, height, cam)
    kw = dict(grid_size=n, width=width, height=height)
    prepped = prep_volume(vol)
    if ages is not None:
        _check_ages(ages, vol, total_states)
    t_img, idx, *age_img = primary_hits(cam, prepped, ages, **kw)
    q, origin, coords, found, tf_miss = hit_geometry(cam, idx, t_img, **kw)
    depth = torch.where(found, t_img, tf_miss)

    gi_slot, gi_bounces, jitter_k = None, indirect_bounces, None
    if indirect and sample_idx is not None:
        gi_slot, gi_bounces = sample_idx % 4, 1
    if shadow and sample_idx is not None and soft_shadow_samples > 1:
        jitter_k = sample_idx % soft_shadow_samples

    gi_rgb = None
    if not indirect or gi_bounces == 1:
        # Single-bounce configurations: every occlusion query in one launch.
        occl, gi_rgb = lighting_passes(
            cam, q, origin, coords, found, prepped,
            soft_k=soft_shadow_samples if shadow else None, jitter_k=jitter_k,
            gi=indirect, gi_slot=gi_slot, **kw,
        )
    else:
        occl = (
            direct_occlusion(cam, q, coords, found, prepped,
                             soft_k=soft_shadow_samples, jitter_k=jitter_k, **kw)
            if shadow else None
        )
        gi_rgb = indirect_bounce(vol, cam, q, origin, coords, found, prepped,
                                 bounces=gi_bounces, slot=gi_slot, **kw)

    light = device_vec(cam[P_LIGHT : P_LIGHT + 3], q.device)
    o = device_vec(cam[P_O : P_O + 3], q.device)
    color = _shader(cam, n)(q, origin, coords, o,
                            torch.full_like(q, float(cam[P_LMAG])), light)
    out = torch.clamp(color, min=0.0)
    if age_img:
        fade = _age_fade(age_img[0], total_states)
        occl = fade if occl is None else occl * fade
    if occl is not None:
        out = out * occl[..., None]
    if gi_rgb is not None:
        out = out + gi_rgb
    return torch.where(found[..., None], out, 0.0), depth, idx
