"""The sliced fast path (grids above 256³, up to 1024³) and the extended
lighting at every grid size: soft shadows and GI.

Port of ``cellularautomatons3d_tpu.render.render_slab``: the primary pass
of a frame (kernel K4), the hit geometry of a traced frame, the
soft-shadow jitter, batched cell-exact occlusion (kernel K2), batched
cell-state lookups (kernel K3), the direct-light occlusion quotient, the
recursive indirect bounce, the lighting passes, and
:func:`raytrace_sliced`, the whole frame of a grid that K1 does not take.

On the card one launch traces the whole volume of any grid up to 1024³
(128 MiB of packed words at 1024³), so the reference's z-slab / x-brick
machinery does not come across: ``slab_extent``, ``brick_layout`` and its
test overrides (``slab_planes``, ``x_chunk_cells``), ``SlabGroup``,
``prep_slabs``, ``_scan_bricks``, the brick skip and visibility conds, the
min-t composite over bricks with its cross-brick best-t carry, and the
view-dependent brick-order flip are TPU VMEM layout, not kernels.
``prepped`` is the packed volume (for a multi-state rule its visibility
plane, age ≥ 1; the age bit-planes go to K4 and nowhere else), its
coarse occupancy mip and the mip's occupied box (:func:`prep_volume`);
images are ``[H, W]`` / ``[H, W, 3]`` in image order.  Exact-t ties
between distinct cells, where the reference keeps the first brick
processed, keep the first cell in plane order here.

Six kernels, each with a plain torch version of the same contract that
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
  ``csrc/cell_state.cu``);
* the queries kernel (:func:`lighting_queries_stacked` /
  :func:`lighting_queries_cuda`, ``csrc/lighting_queries.cu``): from a
  frame's primary hits, its hit geometry, soft-shadow jitter and GI slot
  geometry as K2's stacked operands, whose slot rows K3 reads in place;
  its level mode (:func:`lighting_level_stacked` /
  :func:`lighting_level_cuda`) writes a deeper level of the GI tree from
  the states of the levels above;
* the shade kernel (:func:`lighting_shade` / :func:`lighting_shade_cuda`,
  ``csrc/lighting_shade.cu``): the occlusion quotient, the GI (one bounce,
  or the tree of b bounces bottom up), the sliced frame's direct light and
  the fused loop's composition.

Every lighting frame is :func:`lighting_passes`: queries, K3 on level 1
(and for each deeper level a level-mode launch, then K3), K2 (or K5) on
every query, shade -- four launches a one-bounce frame on the card, seven a
two-bounce one -- where JAX fuses the XLA geometry and shading around its
kernels under ``jit`` and recurses level by level (:func:`indirect_bounce`,
which no frame path runs here: it is the tests' oracle of the tree).

K4, K2 and K5 are clipped on the card to the box of occupied blocks,
``prepped.box`` (plain twin ``ops.occupancy.occupied_box``), which the
occupancy rebuild's one launch (``csrc/coarse_occupancy.cu``) writes beside
the mip, once a frame for all of them; the plain versions clip nothing.
K2 takes its queries stacked by :func:`stack_occlusion_queries`; K5 and K3
take each query's tensors where the lighting passes leave them (start,
cells [H, W, 3], a target [H, W, 3] or the light's [3], active [H, W]),
through a table of pointers and strides (``csrc/queries.cuh``), and their
plain versions take the same queries stacked.

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
from ..utils import profiling
from ..utils.profiling import span
from ..ops.occupancy import (
    BOX_WORDS, coarse_shape, occupancy_mip_box, occupied_box, occupied_box_cuda)
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
    P_ALPHA,
    P_CELLMUL,
    P_EMIS,
    P_EMISS,
    P_GAMMA,
    P_LIGHT,
    P_LMAG,
    P_LRAD,
    P_MATC,
    P_O,
    P_OVERLAY,
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
    "gated_lanes",
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
    "indirect_bounce",
    "lighting_queries",
    "Lighting",
    "MAX_LIGHTING_QUERIES",
    "lighting_queries_stacked",
    "lighting_queries_cuda",
    "occlusion_flags",
    "slot_states",
    "lighting_level_stacked",
    "lighting_level_cuda",
    "gi_states",
    "MAX_CARD_BOUNCES",
    "ema",
    "finish_frame",
    "lighting_shade",
    "lighting_shade_cuda",
    "lighting_passes",
]


MAX_SLICED_GRID = 1024  # reference UI ceiling (main_pathtraced.js:274-277)


class Prepped(NamedTuple):
    """The volume as the traced passes take it."""

    vol: torch.Tensor     # packed words int32 [n/32, n, n]
    coarse: torch.Tensor  # coarse occupancy mip int32 [n/8, XG·n/8] (the skip)
    box: torch.Tensor     # its occupied box int32 [8] (the clip of K2, K4, K5)


def prep_volume(packed: torch.Tensor, coarse: torch.Tensor | None = None) -> Prepped:
    """The whole-volume counterpart of the reference's ``prep_slabs``: the
    mip and its box from :func:`~..ops.occupancy.occupancy_mip_box` (on the
    card one launch for both), or, for a mip the caller brings, its box alone
    (on the card one launch of ``csrc/occupied_box.cu``)."""
    if coarse is None:
        return Prepped(packed, *occupancy_mip_box(packed))
    n = packed.shape[-1]
    if coarse.device.type == "cpu":
        return Prepped(packed, coarse, occupied_box(coarse, n))
    return Prepped(packed, coarse, occupied_box_cuda(coarse, n))


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


def _require_box(box, vol):
    """The sweeps' box operand: the int32 [8] ``OccBox`` of the mip, a
    contiguous CUDA tensor on the volume's device."""
    kernels.require(box, "box", torch.int32, (BOX_WORDS,))
    if box.device != vol.device:
        raise ValueError(f"box must be on the volume's device {vol.device}, got {box.device}")


def primary_sweep_cuda(vol, coarse, box, cam, ages=None, *, grid_size, width, height,
                       column_skip=True):
    """K4 on the card (``csrc/primary_sweep.cu``): same contract as
    :func:`primary_sweep`; ``vol``, ``coarse``, ``box`` (the mip's occupied
    box, ``Prepped.box``) and ``ages`` must be contiguous CUDA tensors
    (``coarse`` 16-byte aligned).  One launch.  ``column_skip=False``
    descends every column of the occupied box (the same hits; the
    attribution run of the coarse column skip, which no frame path makes),
    also counted in ``primary_sweep_cuda.noskip_launches``."""
    cam = _check_sliced(grid_size, width, height, cam)
    n = grid_size
    kernels.require(vol, "vol", torch.int32, (n // 32, n, n))
    kernels.require(coarse, "coarse", torch.int32, coarse_shape(n), align=16)
    _require_box(box, vol)
    t = torch.empty((height, width), dtype=torch.float32, device=vol.device)
    idx = torch.empty((height, width), dtype=torch.int32, device=vol.device)
    age, age_bits = None, 0
    if ages is not None:
        _check_ages(ages, vol)
        age_bits = ages.shape[0]
        kernels.require(ages, "ages", torch.int32, (age_bits, n // 32, n, n))
        age = torch.empty((height, width), dtype=torch.int32, device=vol.device)
    err = kernels.library().ca3d_primary_sweep_ages(
        vol.device.index or 0, vol.data_ptr(), coarse.data_ptr(), n, width,
        height, cam.ctypes.data, t.data_ptr(), idx.data_ptr(),
        None if ages is None else ages.data_ptr(), age_bits,
        None if age is None else age.data_ptr(), int(bool(column_skip)), box.data_ptr(),
        kernels.stream_of(vol),
    )
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
    return primary_sweep_cuda(prepped.vol, prepped.coarse, prepped.box, cam, ages, **kw)


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


def _miss_depth(cam, d):
    """The volume exit depth [H, W] of the rays along ``d`` [H, W, 3] that
    cross the volume, 0 elsewhere (hit_geometry's ``tf_miss``)."""
    o = np.asarray(cam[P_O : P_O + 3], np.float32)
    t1 = torch.stack([torch.full_like(d[..., i], float(np.float32(-0.5) - o[i])) / d[..., i]
                      for i in range(3)], dim=-1)
    t2 = torch.stack([torch.full_like(d[..., i], float(np.float32(0.5) - o[i])) / d[..., i]
                      for i in range(3)], dim=-1)
    tf = torch.amin(torch.maximum(t1, t2), dim=-1)
    tn = torch.amax(torch.minimum(t1, t2), dim=-1)
    crossed = (tn <= tf) & (tf >= 0.0)
    return torch.where(crossed, tf, 0.0)


def hit_geometry(cam, idx_img, t_img, *, grid_size, width, height):
    """(q, origin, coords, found, tf_miss) from a traced hit image: the
    surface point, its cell's centre and integer coordinates (a miss, id -1,
    decodes to (n-1, n-1, -1)), the hit mask, and the volume exit depth of
    the rays that cross the volume (0 elsewhere)."""
    q, origin, coords, found, d = _hit_geometry(cam, idx_img, t_img, grid_size, width, height)
    return q, origin, coords, found, _miss_depth(cam, d)


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


def _check_gate(states, q_gate, nq, h, w):
    """Refuse a last-level gate K2 does not take: ``states`` uint8 [n_slots,
    H, W] with 1 ≤ n_slots ≤ nq (query q ≥ n_soft = nq − n_slots reads row
    q − n_soft) and ``q_gate`` in [n_soft, nq], both or neither given.
    Reads shapes and dtypes only, so it raises before any kernel loads."""
    if states is None and q_gate is None:
        return
    if states is None or q_gate is None:
        raise ValueError("states and q_gate go together")
    if states.dtype != torch.uint8:
        raise ValueError(f"states must be torch.uint8, got {states.dtype}")
    if states.dim() != 3 or tuple(states.shape[1:]) != (h, w) or not 1 <= states.shape[0] <= nq:
        raise ValueError(f"states must have shape [n_slots, {h}, {w}] with 1 <= n_slots <= "
                         f"{nq}, got {tuple(states.shape)}")
    n_soft = nq - states.shape[0]
    if not n_soft <= q_gate <= nq:
        raise ValueError(f"q_gate must be in [{n_soft}, {nq}], got {q_gate}")


def gated_lanes(active, states=None, q_gate=None):
    """K2's traced lanes: ``active`` (bool [nq, H, W]), from row ``q_gate``
    on only where the GI state of the row's slot (``states`` row q − n_soft)
    is 1 -- the shade kernel's test before it reads a slot's flag; without
    ``states``, ``active`` itself."""
    if states is None:
        return active
    n_soft = active.shape[0] - states.shape[0]
    gated = active.clone()
    gated[q_gate:] &= states[q_gate - n_soft:] == 1
    return gated


def shadow_sweep(vol, start, target, excl, active, *, grid_size, cell_half, states=None,
                 q_gate=None):
    """Plain torch K2: occluded flags int32 [nq, H, W] of the shadow rays
    from ``start`` toward ``target`` (f32 [nq, 3, H, W]) over t in [0,
    volume exit], skipping the cell ``excl`` (int32 [nq, 3, H, W]) component
    by component; untraced lanes give 0: inactive lanes (``active`` bool
    [nq, H, W]) and, with ``states`` and ``q_gate`` (a multi-bounce frame's
    GI states, :func:`gated_lanes`), the last level's lanes of dead
    neighbours.  While a profiler records it counts the traced lanes, as
    the kernel does (``utils.profiling.work_counts``)."""
    _check_gate(states, q_gate, *active.shape)
    active = gated_lanes(active, states, q_gate)
    if profiling.recording():
        profiling.count("occlusion_lanes", active.sum())
    return _occlusion(vol, start, target, active, tuple(excl.unbind(1)),
                      grid_size, cell_half)


def shadow_sweep_cuda(vol, coarse, box, start, target, excl, active, *, grid_size,
                      cell_half, states=None, q_gate=None, column_skip=True, out=None,
                      _tiles=0):
    """K2 on the card (``csrc/shadow_sweep.cu``): same contract as
    :func:`shadow_sweep`; every tensor, ``box`` (the mip's occupied box,
    ``Prepped.box``) too, must be a contiguous CUDA tensor (``coarse``
    16-byte aligned).  One launch.  ``column_skip=False`` descends every
    column of the occupied box (the same flags; the attribution run of the
    coarse column skip, which no frame path makes), also counted in
    ``shadow_sweep_cuda.noskip_launches``.  A gate (``states``) runs in the
    strip kernel, 8 16×8 tiles a block, which always skips columns; an
    ungated launch takes it where its tile count fills the card, else the
    tile kernel, a block a tile.  ``_tiles``, a hook for tests and the
    tools' attribution that no frame path sets: 1 or 8 asks for the tile or
    the strip kernel.  While a profiler records the launch adds its traced
    lanes to the device's ``occlusion_lanes``
    (``utils.profiling.work_counts``)."""
    n = grid_size
    nq, _, h, w = start.shape
    _check_gate(states, q_gate, nq, h, w)
    if _tiles not in (0, 1, 8):
        raise ValueError(f"_tiles must be 0, 1 or 8, got {_tiles}")
    if (states is not None and (_tiles == 1 or not column_skip)) or (
            _tiles == 8 and not column_skip):
        raise ValueError("the gate and _tiles=8 run in the strip kernel, which skips columns; "
                         "_tiles=1 and column_skip=False in the tile kernel, which takes no gate")
    kernels.require(vol, "vol", torch.int32, (n // 32, n, n))
    kernels.require(coarse, "coarse", torch.int32, coarse_shape(n), align=16)
    _require_box(box, vol)
    kernels.require(start, "start", torch.float32, (nq, 3, h, w))
    kernels.require(target, "target", torch.float32, (nq, 3, h, w))
    kernels.require(excl, "excl", torch.int32, (nq, 3, h, w))
    kernels.require(active, "active", torch.bool, (nq, h, w))
    if states is not None:
        kernels.require(states, "states", torch.uint8, tuple(states.shape))
    out = _flags_out(out, nq, h, w, start.device)
    err = kernels.library().ca3d_shadow_sweep(
        start.device.index or 0, vol.data_ptr(), coarse.data_ptr(), n,
        float(cell_half), w, h, nq, start.data_ptr(), target.data_ptr(),
        excl.data_ptr(), active.data_ptr(), None if states is None else states.data_ptr(),
        0 if q_gate is None else int(q_gate), nq - (0 if states is None else states.shape[0]),
        out.data_ptr(), int(bool(column_skip)), box.data_ptr(), int(_tiles),
        int(profiling.recording()), kernels.stream_of(start),
    )
    kernels.check(err, "shadow_sweep")
    shadow_sweep_cuda.launches += 1
    shadow_sweep_cuda.noskip_launches += int(not column_skip)
    return out


shadow_sweep_cuda.launches = 0
shadow_sweep_cuda.noskip_launches = 0


def _flags_out(out, nq, h, w, device):
    """The flags tensor of an occlusion launch: ``out`` checked, or a new
    one."""
    if out is None:
        return torch.empty((nq, h, w), dtype=torch.int32, device=device)
    kernels.require(out, "out", torch.int32, (nq, h, w))
    return out


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


def shadow_sweep_multi_cuda(vol, coarse, box, start, target, excl, active, *,
                            grid_size, cell_half, out=None):
    """K5 on the card (``csrc/shadow_multi.cu``): :func:`shadow_sweep_multi`'s
    flags int32 [nq, H, W] of 1 to 8 queries given where the lighting passes
    leave them: ``start``, ``target``, ``excl`` and ``active`` are
    sequences of nq tensors (or tensors with nq rows), start f32 [H, W, 3],
    target f32 [H, W, 3] or [3], excl int32 or int64 [H, W, 3] (the cell
    the ray skips; none when a coordinate is outside [0, n), as
    :func:`pack_exclusion` gives −1), active bool [H, W]; all CUDA tensors
    (``vol`` and ``active`` contiguous, ``coarse`` 16-byte aligned), the
    vector operands with rows of W pixels; ``box`` is the mip's occupied box
    (``Prepped.box``), a contiguous CUDA int32 [8].  One launch.  ``out``: as
    :func:`shadow_sweep_cuda`'s."""
    n = grid_size
    nq = len(start)
    if not 1 <= nq <= MAX_MULTI_QUERIES:
        raise ValueError(f"K5 takes 1 to {MAX_MULTI_QUERIES} queries, got {nq}")
    if not len(target) == len(excl) == len(active) == nq:
        raise ValueError("start, target, excl and active must hold one entry per query")
    kernels.require(vol, "vol", torch.int32, (n // 32, n, n))
    kernels.require(coarse, "coarse", torch.int32, coarse_shape(n), align=16)
    _require_box(box, vol)
    h, w = active[0].shape
    rows = []
    for i in range(nq):
        rows += _pixel_operand(start[i], f"start[{i}]", h, w, (torch.float32,))
        rows += _pixel_operand(target[i], f"target[{i}]", h, w, (torch.float32,),
                               shared=True)
        rows += _pixel_operand(excl[i], f"excl[{i}]", h, w, _CELL_TYPES)
        rows += [excl[i].dtype == torch.int64, _mask_pointer(active[i], f"active[{i}]", h, w)]
    out = _flags_out(out, nq, h, w, vol.device)
    err = kernels.library().ca3d_shadow_multi(
        vol.device.index or 0, vol.data_ptr(), coarse.data_ptr(), n,
        float(cell_half), w, h, nq, _query_table(rows), out.data_ptr(),
        box.data_ptr(), kernels.stream_of(vol),
    )
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


def _occlusion_k2(prepped, ops, kw, out=None, states=None, q_gate=None):
    """K2's flags of stacked queries ``ops``, gated by ``states`` from row
    ``q_gate`` on where given: the kernel, or for CPU tensors the plain K2."""
    gate = dict(states=states, q_gate=q_gate)
    if ops[0].device.type == "cpu":
        return shadow_sweep(prepped.vol, *ops, **kw, **gate)
    return shadow_sweep_cuda(prepped.vol, prepped.coarse, prepped.box, *ops, out=out, **kw,
                             **gate)


def _occlusion_k5(prepped, queries, kw, width, height):
    """K5's flags of a chunk of queries: the kernel on the queries' own
    tensors, or for CPU tensors the plain K5 on them stacked."""
    if queries[0][0].device.type == "cpu":
        start, target, excl, active = stack_occlusion_queries(queries, width, height)
        exid = pack_exclusion(excl, kw["grid_size"])
        return shadow_sweep_multi(prepped.vol, start, target, exid, active, **kw)
    return shadow_sweep_multi_cuda(prepped.vol, prepped.coarse, prepped.box,
                                   *zip(*queries), **kw)


def _occlusion_backend():
    """The occlusion backend of the environment, read on every call: (every
    query to K2, K5's chunk size, a chunk of one to K2) from
    ``CA3D_OCC_SWEEP``, ``CA3D_OCC_NQ`` and ``CA3D_OCC_NQ1_SWEEP``."""
    return (os.environ.get("CA3D_OCC_SWEEP", "1") == "1",
            int(os.environ.get("CA3D_OCC_NQ", "4")),
            os.environ.get("CA3D_OCC_NQ1_SWEEP", "1") == "1")


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
    all_k2, nq_max, nq1_sweep = _occlusion_backend()
    if all_k2:
        ops = stack_occlusion_queries(queries, width, height)
        return list(_occlusion_k2(prepped, ops, kw) == 1)
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


def cell_state_cuda(vol, coords, active, *, grid_size, out=None):
    """K3 on the card (``csrc/cell_state.cu``): :func:`cell_state`'s states
    uint8 [nq, H, W] of 1 to 8 lookups given where the lighting passes leave
    them: ``coords`` and ``active`` are sequences of nq tensors (or tensors
    with nq rows), coords int32 or int64 [H, W, 3] with rows of W pixels,
    active bool [H, W]; all CUDA tensors (``vol`` and ``active``
    contiguous).  ``out``: a contiguous uint8 [nq, H, W] tensor to write the
    states into (rows of a larger one), or None for a new one."""
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
    if out is None:
        out = torch.empty((nq, h, w), dtype=torch.uint8, device=vol.device)
    kernels.require(out, "out", torch.uint8, (nq, h, w))
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


def _gi_slots(cam, n, q, origin, coords, found, gi_slot=None):
    """The GI slots' geometry of a surface point ``q`` on the cell centred at
    ``origin`` with coordinates ``coords`` (the hit, or a slot of the GI
    tree), active where ``found``: :func:`_slot_geometry` of the 4 slots of
    its face, or of the temporal mode's one ``gi_slot``."""
    layers = _layers(q.device)
    face = _face_index(cube_face_normal(q, origin))
    if gi_slot is None:
        offs = [layers[:, i, :][face] for i in range(4)]
    else:
        offs = [layers[:, gi_slot, :][face]]
    return [_slot_geometry(cam, n, q, coords, off, found) for off in offs]


def _soft_occlusion(occs, div):
    """The direct-light occlusion quotient [H, W]: the queries' quotients
    summed from 0 in order, then divided by ``div``."""
    occ_sum = torch.zeros(occs[0].shape, dtype=torch.float32, device=occs[0].device)
    for occluded in occs:
        occ_sum = occ_sum + _occlusion_quotient(occluded)
    return occ_sum / torch.full_like(occ_sum, float(div))


def indirect_bounce(vol, cam, q, origin, coords, found, prepped, *, grid_size,
                    width, height, bounces=1, slot=None):
    """Indirect GI (wgsl:307-377; renderer._indirect_lighting with the
    stochastic shadow march replaced by cell-exact occlusion), each level's
    4 neighbour slots batched into one K3 and one K2 launch.  ``bounces``
    > 1 recursively adds each neighbour's own indirect term (4^b occlusion
    queries).  ``slot``: the temporally amortized mode's single slot (int
    or int tensor), scaled ×4, an unbiased estimate of the 4-slot sum;
    requires ``bounces == 1``.  Returns rgb [H, W, 3].  (``vol`` is unused,
    as in the reference.)  No frame path runs it: every frame's GI is
    :func:`lighting_passes`'s, whose level-mode twins the tests hold to this
    recursion."""
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
    """The occlusion queries of the lighting passes: (queries, slots,
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

    slots = _gi_slots(cam, n, q, origin, coords, found, gi_slot) if gi else []
    for n_cl, _, n_point, ok in slots:
        queries.append((n_point, light, n_cl, ok))
    return queries, slots, n_soft


# ------------------------------------ the lighting passes' two kernels ---

# Queries a frame's lighting passes may hold: K2's limit (its grid's z).
MAX_LIGHTING_QUERIES = 65535


class Lighting(NamedTuple):
    """What a frame's lighting passes evaluate.

    ``soft_k``: the direct-shadow queries -- None for none, 1 (or less) for
    the hard shadow toward the light, k > 1 for k jittered area-light
    samples averaged; ``jitter_k``: the temporally amortized mode's one
    rotating sample in [0, soft_k) (an int or an int tensor, read on the
    card by the kernels), whose quotient is not divided.  ``gi``: GI over
    the hit face's 4 neighbour slots; ``gi_slot``: the temporal mode's one
    slot (int or int tensor), scaled ×4; ``bounces``: the GI recursion's
    depth b (JAX's ``indirect_bounce``): level k of the tree holds 4^k
    slots, the children of level k − 1's slot p at 4p .. 4p + 3
    (:meth:`level_span`), one query row each after the direct-shadow rows."""

    soft_k: int | None = None
    jitter_k: object = None
    gi: bool = False
    gi_slot: object = None
    bounces: int = 1

    @property
    def n_soft(self) -> int:
        if self.soft_k is None:
            return 0
        return 1 if self.jitter_k is not None else max(1, self.soft_k)

    @property
    def n_slots(self) -> int:
        """The GI rows: every level's slots, or the temporal mode's one."""
        if not self.gi:
            return 0
        return 1 if self.gi_slot is not None else self.level_span(self.bounces + 1)[0]

    @property
    def nq(self) -> int:
        return self.n_soft + self.n_slots

    @staticmethod
    def level_span(k: int) -> tuple[int, int]:
        """(first row, rows) of the GI tree's level k among the GI rows:
        (4^k − 4) / 3 and 4^k (``csrc/shading.cuh`` ``gi_level_start``)."""
        return (4**k - 4) // 3, 4**k

    @property
    def jitter_mode(self) -> int:
        """0: the hard shadow; 1: sample k is query k; 2: the one sample
        ``jitter_k``."""
        if self.jitter_k is not None:
            return 2
        return 1 if self.soft_k is not None and self.soft_k > 1 else 0

    @property
    def occ_div(self) -> int:
        return 1 if self.jitter_k is not None else max(1, self.soft_k or 1)


# The GI recursion's depth the card's kernels take (csrc/shading.cuh
# kMaxBounces): 340 query rows a pixel at 4 bounces, ~25 GB of K2 operands
# at 1920×1080; 5 would take ~100 GB.
MAX_CARD_BOUNCES = 4


def _check_bounces(light: Lighting) -> None:
    if int(light.bounces) < 1:
        raise ValueError(f"bounces must be >= 1, got {light.bounces}")
    if light.gi and light.gi_slot is not None and light.bounces > 1:
        raise ValueError("temporal slot sampling requires bounces == 1")


def _check_card_bounces(light: Lighting) -> None:
    _check_bounces(light)
    if light.gi and light.bounces > MAX_CARD_BOUNCES:
        raise ValueError(f"the lighting kernels take at most {MAX_CARD_BOUNCES} bounces, "
                         f"got {light.bounces}")


def _light_consts(cam, n: int, light: Lighting) -> np.ndarray:
    """The host-rounded float32 constants of the lighting kernels
    (``csrc/shading.cuh`` ``LightConsts``), each rounded as the torch twins
    round it."""
    f = np.float32
    cell = f(FULL_CUBE_SIZE / n)
    t = f(cam[P_TIME])
    r = f(cam[P_ROUGH])
    a2 = r * r
    nn = r + f(1.0)
    kd = (nn * nn) / f(8.0)
    refl = np.asarray(cam[P_REFL : P_REFL + 3], f)
    consts = np.concatenate([
        [cell, cell * f(0.5), f(_cell_half(cam, n)), f(0.07) * (t - np.floor(t)),
         f(2.0) * f(cam[P_LRAD]), a2, a2 - f(1.0), kd, f(1.0) - kd],
        refl, f(1.0) - refl, cam[P_MATC : P_MATC + 3], cam[P_EMIS : P_EMIS + 3] * cam[P_EMISS],
        [f(n), f(light.occ_div), f(1.0) / f(cam[P_GAMMA])],
    ]).astype(f)
    assert consts.shape == (24,)
    return consts


def _sample_operand(v, name, device):
    """(device int64 scalar or None, host int) of a temporal index: an int
    goes to the kernel as a value, a tensor as its address (read there, no
    host sync)."""
    if v is None or isinstance(v, (int, np.integer)):
        return None, 0 if v is None else int(v)
    if not isinstance(v, torch.Tensor) or v.numel() != 1 or v.dtype.is_floating_point:
        raise ValueError(f"{name} must be an int or a one-element integer tensor, got {v!r}")
    if v.device != device:
        raise ValueError(f"{name} must be on {device}, got {v.device}")
    return v.reshape(()).to(torch.int64), 0


def _check_hits(idx, t, width, height):
    kernels.require(idx, "idx", torch.int32, (height, width))
    kernels.require(t, "t", torch.float32, (height, width))


def lighting_queries_stacked(cam, idx, t, light: Lighting, *, grid_size, width, height):
    """Plain twin of the queries kernel: the occlusion operands of a
    frame's lighting passes, stacked for K2 -- (start, target, excl,
    active), [nq, 3, H, W] float32, float32, int32 and [nq, H, W] bool --
    from its primary hits (``idx`` int32 [H, W], -1 = miss, and ``t``
    float32 [H, W], K1's depth or K4's t): :func:`_hit_geometry`,
    :func:`lighting_queries` and :func:`stack_occlusion_queries`.  The GI
    slots' rows double as K3's lookups (cells and masks).  With ``bounces``
    > 1 it holds every level's rows, those below level 1 masked off until
    :func:`lighting_level_stacked` writes them."""
    _check_bounces(light)
    kw = dict(grid_size=grid_size, width=width, height=height)
    q, origin, coords, found, _ = _hit_geometry(cam, idx, t, grid_size, width, height)
    queries, _, _ = lighting_queries(
        cam, q, origin, coords, found, soft_k=light.soft_k, jitter_k=light.jitter_k,
        gi=light.gi, gi_slot=light.gi_slot, **kw)
    ops = stack_occlusion_queries(queries, width, height)
    deeper = light.nq - len(queries)  # the rows of GI levels 2..b, masks off
    if deeper:
        ops = tuple(torch.cat([op, op.new_zeros((deeper, *op.shape[1:]))]) for op in ops)
    return ops


def lighting_queries_cuda(cam, idx, t, light: Lighting, *, grid_size, width, height):
    """The queries kernel on the card (``csrc/lighting_queries.cu``): the
    operands of :func:`lighting_queries_stacked` in one launch, the masks
    bit for bit and the start, target and excluded cell bit for bit on the
    active lanes, the only ones K2, K5 and K3 read (elsewhere they are left
    unwritten).  ``idx`` and ``t`` must be contiguous CUDA tensors; a
    temporal index given as a tensor is read on the card.  With
    ``bounces`` > 1 it allocates every level's rows and writes level 1's;
    :func:`lighting_level_cuda` writes the others."""
    cam = _check_sliced(grid_size, width, height, cam)
    _check_card_bounces(light)
    n, nq = grid_size, light.nq
    _check_hits(idx, t, width, height)
    if not 1 <= nq <= MAX_LIGHTING_QUERIES:
        raise ValueError(f"the queries kernel takes 1 to {MAX_LIGHTING_QUERIES} queries, "
                         f"got {nq}")
    dev = idx.device
    sample_k, jk = _sample_operand(light.jitter_k, "jitter_k", dev)
    sample_slot, gs = _sample_operand(light.gi_slot, "gi_slot", dev)
    if light.n_slots == 1 and sample_slot is None and not 0 <= gs < 4:
        raise ValueError(f"gi_slot must be in [0, 4), got {gs}")
    start = torch.empty((nq, 3, height, width), dtype=torch.float32, device=dev)
    target = torch.empty_like(start)
    excl = torch.empty((nq, 3, height, width), dtype=torch.int32, device=dev)
    active = torch.empty((nq, height, width), dtype=torch.bool, device=dev)
    consts = _light_consts(cam, n, light)
    err = kernels.library().ca3d_lighting_queries(
        dev.index or 0, cam.ctypes.data, consts.ctypes.data, n, width, height, light.n_soft,
        light.jitter_mode, jk, min(light.n_slots, 4), gs,
        None if sample_k is None else sample_k.data_ptr(),
        None if sample_slot is None else sample_slot.data_ptr(),
        idx.data_ptr(), t.data_ptr(), start.data_ptr(), target.data_ptr(), excl.data_ptr(),
        active.data_ptr(), kernels.stream_of(idx))
    kernels.check(err, "lighting_queries")
    lighting_queries_cuda.launches += 1
    return start, target, excl, active


lighting_queries_cuda.launches = 0


def _queries(cam, idx, t, light: Lighting, **kw):
    """The queries kernel, or for CPU tensors its twin."""
    cpu = idx.device.type == "cpu"
    return (lighting_queries_stacked if cpu else lighting_queries_cuda)(cam, idx, t, light, **kw)


def occlusion_flags(cam, ops, prepped: Prepped, *, grid_size, states=None, q_gate=None):
    """The occluded flags int32 [nq, H, W] of stacked queries ``ops`` (K2's
    operands), with :func:`shadow_occlusion_batch`'s backends: K2 on the
    whole batch, or with ``CA3D_OCC_SWEEP`` other than ``1`` chunks of
    ``CA3D_OCC_NQ`` queries, each to K5 on the batch's [3, H, W] rows in
    place (or K2, for a chunk of one under ``CA3D_OCC_NQ1_SWEEP``), written
    into one flags tensor.  ``states`` and ``q_gate``: K2's last-level gate
    (:func:`gated_lanes`), which a multi-bounce frame gives once its states
    exist; the chunked backends trace those lanes ungated (the flags the
    shade reads are the same)."""
    n = grid_size
    kw = dict(grid_size=n, cell_half=_cell_half(cam, n))
    all_k2, nq_max, nq1_sweep = _occlusion_backend()
    if all_k2:
        return _occlusion_k2(prepped, ops, kw, states=states, q_gate=q_gate)
    nq, _, h, w = ops[0].shape
    cpu = ops[0].device.type == "cpu"
    out = None if cpu else torch.empty((nq, h, w), dtype=torch.int32, device=ops[0].device)
    parts = []
    for i in range(0, nq, nq_max):
        j = min(i + nq_max, nq)
        chunk = tuple(op[i:j] for op in ops)
        if j - i == 1 and nq1_sweep:
            parts.append(_occlusion_k2(prepped, chunk, kw, out=None if cpu else out[i:j]))
        elif cpu:
            parts.append(shadow_sweep_multi(prepped.vol, chunk[0], chunk[1],
                                            pack_exclusion(chunk[2], n), chunk[3], **kw))
        else:
            shadow_sweep_multi_cuda(
                prepped.vol, prepped.coarse, prepped.box,
                *([row.movedim(0, -1) for row in op] for op in chunk[:3]), list(chunk[3]),
                out=out[i:j], **kw)
    return torch.cat(parts) if cpu else out


def slot_states(ops, n_soft, prepped: Prepped, *, grid_size, rows=None, out=None):
    """The GI slots' neighbour states uint8 [n_slots, H, W]: K3 on the
    slots' rows of the stacked queries (their excluded cells and masks,
    after the ``n_soft`` direct-shadow rows), read in place on the card, 8
    a launch.  ``rows``: a slice of the GI rows (one level of the tree),
    every GI row by default; ``out``: the uint8 rows to write (on the
    card)."""
    _, _, excl, active = ops
    rows = slice(None) if rows is None else rows
    cells, masks = excl[n_soft:][rows], active[n_soft:][rows]
    if cells.device.type == "cpu":
        return cell_state(prepped.vol, cells, masks, grid_size=grid_size)
    if out is None:
        out = torch.empty(masks.shape, dtype=torch.uint8, device=masks.device)
    for i in range(0, len(cells), MAX_MULTI_QUERIES):
        j = i + MAX_MULTI_QUERIES
        cell_state_cuda(prepped.vol, [c.movedim(0, -1) for c in cells[i:j]], list(masks[i:j]),
                        grid_size=grid_size, out=out[i:j])
    return out


def _slot_tree(cam, n, geo, states, levels):
    """The GI tree's slots of levels 1..``levels`` from the hit geometry
    ``geo`` (:func:`_hit_geometry`'s q, origin, coords, found): a list per
    level of its 4^k (n_cl, n_origin, n_point, ok), ok where the parent's
    slot is, the entry exists and the neighbour lives (``states``: uint8
    [n_slots, H, W], K3's states of those levels)."""
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
    """Plain twin of the queries kernel's level mode: into the stacked
    queries ``ops`` of a ``light.bounces``-bounce frame (in place), the rows
    of GI level ``level`` (2 ≤ level ≤ bounces) -- each slot's query from
    its entry point toward the light, excluding its clamped neighbour cell,
    active where its parent's slot is ok and its entry exists -- from the
    states of the levels above (``states``, K3's); and level ``level`` − 1's
    masks gated by their states (its slots' ok).  Returns ``ops``."""
    n = grid_size
    start, target, excl, active = ops
    geo = _hit_geometry(cam, idx, t, n, width, height)
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


def lighting_level_cuda(cam, idx, t, ops, states, light: Lighting, level, *, grid_size,
                        width, height):
    """The queries kernel's level mode on the card (``csrc/lighting_queries.cu``
    ``lighting_level_kernel``): :func:`lighting_level_stacked` in one launch,
    the masks bit for bit and the operands on the active lanes, into the
    buffers :func:`lighting_queries_cuda` allocated; every tensor a
    contiguous CUDA tensor."""
    cam = _check_sliced(grid_size, width, height, cam)
    _check_card_bounces(light)
    if not (light.gi and light.gi_slot is None and 2 <= level <= light.bounces):
        raise ValueError(f"level {level} is not a deeper level of {light}")
    n, nq, h, w = grid_size, light.nq, height, width
    _check_hits(idx, t, w, h)
    start, target, excl, active = ops
    kernels.require(start, "start", torch.float32, (nq, 3, h, w))
    kernels.require(target, "target", torch.float32, (nq, 3, h, w))
    kernels.require(excl, "excl", torch.int32, (nq, 3, h, w))
    kernels.require(active, "active", torch.bool, (nq, h, w))
    kernels.require(states, "states", torch.uint8, (light.n_slots, h, w))
    consts = _light_consts(cam, n, light)
    dev = idx.device
    err = kernels.library().ca3d_lighting_level(
        dev.index or 0, cam.ctypes.data, consts.ctypes.data, n, w, h, light.n_soft,
        light.bounces, level, idx.data_ptr(), t.data_ptr(), states.data_ptr(),
        start.data_ptr(), target.data_ptr(), excl.data_ptr(), active.data_ptr(),
        kernels.stream_of(idx))
    kernels.check(err, "lighting_level")
    lighting_level_cuda.launches += 1
    return ops


lighting_level_cuda.launches = 0

def gi_states(cam, idx, t, ops, prepped: Prepped, light: Lighting, *, grid_size, width, height):
    """The GI tree's neighbour states uint8 [n_slots, H, W] of a frame's
    stacked queries ``ops``, level by level: K3 on level k's rows (its
    lookups: the neighbour cells and masks), then, below the last level, the
    level-mode queries launch (:func:`lighting_level_cuda`, on the CPU its
    twin) that writes level k + 1's rows from those states and gates level
    k's masks by them.  The last level's masks stay ungated: K2 gates them
    itself by these states (:func:`occlusion_flags`' ``states``), a byte a
    lane inside its launch, where a gate launch would walk the whole tree
    again and cost more than K2 saves (PERF.md).  One bounce: K3 on the
    slots."""
    kw = dict(grid_size=grid_size, width=width, height=height)
    if light.bounces == 1:
        return slot_states(ops, light.n_soft, prepped, grid_size=grid_size)
    cpu = idx.device.type == "cpu"
    level_pass = lighting_level_stacked if cpu else lighting_level_cuda
    states = torch.empty((light.n_slots, height, width), dtype=torch.uint8, device=idx.device)
    for k in range(1, light.bounces + 1):
        r0, rows = Lighting.level_span(k)
        got = slot_states(ops, light.n_soft, prepped, grid_size=grid_size,
                          rows=slice(r0, r0 + rows), out=None if cpu else states[r0 : r0 + rows])
        if cpu:
            states[r0 : r0 + rows] = got
        if k < light.bounces:
            level_pass(cam, idx, t, ops, states, light, k + 1, **kw)
    return states


def _lighting_tail(cam, geo, idx, t, occl, gi_rgb, *, grid_size, rgb=None, age=None,
                   total_states=2, history=None):
    """The frame's light from its occlusion quotient ``occl`` [H, W] and GI
    ``gi_rgb`` [H, W, 3] (either None): :func:`lighting_shade`'s last steps,
    also the multi-bounce frames'.  ``geo``: :func:`_hit_geometry`'s output
    of the hits (``idx``, ``t``)."""
    q, origin, coords, found, d = geo
    dev = q.device
    if rgb is None:
        # raytrace_sliced: the direct light, faded and shadowed, plus the GI.
        light = device_vec(cam[P_LIGHT : P_LIGHT + 3], dev)
        o = device_vec(cam[P_O : P_O + 3], dev)
        color = _shader(cam, grid_size)(q, origin, coords, o,
                                        torch.full_like(q, float(cam[P_LMAG])), light)
        out = torch.clamp(color, min=0.0)
        if age is not None:
            fade = _age_fade(age, total_states)
            occl = fade if occl is None else occl * fade
        if occl is not None:
            out = out * occl[..., None]
        if gi_rgb is not None:
            out = out + gi_rgb
        out = torch.where(found[..., None], out, 0.0)
        depth = torch.where(found, t, _miss_depth(cam, d))
    else:
        # K1's frame: its unshadowed (age-faded) light times the quotient.
        out, depth = rgb, t
        if occl is not None:
            out = out * occl[..., None]
        if gi_rgb is not None:
            out = out + torch.where(found[..., None], gi_rgb, 0.0)
    emis = device_vec(cam[P_EMIS : P_EMIS + 3] * cam[P_EMISS], dev)
    out = torch.where(found[..., None], out + emis, out)
    if history is None:
        return out if rgb is not None else (out, depth)

    # The fused loop's composition (_ext_frame_blocked): the id-checked EMA
    # against the f32 history, then the light cube, the depth overlay, gamma.
    prev, prev_idx = history
    out = ema(out, prev, (idx == prev_idx) & found, cam[P_ALPHA])
    ux, _ = _pixel_uv(cam, d.shape[1], d.shape[0], dev)
    return finish_frame(out, depth, cam[P_O : P_O + 3], d, cam[P_LIGHT : P_LIGHT + 3], ux,
                        cam[P_OVERLAY], cam[P_GAMMA])


def ema(rgb, prev, same, alpha):
    """The temporal EMA (wgsl:429-471): ``clamp(prev + (rgb − prev) · α, 0,
    1)`` where ``same`` (the history holds this pixel's cell), else ``rgb``."""
    mixed = torch.clamp(prev + (rgb - prev) * float(np.float32(alpha)), 0.0, 1.0)
    return torch.where(same[..., None], mixed, rgb)


def finish_frame(out, depth, camera_pos, d, light_pos, ux, overlay, gamma):
    """A frame's composition after its EMA, in both twins (the shade
    kernel's compose form, the composition kernel's): the light-source cube
    on black pixels that see it along ``d`` [H, W, 3] (wgsl:866-874), then
    the depth overlay on the window's left half (``ux`` < 0.5, wgsl:880-883)
    when ``overlay`` is 1, and gamma.  Returns (presentation, the history's
    colour: the scene with the light cube, without the overlay)."""
    dev = out.device
    lt_near, lt_far = ray_cube_intersect(
        device_vec(camera_pos, dev), d, device_vec(light_pos, dev), float(np.float32(0.005)))
    light_hit = (lt_near <= lt_far) & (lt_far >= 0.0)
    black = (out == 0.0).all(dim=-1)
    out = torch.where((light_hit & black)[..., None], 1.0, out)
    hist = out
    if float(overlay) == 1.0:
        overlay_rgb = torch.stack([depth, torch.zeros_like(depth), torch.zeros_like(depth)],
                                  dim=-1)
        out = torch.where((ux < 0.5)[..., None], overlay_rgb, out)
    return torch.pow(out, float(np.float32(1.0) / np.float32(gamma))), hist


def lighting_shade(cam, idx, t, flags, states, light: Lighting, *, grid_size, width,
                   height, rgb=None, age=None, total_states=2, history=None):
    """Plain twin of the shade kernel: a frame's light from its primary
    hits (``idx``, ``t`` as :func:`lighting_queries_stacked` takes them),
    its occlusion flags (int32 [nq, H, W], 1 = occluded, the ``n_soft``
    direct-shadow queries then the GI slots; None without queries) and its
    slots' neighbour states (uint8 [n_slots, H, W], or None).

    The soft occlusion quotient (the samples' quotients summed, divided by
    ``soft_k``, or by 1 in the temporal mode) and the GI (each slot's
    reflected light ``quotient · shade(n_point, …) + emissive`` and its
    bounce ``shade(q, …, reflected, n_point)``, summed where the slot's
    entry exists and its neighbour is alive, ×4 for the temporal slot; with
    ``bounces`` > 1 the tree of :func:`_gi_light`, the flags and states of
    every level given), then:

    * with ``rgb`` (K1's unshadowed, age-faded frame [H, W, 3]): ``rgb ·
      occl`` plus the GI on hits; returns the light [H, W, 3], or with
      ``history`` = (color f32 [H, W, 3], ids int32 [H, W]) the fused loop's
      composition (the id-checked EMA, the light cube, the depth overlay of
      ``t``, gamma): (presentation, new history color);
    * without (the sliced frame): the direct light ``clamp(shade(q, origin,
      coords, o, lmag, light), 0)`` times the quotient and the age fade of
      ``age`` (int32 [H, W], or None), plus the GI, black on misses;
      returns (light, depth), the depth t on hits and the volume's exit
      elsewhere.

    The light includes the emissive light on hits (added before the
    composition).  While a profiler records it counts the lanes whose flag
    it reads, as the kernel does (:func:`_lanes_read`)."""
    n = grid_size
    _check_bounces(light)
    geo = _hit_geometry(cam, idx, t, n, width, height)
    if profiling.recording():
        profiling.count("occlusion_lanes_read", _lanes_read(cam, n, geo, states, light))
    n_soft = light.n_soft
    occl = _soft_occlusion(list(flags[:n_soft] == 1), light.occ_div) if n_soft else None
    gi_rgb = _gi_light(cam, n, geo, flags[n_soft:], states, light) if light.gi else None
    return _lighting_tail(cam, geo, idx, t, occl, gi_rgb, grid_size=n, rgb=rgb, age=age,
                          total_states=total_states, history=history)


def _lanes_read(cam, n, geo, states, light: Lighting):
    """The occlusion lanes whose flag the shade kernel reads, where its
    light depends on the flag: each hit's ``n_soft`` direct-shadow lanes,
    and each GI slot it evaluates as live (its entry exists, its neighbour
    is alive and, below level 1, so is its parent)."""
    q, origin, coords, found = geo[:4]
    lanes = light.n_soft * found.sum()
    if light.gi_slot is not None:
        (_, _, _, ok), = _gi_slots(cam, n, q, origin, coords, found, light.gi_slot)
        lanes = lanes + (ok & (states[0] == 1)).sum()
    elif light.gi:
        for level in _slot_tree(cam, n, geo, states, light.bounces):
            lanes = lanes + sum(ok.sum() for *_, ok in level)
    return lanes


def _gi_light(cam, n, geo, gi_flags, states, light: Lighting):
    """The GI [H, W, 3] of the shade twin from the GI rows' flags and
    states: the temporal mode's one slot ×4, or the GI tree of
    ``light.bounces`` levels evaluated bottom up, each slot's reflected light
    ``quotient · shade(n_point, …, parent point) + emissive`` plus its own
    slots' sum, its bounce ``shade(parent point, …, viewer, reflected,
    n_point)`` summed from 0 in slot order where the slot is ok: the
    arithmetic of :func:`indirect_bounce`, level by level."""
    q, origin, coords, found = geo[:4]
    dev = q.device
    lpos = device_vec(cam[P_LIGHT : P_LIGHT + 3], dev)
    o = device_vec(cam[P_O : P_O + 3], dev)
    lmag3 = torch.full_like(q, float(cam[P_LMAG]))
    emis = device_vec(cam[P_EMIS : P_EMIS + 3] * cam[P_EMISS], dev)
    shade = _shader(cam, n)
    if light.gi_slot is not None:
        (n_cl, n_origin, n_point, ok_geo), = _gi_slots(cam, n, q, origin, coords, found,
                                                      light.gi_slot)
        ok = ok_geo & (states[0] == 1)
        reflected = _occlusion_quotient(gi_flags[0] == 1)[..., None] * shade(
            n_point, n_origin, n_cl, q, lmag3, lpos) + emis
        bounce = shade(q, origin, coords, o, reflected, n_point)
        return (torch.zeros_like(q) + torch.where(ok[..., None], bounce, 0.0)) * 4.0
    tree = _slot_tree(cam, n, geo, states, light.bounces)
    # Each level's parents as (point, origin, coords, viewer): the hit, seen
    # from the camera, then each slot seen from its parent's point.
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


def lighting_shade_cuda(cam, idx, t, flags, states, light: Lighting, *, grid_size, width,
                        height, rgb=None, age=None, total_states=2, history=None):
    """The shade kernel on the card (``csrc/lighting_shade.cu``): the
    contract of :func:`lighting_shade` in one launch.  Every tensor must be
    a contiguous CUDA tensor of the frame's shape; a temporal slot given as
    a tensor is read on the card.  Compose-mode launches (with ``history``)
    are also counted in ``lighting_shade_cuda.compose_launches``; a frame
    of more than one bounce does not compose.  While a profiler records the
    launch adds the lanes whose flag it reads to the device's
    ``occlusion_lanes_read`` (``utils.profiling.work_counts``)."""
    cam = _check_sliced(grid_size, width, height, cam)
    _check_card_bounces(light)
    if history is not None and light.gi and light.bounces > 1:
        raise ValueError("a multi-bounce frame does not compose: no history")
    n, nq, h, w = grid_size, light.nq, height, width
    _check_hits(idx, t, w, h)
    if nq > MAX_LIGHTING_QUERIES:
        raise ValueError(f"the shade kernel takes at most {MAX_LIGHTING_QUERIES} queries, "
                         f"got {nq}")
    if nq:
        kernels.require(flags, "flags", torch.int32, (nq, h, w))
    elif flags is not None:
        raise ValueError("flags must be None for a frame without queries")
    if light.n_slots:
        kernels.require(states, "states", torch.uint8, (light.n_slots, h, w))
    elif states is not None:
        raise ValueError("states must be None for a frame without GI")
    sliced = rgb is None
    dev = idx.device
    if sliced:
        if history is not None:
            raise ValueError("the sliced frame does not compose: no history")
        if age is not None:
            kernels.require(age, "age", torch.int32, (h, w))
        if total_states < 2:
            raise ValueError(f"total_states must be >= 2, got {total_states}")
    else:
        kernels.require(rgb, "rgb", torch.float32, (h, w, 3))
        if age is not None:
            raise ValueError("K1's frame is faded already: no age")
        if history is not None:
            kernels.require(history[0], "history color", torch.float32, (h, w, 3))
            kernels.require(history[1], "history ids", torch.int32, (h, w))
    sample_slot, gs = _sample_operand(light.gi_slot, "gi_slot", dev)
    if light.n_slots == 1 and sample_slot is None and not 0 <= gs < 4:
        raise ValueError(f"gi_slot must be in [0, 4), got {gs}")
    out = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    depth = torch.empty((h, w), dtype=torch.float32, device=dev) if sliced else None
    new_hist = torch.empty_like(out) if history is not None else None
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    consts = _light_consts(cam, n, light)
    err = kernels.library().ca3d_lighting_shade(
        dev.index or 0, cam.ctypes.data, consts.ctypes.data, n, w, h, light.n_soft,
        light.n_slots, light.bounces if light.gi else 1, gs, ptr(sample_slot), int(sliced),
        int(history is not None), total_states,
        idx.data_ptr(), t.data_ptr(), ptr(flags), ptr(states), ptr(rgb), ptr(age),
        ptr(None if history is None else history[0]),
        ptr(None if history is None else history[1]), out.data_ptr(), ptr(depth),
        ptr(new_hist), int(profiling.recording()), kernels.stream_of(idx))
    kernels.check(err, "lighting_shade")
    lighting_shade_cuda.launches += 1
    lighting_shade_cuda.compose_launches += int(history is not None)
    if sliced:
        return out, depth
    return out if history is None else (out, new_hist)


lighting_shade_cuda.launches = 0
lighting_shade_cuda.compose_launches = 0


def lighting_passes(cam, idx, t, prepped: Prepped, light: Lighting, *, grid_size, width,
                    height, rgb=None, age=None, total_states=2, history=None):
    """Soft shadows (or the hard shadow) and GI of a frame from its primary
    hits: the queries (:func:`lighting_queries_cuda`, one launch), the GI
    tree's states level by level (:func:`gi_states`: K3 on level 1's slots,
    then for each deeper level a level-mode queries launch and K3 on its
    slots), every occlusion query of the frame in one K2 launch
    (:func:`occlusion_flags`) and the shading (:func:`lighting_shade_cuda`,
    one launch) -- four launches a one-bounce frame on the card, seven a
    two-bounce one; for CPU tensors the plain twins.  The GI slots'
    occlusion rays depend only on the slot's geometry, not on its
    neighbour's state, which only gates whether a slot contributes (and
    whether its children exist), so the ``soft_k`` jittered samples and
    every slot of every level share the K2 launch.  Arguments and results:
    :func:`lighting_shade`'s; a frame of more than one bounce does not
    compose (no ``history``)."""
    kw = dict(grid_size=grid_size, width=width, height=height)
    cpu = idx.device.type == "cpu"
    flags = states = None
    with span("ca3d.lighting"):
        if light.nq:
            with span("ca3d.lighting.queries"):
                ops = _queries(cam, idx, t, light, **kw)
            # K2 reads every level's queries, which the deeper levels' states
            # gate: the level launches those above the last, K2 the last
            # level's lanes itself, so it traces only the lanes the shade
            # reads.  One bounce runs K3 after K2 (its lookups measured 10 %
            # faster there than right after the queries kernel, PERF.md).
            deep = light.n_slots > 0 and light.bounces > 1
            gate = {}
            if deep:
                with span("ca3d.lighting.states"):
                    states = gi_states(cam, idx, t, ops, prepped, light, **kw)
                gate = dict(states=states,
                            q_gate=light.n_soft + Lighting.level_span(light.bounces)[0])
            with span("ca3d.lighting.occlusion"):
                flags = occlusion_flags(cam, ops, prepped, grid_size=grid_size, **gate)
            if light.n_slots and not deep:
                with span("ca3d.lighting.states"):
                    states = gi_states(cam, idx, t, ops, prepped, light, **kw)
        with span("ca3d.lighting.shade"):
            return (lighting_shade if cpu else lighting_shade_cuda)(
                cam, idx, t, flags, states, light, rgb=rgb, age=age,
                total_states=total_states, history=history, **kw)


# ------------------------------------------------------- sliced frame ---


def raytrace_sliced(vol, cam, ages=None, *, grid_size, width, height,
                    shadow=True, total_states=2, soft_shadow_samples=1,
                    indirect=False, indirect_bounces=1, sample_idx=None):
    """One frame of any grid up to 1024³ (render_slab.raytrace_sliced):
    (light_rgb [H, W, 3], depth [H, W], hit_idx [H, W] int32; −1 = miss),
    the light with the emissive light on hits (which JAX's
    ``raytrace_sliced`` leaves to its caller, ``trace_shaded``).  ``ages`` /
    ``total_states``: the age bit-planes of a multi-state rule, of which
    ``vol`` is the visibility plane; K4 then also returns each hit's age,
    whose fade ``clip((S − age)/(S − 1), 0, 1)`` multiplies the direct term
    (the occlusion quotient) and not the GI added after it.

    K4 finds the primary hits; the hard shadow (``soft_shadow_samples`` ≤
    1), the soft-shadow samples and every GI slot of every level ride one
    K2 launch and the GI lookups K3 (level by level) between the queries
    kernel and the shade kernel, which computes the direct light, the
    reference's Cook-Torrance BRDF (:func:`lighting_passes`).
    ``sample_idx``: the frame counter of the temporally amortized mode,
    which evaluates one rotating soft-shadow sample and one GI slot per
    frame (one bounce)."""
    n = grid_size
    cam = _check_sliced(n, width, height, cam)
    kw = dict(grid_size=n, width=width, height=height)
    with span("ca3d.occupancy"):
        prepped = prep_volume(vol)
    if ages is not None:
        _check_ages(ages, vol, total_states)
    t_img, idx, *age_img = primary_hits(cam, prepped, ages, **kw)
    age = age_img[0] if age_img else None
    tail = dict(age=age, total_states=total_states)

    temporal = sample_idx is not None
    light = Lighting(
        soft_k=soft_shadow_samples if shadow else None,
        jitter_k=sample_idx % soft_shadow_samples
        if shadow and temporal and soft_shadow_samples > 1 else None,
        gi=indirect, gi_slot=sample_idx % 4 if indirect and temporal else None,
        bounces=max(1, int(indirect_bounces)) if indirect and not temporal else 1)
    rgb, depth = lighting_passes(cam, idx, t_img, prepped, light, **tail, **kw)
    return rgb, depth, idx
