"""Bit-packed CA step: one generation on packed word planes.

Port of ``cellularautomatons3d_tpu.ops.ca_step``, binary and multi-state
(Generations) rules.  Two implementations of one generation:

* plain torch -- :func:`fires_plane` (every neighbour offset becomes one
  funnel-shifted word plane and the count is the ``bitplane`` adder tree,
  exactly the JAX package's formulation) and, for multi-state rules,
  :func:`step_packed_multistate` (fires_plane on the alive plane, then the
  bit-sliced :func:`decay_update`).  They run for CPU tensors.
* the hand-written kernels of ``csrc/ca_step.cu`` -- :func:`fires_plane_cuda`,
  one launch per generation, and :func:`step_packed_multistate_cuda`, two:
  :func:`age_masks_cuda` writes the alive plane, then the step kernel runs
  the binary neighbour loop on it with a decay epilogue.  They run for CUDA
  tensors.

:func:`fires_slab` / :func:`step_slab_multistate` and their kernels
:func:`fires_slab_cuda` / :func:`step_slab_multistate_cuda` step one shard
of a sharded state (``parallel.sharded``): a slab ``[W, Z, Y]`` with its halo
planes and, on a 2-D mesh, its halo columns (:func:`pad_slab`); the plain
version is ``fires_plane`` on the padded slab and the interior slice, as
the JAX package's ``parallel.sharded._local_step_binary`` /
``_local_step_multistate``, and the kernel reads the halos in place.
:func:`step_slab` picks between them by the tensor's device.

:func:`step_packed` picks by ``spec.total_states`` and the tensor's device:
a CPU tensor takes the plain version, a CUDA tensor launches the kernels or
raises.  :func:`visibility_plane` is the packed occupancy the renderer takes
(any cell with age ≥ 1), by the same rule.

State layout: packed ``[W, Z, Y]`` words (see ``packing.py``), or for
multi-state rules ``[B, W, Z, Y]`` age bit-planes (``B = spec.age_bits``;
ages 0 = dead, 1 = alive, 2..S-1 dying), held as ``torch.int32`` with the
reference's ``uint32`` bits.  Right shifts of the words are logical
(masked), as on ``uint32``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..models.automaton import AutomatonSpec
from ..types import BoundaryMode
from . import bitplane

__all__ = [
    "step_packed",
    "step_packed_multistate",
    "step_packed_multistate_cuda",
    "shift_packed",
    "make_step_fn",
    "fires_plane",
    "fires_plane_cuda",
    "decay_update",
    "age_masks",
    "age_masks_cuda",
    "visibility_plane",
    "pad_slab",
    "fires_slab",
    "fires_slab_cuda",
    "step_slab_multistate",
    "step_slab_multistate_cuda",
    "step_slab",
]

_BOUNDARY_CODE = {b: i for i, b in enumerate(BoundaryMode.ALL)}

# Packed axes: 0 = W (x words), 1 = Z, 2 = Y; offsets are (dx, dy, dz).


def srl(a: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 words holding uint32 bits."""
    if s == 0:
        return a
    return (a >> s) & ((1 << (32 - s)) - 1)


def _axis_shift_plane(a, d: int, axis: int, boundary: str):
    """Word-granular shift along Z or Y: out[c] = a[c+d] under boundary."""
    if d == 0:
        return a
    rolled = torch.roll(a, -d, axis)
    if boundary == BoundaryMode.WRAP:
        return rolled
    if boundary == BoundaryMode.CLAMP_REF and d > 0:
        # CLAMP_REF: far edge aliases index 0 (compute_clustered.wgsl:104).
        return rolled
    n = a.shape[axis]
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(n - d, n) if d > 0 else slice(0, -d)
    rolled[tuple(idx)] = 0
    return rolled


def _x_shift_plane(a, d: int, boundary: str):
    """Bit-granular shift along the packed x axis (funnel shift across
    words): out cell x reads cell x+d.  |d| must be ≤ 31."""
    if d == 0:
        return a
    ad = abs(d)
    if ad > 31:
        raise ValueError("x offsets beyond ±31 unsupported")
    if d > 0:
        neigh = torch.roll(a, -1, 0)
        if boundary == BoundaryMode.CLAMP:
            neigh[-1] = 0
        return srl(a, d) | (neigh << (32 - d))
    neigh = torch.roll(a, 1, 0)
    if boundary in (BoundaryMode.CLAMP, BoundaryMode.CLAMP_REF):
        neigh[0] = 0
    return (a << ad) | srl(neigh, 32 - ad)


def shift_packed(a, offset, boundary: str):
    """out[x, y, z] = a[x+dx, y+dy, z+dz] on a packed [W, Z, Y] plane."""
    dx, dy, dz = offset
    out = _x_shift_plane(a, dx, boundary)
    out = _axis_shift_plane(out, dy, 2, boundary)
    out = _axis_shift_plane(out, dz, 1, boundary)
    return out


def _check_shape(plane, spec: AutomatonSpec):
    w, z, y = plane.shape[-3:]
    if (w * 32, z, y) != (spec.grid_size,) * 3:
        raise ValueError(
            f"packed state shape {tuple(plane.shape)} does not match "
            f"grid_size={spec.grid_size} (expected [*, {spec.grid_size // 32}, "
            f"{spec.grid_size}, {spec.grid_size}])"
        )


def fires_plane(alive_plane: torch.Tensor, spec: AutomatonSpec) -> torch.Tensor:
    """OR over rule groups of the bit-sliced LUT evaluation
    (compute_clustered.wgsl:224-232): 1-bits where the cell is alive next
    generation.  Plain torch; the CUDA kernel's twin."""
    fires = None
    for offs, born_mask, survive_mask in spec.active_groups():
        shifted = [shift_packed(alive_plane, off, spec.boundary) for off in offs]
        counts = bitplane.popcount_planes(shifted)
        born_hit = bitplane.rule_hit(counts, born_mask)
        survive_hit = bitplane.rule_hit(counts, survive_mask)
        f = (alive_plane & survive_hit) | (~alive_plane & born_hit)
        fires = f if fires is None else (fires | f)
    if fires is None:
        fires = torch.zeros_like(alive_plane)
    return fires


@functools.lru_cache(maxsize=16)
def _rule_arrays(spec: AutomatonSpec):
    """Host arrays of the kernel's runtime rule arguments."""
    groups = spec.active_groups()
    lens = np.array([len(offs) for offs, _, _ in groups] or [0], np.int32)
    offs = np.array(
        [o for offs, _, _ in groups for o in offs] or [(0, 0, 0)], np.int32
    )
    born = np.array([b for _, b, _ in groups] or [0], np.uint32)
    survive = np.array([s for _, _, s in groups] or [0], np.uint32)
    return len(groups), lens, offs, born, survive


# Blocks the step kernel aims to launch: four per SM of an H100 (132 SMs).
_TARGET_BLOCKS = 4 * 132


@functools.lru_cache(maxsize=64)
def _step_plan(spec: AutomatonSpec, z: int | None = None,
               y: int | None = None) -> tuple[int, int]:
    """(halo, chunk) of the step kernel (``csrc/ca_step.cu``) on the grid, or
    on a slab of ``z`` × ``y`` words: each block owns an 8 × 32 (z, y) tile
    and streams ``chunk`` rows of w, with a halo of ``halo`` words in z and
    y, the rule's largest |dy| or |dz|.  ``chunk`` splits W = n/32 so that
    about ``_TARGET_BLOCKS`` blocks run: all of W at 512³ and above, 3 rows
    at 256³ (chunks of 3, 3, 2).  Raises for offsets the kernel does not
    take: |dx| > 31 (one neighbour word each way) or |dy|, |dz| > 31."""
    n = spec.grid_size
    z = n if z is None else z
    y = n if y is None else y
    _, lens, offs, _, _ = _rule_arrays(spec)
    offs = offs[: int(lens.sum())]
    if len(offs) and np.abs(offs).max() > 31:
        raise ValueError(
            f"the CUDA step takes offsets within ±31 on every axis, got "
            f"{[tuple(o) for o in offs[np.abs(offs).max(axis=1) > 31]]}")
    halo = int(np.abs(offs[:, 1:]).max()) if len(offs) else 0
    w = n // 32
    yz_blocks = -(-y // 32) * -(-z // 8)
    chunks = min(w, max(1, -(-_TARGET_BLOCKS // yz_blocks)))
    return halo, -(-w // chunks)


def fires_plane_cuda(alive_plane: torch.Tensor, spec: AutomatonSpec) -> torch.Tensor:
    """One generation by the CUDA kernel (``csrc/ca_step.cu``).  Takes a
    contiguous int32 CUDA tensor [W, Z, Y] and returns a new one; raises for
    anything else."""
    n = spec.grid_size
    kernels.require(alive_plane, "packed state", torch.int32, (n // 32, n, n))
    lib = kernels.library()
    out = torch.empty_like(alive_plane)
    n_groups, lens, offs, born, survive = _rule_arrays(spec)
    err = lib.ca3d_ca_step(
        alive_plane.device.index or 0,
        alive_plane.data_ptr(), out.data_ptr(), n,
        _BOUNDARY_CODE[spec.boundary], n_groups,
        lens.ctypes.data, offs.ctypes.data, born.ctypes.data,
        survive.ctypes.data, *_step_plan(spec), kernels.stream_of(alive_plane),
    )
    kernels.check(err, "ca_step")
    fires_plane_cuda.launches += 1
    return out


fires_plane_cuda.launches = 0


def decay_update(planes, alive, dead, fires, total_states: int):
    """Pointwise Generations age update from the fires plane (bit-sliced).

    planes: list of age bit-planes; alive/dead: membership planes;
    fires: born-or-survive plane.  Returns the next age planes.
    """
    if total_states == 2:
        return [fires]
    nbits = len(planes)
    zero = torch.zeros_like(planes[0])
    ones = ~zero
    one_planes = [ones] + [zero] * (nbits - 1)
    zero_planes = [zero] * nbits
    start_dying = [zero, ones] + [zero] * (nbits - 2)
    aged = bitplane.increment_planes(planes)
    is_last = bitplane.eq_const(planes, total_states - 1, nbits)
    aged = bitplane.select_planes(is_last, zero_planes, aged)
    from_alive = bitplane.select_planes(fires, one_planes, start_dying)
    from_dead = bitplane.select_planes(fires, one_planes, zero_planes)
    return bitplane.select_planes(
        dead, from_dead, bitplane.select_planes(alive, from_alive, aged)
    )


def _check_planes(age_planes, spec: AutomatonSpec):
    _check_shape(age_planes, spec)
    if age_planes.ndim != 4 or age_planes.shape[0] != spec.age_bits:
        raise ValueError(
            f"age planes shape {tuple(age_planes.shape)} does not hold "
            f"{spec.age_bits} planes for total_states={spec.total_states}"
        )


def age_masks(age_planes: torch.Tensor):
    """Plain torch: the (alive, vis) membership planes ``[W, Z, Y]`` of age
    bit-planes ``[B, W, Z, Y]``: age == 1 and age ≥ 1."""
    planes = list(age_planes.unbind(0))
    alive = bitplane.eq_const(planes, 1, len(planes))
    vis = planes[0]
    for p in planes[1:]:
        vis = vis | p
    return alive, vis


def age_masks_cuda(age_planes: torch.Tensor, alive: bool = True, vis: bool = True):
    """:func:`age_masks` by the elementwise kernel of ``csrc/ca_step.cu``,
    one launch; a plane not asked for is not written and comes back None.
    Takes a contiguous int32 CUDA tensor [B, W, Z, Y]; raises otherwise."""
    if age_planes.ndim != 4 or not 1 <= age_planes.shape[0] <= 4:
        raise ValueError(f"age planes must be [B ≤ 4, W, Z, Y], got "
                         f"{tuple(age_planes.shape)}")
    if not (alive or vis):
        raise ValueError("ask for the alive plane, the visibility plane or both")
    kernels.require(age_planes, "age planes", torch.int32, age_planes.shape)
    lib = kernels.library()
    out = [torch.empty_like(age_planes[0]) if want else None for want in (alive, vis)]
    err = lib.ca3d_age_masks(
        age_planes.device.index or 0, age_planes.data_ptr(),
        age_planes.shape[0], age_planes[0].numel(),
        *(None if o is None else o.data_ptr() for o in out),
        kernels.stream_of(age_planes),
    )
    kernels.check(err, "age_masks")
    age_masks_cuda.launches += 1
    return tuple(out)


age_masks_cuda.launches = 0


def visibility_plane(state: torch.Tensor, spec: AutomatonSpec) -> torch.Tensor:
    """Packed occupancy ``[W, Z, Y]`` for the renderer: any cell with age
    ≥ 1.  A binary state is its own; age planes are ORed, in plain torch
    for a CPU tensor and by :func:`age_masks_cuda` for any other."""
    if spec.total_states == 2:
        return state
    if state.device.type == "cpu":
        return age_masks(state)[1]
    return age_masks_cuda(state, alive=False)[1]


def step_packed_multistate(age_planes: torch.Tensor, spec: AutomatonSpec) -> torch.Tensor:
    """Plain torch: one generation, Generations-style ages, ``[B, W, Z,
    Y]``.  The CUDA kernel's twin."""
    _check_planes(age_planes, spec)
    nbits = spec.age_bits
    planes = list(age_planes.unbind(0))
    alive = bitplane.eq_const(planes, 1, nbits)
    dead = bitplane.eq_const(planes, 0, nbits)
    fires = fires_plane(alive, spec)
    return torch.stack(decay_update(planes, alive, dead, fires, spec.total_states))


def step_packed_multistate_cuda(age_planes: torch.Tensor, spec: AutomatonSpec) -> torch.Tensor:
    """One multi-state generation by the CUDA kernels (``csrc/ca_step.cu``):
    :func:`age_masks_cuda` writes the alive plane, then the step kernel
    counts neighbours on it and applies the decay update to the thread's own
    age words.  Takes a contiguous int32 CUDA tensor [B, W, Z, Y] and
    returns a new one; raises for anything else.
    ``total_states == 2`` is the binary kernel on the one plane."""
    _check_planes(age_planes, spec)
    n = spec.grid_size
    kernels.require(age_planes, "age planes", torch.int32,
                    (spec.age_bits, n // 32, n, n))
    if spec.total_states == 2:
        return fires_plane_cuda(age_planes[0], spec)[None]
    lib = kernels.library()
    alive, _ = age_masks_cuda(age_planes, vis=False)
    out = torch.empty_like(age_planes)
    n_groups, lens, offs, born, survive = _rule_arrays(spec)
    err = lib.ca3d_ca_step_multistate(
        age_planes.device.index or 0, age_planes.data_ptr(),
        alive.data_ptr(), out.data_ptr(), n,
        spec.age_bits, spec.total_states, _BOUNDARY_CODE[spec.boundary],
        n_groups, lens.ctypes.data, offs.ctypes.data, born.ctypes.data,
        survive.ctypes.data, *_step_plan(spec), kernels.stream_of(age_planes),
    )
    kernels.check(err, "ca_step_multistate")
    step_packed_multistate_cuda.launches += 1
    return out


step_packed_multistate_cuda.launches = 0


def pad_slab(slab: torch.Tensor, z_halos, y_halos=None) -> torch.Tensor:
    """The padded slab the plain slab step runs on: the z halo planes
    ``(low, high)``, each ``[W, 1, Y]``, around ``slab`` ``[W, Z, Y]`` along
    z, then on a 2-D mesh the y halo columns ``(low, high)``, each ``[W, Z +
    2, 1]``, along y (the JAX package's ``halo_exchange_z`` /
    ``halo_exchange_y`` concatenations)."""
    padded = torch.cat([z_halos[0], slab, z_halos[1]], dim=1)
    if y_halos is not None:
        padded = torch.cat([y_halos[0], padded, y_halos[1]], dim=2)
    return padded


def fires_slab(alive: torch.Tensor, z_halos, y_halos, spec: AutomatonSpec) -> torch.Tensor:
    """Plain torch: one generation of a shard, ``fires_plane`` on the padded
    slab (:func:`pad_slab`) and its interior ``[W, Z, Y]``, as the JAX
    package's ``_local_step_binary``.  The slab kernel's twin."""
    fires = fires_plane(pad_slab(alive, z_halos, y_halos), spec)
    inner = fires[:, 1:-1, 1:-1] if y_halos is not None else fires[:, 1:-1, :]
    return inner.contiguous()


def _slab_kernel(alive, z_halos, y_halos, spec: AutomatonSpec, planes=None):
    """Launch the slab mode of the step kernel: binary on ``alive``, or with
    ``planes`` the multi-state step of those age planes whose alive plane is
    ``alive``.  The halos are read where they lie."""
    w, z, y = alive.shape
    kernels.require(alive, "slab", torch.int32, (spec.grid_size // 32, z, y))
    operands = [(t, f"z halo {i}", (w, 1, y)) for i, t in enumerate(z_halos)]
    if y_halos is not None:
        operands += [(t, f"y halo {i}", (w, z + 2, 1)) for i, t in enumerate(y_halos)]
    if planes is not None:
        operands.append((planes, "age planes", (spec.age_bits, w, z, y)))
    for t, name, shape in operands:
        kernels.require(t, name, torch.int32, shape)
        if t.device != alive.device:
            raise ValueError(f"{name} is on {t.device}, the slab on {alive.device}")
    halo, chunk = _step_plan(spec, z, y)
    out = torch.empty_like(alive if planes is None else planes)
    n_groups, lens, offs, born, survive = _rule_arrays(spec)
    y_lo, y_hi = (None, None) if y_halos is None else (t.data_ptr() for t in y_halos)
    err = kernels.library().ca3d_ca_step_slab(
        alive.device.index or 0, alive.data_ptr(), z_halos[0].data_ptr(),
        z_halos[1].data_ptr(), y_lo, y_hi,
        None if planes is None else planes.data_ptr(), out.data_ptr(), w, z, y,
        0 if planes is None else spec.age_bits, spec.total_states,
        _BOUNDARY_CODE[spec.boundary], n_groups, lens.ctypes.data, offs.ctypes.data,
        born.ctypes.data, survive.ctypes.data, halo, chunk, kernels.stream_of(alive),
    )
    kernels.check(err, "ca_step_slab")
    return out


def fires_slab_cuda(alive: torch.Tensor, z_halos, y_halos, spec: AutomatonSpec) -> torch.Tensor:
    """:func:`fires_slab` by the slab mode of the CUDA step kernel, one
    launch.  Takes contiguous int32 CUDA tensors on one device: the slab
    ``[W, Z, Y]``, its z halos ``[W, 1, Y]`` and, or None, its y halos ``[W,
    Z + 2, 1]``; raises for anything else, and for offsets with |dz| > 1 or
    |dy| ≥ the padded slab's y extent."""
    out = _slab_kernel(alive, z_halos, y_halos, spec)
    fires_slab_cuda.launches += 1
    return out


fires_slab_cuda.launches = 0


def step_slab_multistate(age_planes: torch.Tensor, alive: torch.Tensor, z_halos, y_halos,
                         spec: AutomatonSpec) -> torch.Tensor:
    """Plain torch: one multi-state generation of a shard, age planes ``[B,
    W, Z, Y]`` whose alive plane is ``alive`` (age == 1) and the halos of
    the neighbours' alive planes: only they cross the shard boundary, as in
    the JAX package's ``_local_step_multistate``.  The slab kernel's twin."""
    planes = list(age_planes.unbind(0))
    dead = bitplane.eq_const(planes, 0, spec.age_bits)
    fires = fires_slab(alive, z_halos, y_halos, spec)
    return torch.stack(decay_update(planes, alive, dead, fires, spec.total_states))


def step_slab_multistate_cuda(age_planes: torch.Tensor, alive: torch.Tensor, z_halos,
                              y_halos, spec: AutomatonSpec) -> torch.Tensor:
    """:func:`step_slab_multistate` by the slab mode of the multi-state step
    kernel (neighbour loop on the alive plane and its halos, decay epilogue
    on the slab's own age words), one launch; the operands of
    :func:`fires_slab_cuda` and the age planes ``[B, W, Z, Y]``."""
    out = _slab_kernel(alive, z_halos, y_halos, spec, planes=age_planes)
    step_slab_multistate_cuda.launches += 1
    return out


step_slab_multistate_cuda.launches = 0


def step_slab(state: torch.Tensor, alive: torch.Tensor, z_halos, y_halos,
              spec: AutomatonSpec) -> torch.Tensor:
    """One generation of a shard: the binary slab (``alive`` is ``state``)
    or the multi-state age planes; the plain version for a CPU tensor, the
    slab kernel for any other."""
    cpu = state.device.type == "cpu"
    if spec.total_states == 2:
        return (fires_slab if cpu else fires_slab_cuda)(state, z_halos, y_halos, spec)
    step = step_slab_multistate if cpu else step_slab_multistate_cuda
    return step(state, alive, z_halos, y_halos, spec)


def step_packed(packed: torch.Tensor, spec: AutomatonSpec) -> torch.Tensor:
    """One generation of ``spec``'s automaton: packed ``[W, Z, Y]`` words for
    binary states, ``[B, W, Z, Y]`` age planes for multi-state rules; the
    plain version for a CPU tensor, the CUDA kernels for any other."""
    cpu = packed.device.type == "cpu"
    if spec.total_states != 2:
        return (step_packed_multistate if cpu else step_packed_multistate_cuda)(packed, spec)
    _check_shape(packed, spec)
    return (fires_plane if cpu else fires_plane_cuda)(packed, spec)


def make_step_fn(spec: AutomatonSpec):
    """Step callable for this spec: packed state in, packed state out."""
    return functools.partial(step_packed, spec=spec)
