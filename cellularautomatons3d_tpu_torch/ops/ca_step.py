"""Bit-packed CA step: one generation on packed word planes.

Port of ``cellularautomatons3d_tpu.ops.ca_step`` (binary rules).  Two
implementations of one generation:

* :func:`fires_plane` -- plain torch: every neighbour offset becomes one
  funnel-shifted word plane and the count is the ``bitplane`` adder tree,
  exactly the JAX package's formulation.  It runs for CPU tensors.
* :func:`fires_plane_cuda` -- the hand-written kernel ``csrc/ca_step.cu``,
  one launch per generation.  It runs for CUDA tensors.

:func:`step_packed` picks by the tensor's device: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises.

State layout: packed ``[W, Z, Y]`` words (see ``packing.py``) held as
``torch.int32`` with the reference's ``uint32`` bits.  Right shifts of the
words are logical (masked), as on ``uint32``.
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
    "shift_packed",
    "make_step_fn",
    "fires_plane",
    "fires_plane_cuda",
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
        survive.ctypes.data, kernels.stream_of(alive_plane),
    )
    kernels.check(err, "ca_step")
    fires_plane_cuda.launches += 1
    return out


fires_plane_cuda.launches = 0


def step_packed(packed: torch.Tensor, spec: AutomatonSpec) -> torch.Tensor:
    """One generation, binary states, packed ``[W, Z, Y]``: the plain
    version for a CPU tensor, the CUDA kernel for any other."""
    if spec.total_states != 2:
        raise NotImplementedError(
            "multi-state rules are not ported yet (ROADMAP.md queue 1, item 14)"
        )
    _check_shape(packed, spec)
    if packed.device.type == "cpu":
        return fires_plane(packed, spec)
    return fires_plane_cuda(packed, spec)


def make_step_fn(spec: AutomatonSpec):
    """Step callable for this spec: packed plane in, packed plane out."""
    if spec.total_states != 2:
        raise NotImplementedError(
            "multi-state rules are not ported yet (ROADMAP.md queue 1, item 14)"
        )
    return functools.partial(step_packed, spec=spec)
