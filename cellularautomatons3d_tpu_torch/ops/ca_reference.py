"""Correctness oracle: one CA generation on a dense (unpacked) grid.

Port of ``cellularautomatons3d_tpu.ops.ca_reference`` in plain torch: the
update the device shaders perform (compute_clustered.wgsl:192-247 for the
clustered semantics, compute.wgsl:49-175 for the toroidal variant), cell by
cell, with no bit-slicing.  It is the differential-test oracle of the
bit-packed step (``ca_step.py`` and the kernel ``csrc/ca_step.cu``), on the
CPU and on the card.

State is a dense ``uint8[Z, Y, X]`` tensor of cell *ages* (0=dead, 1=alive,
2..S-1 dying; binary CA uses only {0, 1}).  :func:`dense_to_planes` and
:func:`planes_to_dense` carry it to and from the packed age bit-planes on
the tensor's device.
"""

from __future__ import annotations

import torch

from ..models.automaton import AutomatonSpec
from ..types import BoundaryMode

__all__ = [
    "step_dense",
    "shift_dense",
    "count_neighbours_dense",
    "run_dense",
    "dense_to_planes",
    "planes_to_dense",
]

# Dense axes: 0 = z, 1 = y, 2 = x; offsets are (dx, dy, dz).
_AXIS_FOR_D = {0: 2, 1: 1, 2: 0}  # offset component index → tensor axis


def _shift_zero(a: torch.Tensor, d: int, axis: int) -> torch.Tensor:
    """Zero-filling shift: out[c] = a[c+d] in-range else 0."""
    n = a.shape[axis]
    out = torch.zeros_like(a)
    if abs(d) >= n:
        return out
    src = [slice(None)] * a.ndim
    dst = [slice(None)] * a.ndim
    src[axis] = slice(d, n) if d > 0 else slice(0, n + d)
    dst[axis] = slice(0, n - d) if d > 0 else slice(-d, n)
    out[tuple(dst)] = a[tuple(src)]
    return out


def _shift_axis(a: torch.Tensor, d: int, axis: int, boundary: str) -> torch.Tensor:
    """out[c] = a[c + d] along ``axis`` under the boundary mode.

    CLAMP_REF replicates compute_clustered.wgsl:104's inclusive upper bound:
    coordinate N passes the check and then wraps to 0 in getCellState
    (compute_clustered.wgsl:56-66), so positive offsets wrap at the far
    edge while negative offsets read zero past the near edge.
    """
    if d == 0:
        return a
    if boundary == BoundaryMode.WRAP:
        return torch.roll(a, -d, axis)
    if boundary == BoundaryMode.CLAMP_REF:
        if d > 0:
            return torch.roll(a, -d, axis)  # far edge aliases row/plane 0
        return _shift_zero(a, d, axis)
    if boundary == BoundaryMode.CLAMP:
        return _shift_zero(a, d, axis)
    raise ValueError(f"unknown boundary mode {boundary!r}")


def shift_dense(a: torch.Tensor, offset, boundary: str) -> torch.Tensor:
    """out[z, y, x] = a[z+dz, y+dy, x+dx] under the boundary mode."""
    out = a
    for comp, d in enumerate(offset):
        out = _shift_axis(out, d, _AXIS_FOR_D[comp], boundary)
    return out


def count_neighbours_dense(alive: torch.Tensor, offsets, boundary: str) -> torch.Tensor:
    """Live-neighbour count per cell for one offset set (int32)."""
    count = torch.zeros(alive.shape, dtype=torch.int32, device=alive.device)
    for off in offsets:
        count += shift_dense(alive, off, boundary)
    return count


def _group_fire(alive_b, count, born_mask: int, survive_mask: int):
    """LUT evaluation for one group: stateLUT[state][count]
    (compute_clustered.wgsl:165-190), the 27-bit masks indexed by count."""
    lut = alive_b.to(torch.int32) * (survive_mask - born_mask) + born_mask
    return ((lut >> count) & 1) == 1


def step_dense(ages: torch.Tensor, spec: AutomatonSpec) -> torch.Tensor:
    """One generation on a dense ``uint8[Z, Y, X]`` age grid."""
    alive_b = ages == 1
    alive = alive_b.to(torch.uint8)

    fires = torch.zeros_like(alive_b)  # all groups disabled: every cell decays
    for offs, born_mask, survive_mask in spec.active_groups():
        count = count_neighbours_dense(alive, offs, spec.boundary)
        fires |= _group_fire(alive_b, count, born_mask, survive_mask)

    if spec.total_states == 2:
        return fires.to(ages.dtype)

    # Generations-style decay.
    s = spec.total_states
    dead = ages == 0
    one = torch.ones_like(ages)
    next_from_dead = fires.to(ages.dtype)
    next_from_alive = torch.where(fires, one, one * (2 % s))  # S=2 unreachable here
    aged = torch.where(ages >= s - 1, torch.zeros_like(ages), ages + 1)
    return torch.where(dead, next_from_dead, torch.where(alive_b, next_from_alive, aged))


def run_dense(ages, spec: AutomatonSpec, steps: int):
    """Convenience: iterate ``steps`` generations."""
    for _ in range(steps):
        ages = step_dense(ages, spec)
    return ages


def dense_to_planes(ages: torch.Tensor, nbits: int) -> torch.Tensor:
    """Dense ``uint8[Z, Y, X]`` ages → packed age bit-planes ``int32[nbits,
    W, Z, Y]`` (``packing.pack_grid`` of each bit, on the tensor's device)."""
    z, y, x = ages.shape
    if x % 32:
        raise ValueError(f"X extent must be a multiple of 32, got {x}")
    shifts = torch.arange(32, dtype=torch.int64, device=ages.device)
    planes = []
    for i in range(nbits):
        bits = ((ages >> i) & 1).reshape(z, y, x // 32, 32).to(torch.int64)
        word = (bits << shifts).sum(dim=-1)  # in [0, 2^32)
        word = torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)
        planes.append(word.permute(2, 0, 1))
    return torch.stack(planes).contiguous()


def planes_to_dense(planes: torch.Tensor) -> torch.Tensor:
    """Packed age bit-planes ``int32[B, W, Z, Y]`` → dense ``uint8[Z, Y, X]``
    ages."""
    b, w, z, y = planes.shape
    shifts = torch.arange(32, dtype=torch.int32, device=planes.device)
    ages = torch.zeros((z, y, w * 32), dtype=torch.uint8, device=planes.device)
    for i in range(b):
        bits = (planes[i].permute(1, 2, 0)[..., None] >> shifts) & 1  # [Z, Y, W, 32]
        ages |= (bits.reshape(z, y, w * 32) << i).to(torch.uint8)
    return ages
