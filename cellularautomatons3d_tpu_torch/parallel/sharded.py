"""Multi-device stepping: z (or z × y) domain decomposition with halo exchange.

Port of ``cellularautomatons3d_tpu.parallel.sharded``.  JAX runs one
process over a ``Mesh`` of devices and ``shard_map`` with ``ppermute``; this
module keeps that single-controller shape in torch:

* :class:`Mesh` is a numpy object array of ``torch.device`` with the axis
  names ``("z",)`` or ``("z", "y")``.  A device may appear more than once, so
  one card (or the CPU) can hold every shard of a mesh;
* :class:`Sharded` holds a global tensor as one tensor per mesh position on
  that position's device (the packed state split along Z, or Z and Y, and
  the render history split by pixel rows);
* the ``ppermute`` is a ``copy_`` per face and shard into a tensor on the
  destination's device (torch orders a copy between two cards with events on
  both devices' current streams, and on one card it is one more launch on
  its stream);
* every step exchanges one z word-plane per face (:func:`halo_exchange_z`),
  then on a 2-D mesh one y word-column per face *of the z-padded slab*
  (:func:`halo_exchange_y`), so the 8 corner ribbons of a Moore
  neighbourhood ride the second exchange, and steps each shard with its
  halos (``ops.ca_step.step_slab``: the plain version on the CPU, the slab
  mode of the step kernel on a card, which reads the halos in place).

Boundary modes act only at the global edges: WRAP keeps the ring; CLAMP
zeroes both outer halos; CLAMP_REF zeroes only the low one (the reference's
one-sided wrap keeps the high edge's ring: compute_clustered.wgsl:104).  The
packed x axis is never split.  Every neighbourhood has |dz| ≤ 1, so one
plane of halo is exact (checked).
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from ..models.automaton import AutomatonSpec
from ..ops.ca_step import age_masks, age_masks_cuda, step_slab
from ..types import BoundaryMode

__all__ = [
    "AXIS",
    "AXIS_Y",
    "Mesh",
    "Sharded",
    "make_mesh",
    "shard_state",
    "shard_rows",
    "place_rows",
    "to_numpy",
    "make_sharded_step",
    "exchange_halos",
    "halo_exchange_z",
    "halo_exchange_y",
]

AXIS = "z"
AXIS_Y = "y"


class Mesh:
    """Devices laid out on named axes: ``devices`` is a numpy object array
    of ``torch.device``, one axis per name in ``axis_names``."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices: int | None = None, devices=None,
              shape: tuple[int, int] | None = None) -> Mesh:
    """1-D ``(z,)`` mesh over the first ``n_devices`` of ``devices`` (all
    of them by default), or a 2-D ``(z, y)`` mesh when ``shape=(mz, my)``
    is given.  ``devices`` defaults to every CUDA device; a list may name a
    device more than once (``["cpu"] * 8``, ``[torch.device("cuda", 0)] *
    4``) to place several shards on it.  Raises, naming the count, when
    fewer devices are given than the mesh needs (the JAX package shrinks a
    1-D mesh to the devices it has)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if shape is not None:
        mz, my = (int(v) for v in shape)
        need, names, dims = mz * my, (AXIS, AXIS_Y), (mz, my)
    else:
        need = len(devices) if n_devices is None else int(n_devices)
        names, dims = (AXIS,), (need,)
    if need < 1:
        raise ValueError(f"a mesh needs at least one device, got {need}")
    if len(devices) < need:
        raise ValueError(
            f"mesh {dict(zip(names, dims))} needs {need} devices, have "
            f"{len(devices)}" + ("" if devices else " (no CUDA device)")
        )
    arr = np.empty(need, dtype=object)
    arr[:] = devices[:need]
    return Mesh(arr.reshape(dims), names)


def _is_2d(mesh: Mesh) -> bool:
    return AXIS_Y in mesh.axis_names


class Sharded:
    """A global tensor held as one shard per mesh position.

    ``shards`` has the mesh's shape; ``dims[k]`` is the tensor dimension that
    mesh axis ``k`` splits.  The state splits Z and Y (``(1, 2)`` for packed
    words, ``(2, 3)`` for age planes); the history splits rows over every
    mesh axis (``(0, 0)`` on a 2-D mesh: shard ``(i, j)`` holds row block
    ``i · my + j``)."""

    def __init__(self, mesh: Mesh, shards: np.ndarray, dims: tuple[int, ...]):
        if shards.shape != mesh.devices.shape or len(dims) != shards.ndim:
            raise ValueError(f"shards {shards.shape} / dims {dims} for mesh {mesh.shape}")
        self.mesh = mesh
        self.shards = shards
        self.dims = tuple(dims)

    @classmethod
    def split(cls, t: torch.Tensor, mesh: Mesh, dims: tuple[int, ...]) -> "Sharded":
        """Split ``t`` into equal blocks along ``dims`` and copy each block to
        its mesh position's device."""
        shards = np.empty(mesh.devices.shape, dtype=object)
        for pos in np.ndindex(mesh.devices.shape):
            piece = t
            for k, i in enumerate(pos):
                size = piece.shape[dims[k]] // mesh.devices.shape[k]
                piece = piece.narrow(dims[k], i * size, size)
            shards[pos] = torch.empty(piece.shape, dtype=t.dtype,
                                      device=mesh.devices[pos]).copy_(piece)
        return cls(mesh, shards, dims)

    def like(self, shards: np.ndarray) -> "Sharded":
        """The same layout over new shards."""
        return Sharded(self.mesh, shards, self.dims)

    @property
    def shape(self) -> tuple[int, ...]:
        out = list(self.shards.flat[0].shape)
        for k, dim in enumerate(self.dims):
            out[dim] *= self.shards.shape[k]
        return tuple(out)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards.flat[0].dtype

    def full(self, device=None) -> torch.Tensor:
        """The global tensor, gathered on ``device`` (the mesh's first device
        by default)."""
        device = self.mesh.devices.flat[0] if device is None else torch.device(device)

        def cat(ts, dim):
            return ts[0] if len(ts) == 1 else torch.cat(ts, dim)

        grid = self.shards.reshape(self.shards.shape[0], -1)
        return cat([cat([t.to(device) for t in row], self.dims[-1]) for row in grid],
                   self.dims[0])


def shard_state(state: torch.Tensor, mesh: Mesh) -> Sharded:
    """Place a packed state (``[W, Z, Y]`` or age planes ``[B, W, Z, Y]``)
    sharded along Z (and Y on a 2-D mesh)."""
    z = 2 if state.ndim == 4 else 1
    return Sharded.split(state, mesh, (z, z + 1)[: mesh.devices.ndim])


def shard_rows(t: torch.Tensor, mesh: Mesh) -> Sharded:
    """Place an image-shaped tensor (``[H, ...]``) row-sharded over every
    mesh axis."""
    return Sharded.split(t, mesh, (0,) * mesh.devices.ndim)


def place_rows(values, device, mesh: Mesh | None):
    """A tuple of image-shaped tensors (a render history) on ``device``, or
    with a ``mesh`` each row-sharded over it, as a tuple of the same type."""
    if mesh is None:
        return type(values)(*(t.to(device) for t in values))
    return type(values)(*(shard_rows(t, mesh) for t in values))


def to_numpy(t) -> np.ndarray:
    """A tensor, or the gathered global tensor of a :class:`Sharded`, as a
    host numpy array."""
    if isinstance(t, Sharded):
        t = t.full("cpu")
    return t.detach().cpu().numpy()


def _check_boundary(boundary: str):
    if boundary not in BoundaryMode.ALL:
        raise ValueError(f"unknown boundary mode {boundary!r}")


def _face(src: torch.Tensor, device, zero: bool) -> torch.Tensor:
    """``src`` copied to ``device`` (the ppermute of one face), or zeros of
    its shape there."""
    if zero:
        return torch.zeros(src.shape, dtype=src.dtype, device=device)
    return torch.empty(src.shape, dtype=src.dtype, device=device).copy_(src)


def _outer(boundary: str, i: int, n: int) -> tuple[bool, bool]:
    """Whether shard ``i`` of a ring of ``n`` reads zeros in its low and its
    high halo: the global edges under CLAMP (both) and CLAMP_REF (low)."""
    low = boundary in (BoundaryMode.CLAMP, BoundaryMode.CLAMP_REF) and i == 0
    high = boundary == BoundaryMode.CLAMP and i == n - 1
    return low, high


def halo_exchange_z(ring: Sequence[torch.Tensor], boundary: str):
    """The z halos of every slab of one ring along the z axis.

    ``ring[i]`` is shard ``i``'s slab ``[W, Z, Y]`` on its own device.
    Returns ``[(low, high), ...]``, each ``[W, 1, Y]`` on that shard's
    device: ``low`` is the previous shard's last plane and ``high`` the next
    one's first (the two ring ppermutes of ``halo_exchange_z`` in the JAX
    package; a ring of one is its own neighbour), zeroed at the global edges
    as the boundary mode says."""
    _check_boundary(boundary)
    n = len(ring)
    out = []
    for i, local in enumerate(ring):
        zero_low, zero_high = _outer(boundary, i, n)
        out.append((
            _face(ring[(i - 1) % n][:, -1:, :], local.device, zero_low),
            _face(ring[(i + 1) % n][:, :1, :], local.device, zero_high),
        ))
    return out


def halo_exchange_y(ring: Sequence[torch.Tensor], z_halos, boundary: str):
    """The y halos of every slab of one ring along the y axis.

    ``ring[j]`` is shard ``j``'s slab ``[W, Z, Y]`` and ``z_halos[j]`` its
    ``(low, high)`` z halos from :func:`halo_exchange_z`.  Returns ``[(low,
    high), ...]``, each ``[W, Z + 2, 1]`` on that shard's device: the
    previous shard's last and the next one's first column of the z-padded
    slab, so the corner cells ride along; the same boundary semantics as
    :func:`halo_exchange_z` (y = -1 reads dead under CLAMP_REF, y = N wraps
    to 0)."""
    _check_boundary(boundary)
    n = len(ring)

    def column(k, y, device, zero):
        """Column ``y`` of shard ``k``'s z-padded slab on ``device``: the low
        halo's word, the slab's column and the high halo's word, one copy
        each (or zeros)."""
        w, z, _ = ring[k].shape
        col = torch.zeros((w, z + 2, 1), dtype=ring[k].dtype, device=device)
        if not zero:
            col[:, :1].copy_(z_halos[k][0][:, :, y])
            col[:, 1:-1].copy_(ring[k][:, :, y])
            col[:, -1:].copy_(z_halos[k][1][:, :, y])
        return col

    out = []
    for j, local in enumerate(ring):
        zero_low, zero_high = _outer(boundary, j, n)
        out.append((column((j - 1) % n, slice(-1, None), local.device, zero_low),
                    column((j + 1) % n, slice(0, 1), local.device, zero_high)))
    return out


def _alive(planes: torch.Tensor) -> torch.Tensor:
    """The alive plane (age == 1) of a shard's age planes."""
    if planes.device.type == "cpu":
        return age_masks(planes)[0]
    return age_masks_cuda(planes, vis=False)[0]


def exchange_halos(state: Sharded, spec: AutomatonSpec):
    """Every shard's step operands: ``(alive, z_halos, y_halos)``, object
    arrays ``[mz, my]`` of the shard's alive plane (the shard itself for a
    binary rule, its age == 1 plane for a multi-state one), its ``(low,
    high)`` z halos and, on a 2-D mesh, its ``(low, high)`` y halos (None on
    a 1-D mesh).  z first, then y from the z-padded columns."""
    shards = state.shards.reshape(state.shards.shape[0], -1)
    mz, my = shards.shape
    alive = np.empty_like(shards)
    for pos in np.ndindex(shards.shape):
        alive[pos] = shards[pos] if spec.total_states == 2 else _alive(shards[pos])
    z_halos = np.empty_like(shards)
    for j in range(my):
        for i, h in enumerate(halo_exchange_z(list(alive[:, j]), spec.boundary)):
            z_halos[i, j] = h
    y_halos = np.full(shards.shape, None, dtype=object)
    if _is_2d(state.mesh):
        for i in range(mz):
            for j, h in enumerate(halo_exchange_y(list(alive[i]), list(z_halos[i]),
                                                  spec.boundary)):
                y_halos[i, j] = h
    return alive, z_halos, y_halos


def make_sharded_step(spec: AutomatonSpec, mesh: Mesh):
    """One-generation step over a :class:`Sharded` packed state, z-sharded
    on a 1-D mesh, z × y on a 2-D ``(z, y)`` mesh: :func:`exchange_halos`,
    then each shard's ``step_slab``.  Bit-equal to the single-device step
    and to the JAX package's ``make_sharded_step``, with its three checks:
    |dz| ≤ 1, every mesh axis dividing the grid, and y shards of at least 2
    columns."""
    max_dz = max(abs(off[2]) for offs, _, _ in spec.groups for off in offs)
    if max_dz > 1:
        raise NotImplementedError("halo width 1: neighbourhood |dz| must be ≤ 1")
    for ax, size in mesh.shape.items():
        if spec.grid_size % size != 0:
            raise ValueError(
                f"grid_size {spec.grid_size} not divisible by mesh axis {ax!r} size {size}"
            )
    if _is_2d(mesh) and (spec.grid_size // mesh.shape[AXIS_Y]) < 2:
        raise ValueError("y shards must hold ≥ 2 cell columns")

    def step(state: Sharded) -> Sharded:
        alive, z_halos, y_halos = exchange_halos(state, spec)
        shards = state.shards.reshape(alive.shape)
        out = np.empty_like(shards)
        for pos in np.ndindex(shards.shape):
            out[pos] = step_slab(shards[pos], alive[pos], z_halos[pos], y_halos[pos], spec)
        return state.like(out.reshape(state.shards.shape))

    return step
