"""Coarse occupancy mip for empty-space skipping, in plain torch.

Port of ``cellularautomatons3d_tpu.ops.occupancy.coarse_occupancy``: one
bit per 8³-cell block, 32 blocks per word along x; and of its
``dilate_occupancy``, which the reference's patch prepass (K6) takes its
mip from.  The port's K6 reads the undilated mip and dilates on read
(:func:`dilated_bits`, ``csrc/prepass.cuh`` ``dilated_bit``).
:func:`plane_occupancy` is the plane-level mip (one bit per 1×8×8 block, at
full z resolution) that K1's opt-in ``CA3D_MIP1`` descent reads.

Input:  packed ``[W, Z, Y]`` words (int32 holding uint32 bits).
Output: ``[Zc, XG·Yc]`` words with Zc = Z/8, Yc = Y/8 and XG = ⌈W/8⌉
x-block groups laid out group-major along the minor axis: bit ``xc & 31``
of ``coarse[zc, (xc >> 5)·Yc + yc]`` = any live cell in block (xc, yc, zc).
For N ≤ 256 (XG = 1) this is the plain ``[Zc, Yc]`` bitmap that the render
kernels (``csrc/sweep.cuh``) stage in shared memory; above, they read it
from global memory (32 KiB at 512³, 256 KiB at 1024³).

Each byte of a packed word is one 8-cell x-block (bit b of word w is cell
32w + b, and the words are little-endian), so the mip is an ``any`` over
bytes followed by packing the block bits into words: a dozen launches per
rebuild in eager torch.  Every frame path rebuilds it every frame, so they
take it from :func:`occupancy_rebuild`: on the card one launch of
``csrc/coarse_occupancy.cu``, on the CPU the plain twins.  The rebuild
returns what the frame asks for beside the 8³ mip: the box of its occupied
blocks (:func:`occupied_box`), which K2, K4 and K5 clip their sweeps to, and
the plane mip of K1's mip1 descent.  The launch is
:func:`coarse_occupancy_cuda` (the mip alone), :func:`coarse_occupancy_box_cuda`
(with the box) or :func:`coarse_occupancy_plane_cuda` (with the plane mip,
and the box where asked); :func:`occupancy_mip` and :func:`occupancy_mip_box`
are its two common forms.  :func:`plane_occupancy_cuda` is the plane mip
alone (the same kernel); ``csrc/occupied_box.cu`` (:func:`occupied_box_cuda`)
reduces a mip a caller brings, alone.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels

__all__ = [
    "coarse_occupancy", "coarse_occupancy_cuda", "occupancy_mip", "coarse_shape",
    "coarse_occupancy_box", "coarse_occupancy_box_cuda", "occupancy_mip_box",
    "Occupancy", "occupancy_rebuild", "coarse_occupancy_plane_cuda", "plane_shape",
    "plane_occupancy", "plane_occupancy_cuda", "dilate_occupancy", "dilated_bits",
    "occupied_box", "occupied_box_cuda", "BLOCK", "BOX_WORDS",
]

BLOCK = 8  # downsample factor per axis
BOX_WORDS = 8  # the OccBox of csrc/sweep.cuh: 4 int32, then 4 float32 bits


def coarse_shape(n: int) -> tuple[int, int]:
    """Shape of the mip of an n³ grid: [n/8, XG·n/8], XG = ⌈n/256⌉."""
    return n // BLOCK, -(-n // 256) * (n // BLOCK)


def plane_shape(n: int) -> tuple[int, int]:
    """Shape of the plane mip of an n³ grid: [n, XG·n/8], XG = ⌈n/256⌉."""
    return n, -(-n // 256) * (n // BLOCK)


class Occupancy(NamedTuple):
    """A frame's occupancy rebuild (:func:`occupancy_rebuild`)."""

    coarse: torch.Tensor         # the 8³ mip int32 [n/8, XG·n/8]
    box: torch.Tensor | None     # its occupied box int32 [8], where asked for
    plane: torch.Tensor | None   # the plane mip int32 [n, XG·n/8], where asked for


def coarse_occupancy(packed: torch.Tensor) -> torch.Tensor:
    """8× occupancy mip; see module docstring."""
    w, z, y = packed.shape
    if z % BLOCK or y % BLOCK:
        raise ValueError(f"grid extents must be multiples of {BLOCK}")
    zc, yc = z // BLOCK, y // BLOCK
    # [W, Zc, 8, Yc, 8, 4 bytes] → any over the 8×8 (z, y) cells of a block.
    v = packed.contiguous().view(torch.uint8).reshape(w, zc, BLOCK, yc, BLOCK, 4)
    return _pack_blocks((v != 0).any(dim=4).any(dim=2))


def _launch(packed: torch.Tensor, box: bool, plane: bool) -> Occupancy:
    """One launch of ``csrc/coarse_occupancy.cu``: the 8³ mip, and its box
    and the plane mip where asked (else None)."""
    n = packed.shape[-1]
    kernels.require(packed, "packed", torch.int32, (n // 32, n, n), align=16)
    dev = packed.device
    out = torch.empty(coarse_shape(n), dtype=torch.int32, device=dev)
    planes = torch.empty(plane_shape(n), dtype=torch.int32, device=dev) if plane else None
    boxes, scratch = None, None
    if box:
        boxes = torch.empty(BOX_WORDS, dtype=torch.int32, device=dev)
        scratch = _box_scratch(dev, kernels.stream_of(packed))
    err = kernels.library().ca3d_coarse_occupancy(
        dev.index or 0, packed.data_ptr(), n, out.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (planes, scratch, boxes)),
        kernels.stream_of(packed))
    kernels.check(err, "coarse_occupancy")
    return Occupancy(out, boxes, planes)


# The box's accumulator and ticket, one per (device index, stream handle):
# zeroed here once, left zero by every launch that uses it, and never used
# by two launches at once, since a stream runs its launches in turn.
_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}


def _box_scratch(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index or 0, stream)
    if key not in _SCRATCH:
        words = kernels.library().ca3d_coarse_occupancy_scratch_words()
        _SCRATCH[key] = torch.zeros(words, dtype=torch.int32, device=device)
    return _SCRATCH[key]


def coarse_occupancy_cuda(packed: torch.Tensor) -> torch.Tensor:
    """:func:`coarse_occupancy` on the card in one launch
    (``csrc/coarse_occupancy.cu``: up to 256³ a block a 4-word strip, two
    16-byte loads a thread; above, a thread a plane word); ``packed`` must be
    a contiguous, 16-byte aligned CUDA tensor [n/32, n, n], n ≤ 1024."""
    out = _launch(packed, box=False, plane=False).coarse
    coarse_occupancy_cuda.launches += 1
    return out


coarse_occupancy_cuda.launches = 0


def coarse_occupancy_box_cuda(packed: torch.Tensor):
    """:func:`coarse_occupancy_box` on the card in the one launch of
    :func:`coarse_occupancy_cuda`, whose blocks also fold the box of the
    words they write and whose last block writes it: (mip, box int32
    [8]).  ``packed`` as for :func:`coarse_occupancy_cuda`."""
    out = _launch(packed, box=True, plane=False)[:2]
    coarse_occupancy_box_cuda.launches += 1
    return out


coarse_occupancy_box_cuda.launches = 0


def coarse_occupancy_plane_cuda(packed: torch.Tensor, with_box: bool = False) -> Occupancy:
    """The 8³ mip, the plane mip and, ``with_box``, the box (else None) on
    the card in one launch of :func:`coarse_occupancy_cuda`'s kernel, whose
    threads also store the plane words they fold: the rebuild of a frame
    under K1's mip1 descent.  ``packed`` as for :func:`coarse_occupancy_cuda`."""
    out = _launch(packed, box=with_box, plane=True)
    coarse_occupancy_plane_cuda.launches += 1
    return out


coarse_occupancy_plane_cuda.launches = 0


def occupancy_rebuild(packed: torch.Tensor, *, box: bool = False,
                      plane: bool = False) -> Occupancy:
    """A frame's occupancy of ``packed``: the 8³ mip, with ``box`` its
    occupied box and with ``plane`` the plane mip (each else None).  The
    plain twins for a CPU tensor, else one launch of the kernel (which
    raises on anything but a CUDA tensor): :func:`coarse_occupancy_plane_cuda`
    with ``plane``, else :func:`coarse_occupancy_box_cuda` with ``box``,
    else :func:`coarse_occupancy_cuda`."""
    if packed.device.type == "cpu":
        coarse = coarse_occupancy(packed)
        return Occupancy(coarse, occupied_box(coarse, packed.shape[-1]) if box else None,
                         plane_occupancy(packed) if plane else None)
    if plane:
        return coarse_occupancy_plane_cuda(packed, with_box=box)
    if box:
        return Occupancy(*coarse_occupancy_box_cuda(packed), None)
    return Occupancy(coarse_occupancy_cuda(packed), None, None)


def occupancy_mip(packed: torch.Tensor) -> torch.Tensor:
    """The frame paths' 8³ mip of ``packed`` (:func:`occupancy_rebuild`):
    the plain twin for a CPU tensor, else the kernel."""
    return occupancy_rebuild(packed).coarse


def coarse_occupancy_box(packed: torch.Tensor):
    """(mip, box): :func:`coarse_occupancy` of ``packed`` and its
    :func:`occupied_box`.  The plain twin of :func:`coarse_occupancy_box_cuda`."""
    coarse = coarse_occupancy(packed)
    return coarse, occupied_box(coarse, packed.shape[-1])


def occupancy_mip_box(packed: torch.Tensor):
    """The 8³ mip of ``packed`` and its box, for a frame whose K2, K4 or K5
    clip to it (:func:`occupancy_rebuild`): the plain twin for a CPU tensor,
    else one launch of the kernel."""
    return occupancy_rebuild(packed, box=True)[:2]


def _pack_blocks(occ: torch.Tensor) -> torch.Tensor:
    """[W, R, Yc, 4] block occupancy (x-block 4w + byte) → [R, XG·Yc] int32
    words holding the uint32 bits, x-groups laid out group-major (bit ``xb
    & 31`` of word ``(xb >> 5)·Yc + yc``); shared by the 8³ and the
    plane-level mips."""
    w, r, yc, _ = occ.shape
    xg = max(1, -(-w // BLOCK))
    occ = occ.permute(1, 2, 0, 3).reshape(r, yc, w * 4)  # x-block = 4w + byte
    if w * 4 < xg * 32:  # a partial last group (grids 288-480): empty blocks
        occ = torch.nn.functional.pad(occ, (0, xg * 32 - w * 4))
    shifts = torch.arange(32, dtype=torch.int64, device=occ.device)
    words = (occ.reshape(r, yc, xg, 32).to(torch.int64) << shifts).sum(-1)
    # uint32 bits → int32 (two's complement), groups laid out group-major.
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    return words.permute(0, 2, 1).reshape(r, xg * yc).contiguous()


def plane_occupancy(packed: torch.Tensor) -> torch.Tensor:
    """Plane-level block mip (the reference's ``plane_occupancy``): full z
    resolution, 8× in x and y.  Returns ``[Z, XG·Yc]`` int32 words holding
    the uint32 bits, in :func:`coarse_occupancy`'s group-major layout: bit
    ``xb & 31`` of ``plane[z, (xb >> 5)·Yc + yb]`` = any live cell in the
    1×8×8 block (z, xb, yb).  The 8 y-words of a block are ORed with three
    pairwise ORs (torch has no OR-reduce), then each byte is an x-block.
    Plain torch on the volume's device, as the reference computes it in
    XLA; K1's mip1 descent (``csrc/sweep.cuh`` ``PlaneMip``) reads it.  The
    plain twin of the plane mip of :func:`coarse_occupancy_plane_cuda` and of
    :func:`plane_occupancy_cuda`."""
    w, z, y = packed.shape
    if y % BLOCK:
        raise ValueError(f"grid extents must be multiples of {BLOCK}")
    v = packed.reshape(w, z, y // BLOCK, BLOCK)
    v = v[..., :4] | v[..., 4:]
    v = v[..., :2] | v[..., 2:]
    v = v[..., 0] | v[..., 1]  # [W, Z, Yc]
    return _pack_blocks(v.contiguous().view(torch.uint8).reshape(w, z, y // BLOCK, 4) != 0)


def plane_occupancy_cuda(packed: torch.Tensor) -> torch.Tensor:
    """:func:`plane_occupancy` on the card in one launch of
    ``csrc/coarse_occupancy.cu`` with its plane mip (the 8³ mip of the same
    launch is dropped); ``packed`` must be a contiguous, 16-byte aligned
    CUDA tensor [n/32, n, n], n ≤ 1024.  No frame path launches it: they
    take the plane mip from :func:`occupancy_rebuild`."""
    out = _launch(packed, box=False, plane=True).plane
    plane_occupancy_cuda.launches += 1
    return out


plane_occupancy_cuda.launches = 0


def dilate_occupancy(coarse: torch.Tensor, dilate_z: bool = True,
                     yc: int | None = None, dilate_y: bool = True) -> torch.Tensor:
    """OR each block with its neighbours one block away, as the reference's
    ``dilate_occupancy``: in x within each word and across the x-group
    boundary (block 31 of group g touches block 0 of group g+1), then in y
    within each group (``dilate_y``) and in z (``dilate_z``), both wrapping
    at the edges like ``jnp.roll``, which only adds occupancy.  ``yc``
    (blocks along y) must be given when ``coarse`` has several x-groups
    (n > 256).  Words are int32 holding uint32 bits, as in and out of
    :func:`coarse_occupancy`."""
    zc, ytot = coarse.shape
    yc = ytot if yc is None else yc
    xg = ytot // yc
    # The uint32 bits in int64, so shifts neither overflow nor sign-extend.
    d = (coarse.to(torch.int64) & 0xFFFFFFFF).reshape(zc, xg, yc)
    x = d | ((d << 1) & 0xFFFFFFFF) | (d >> 1)
    if xg > 1:
        carry = torch.zeros_like(d)
        carry[:, :-1] |= (d[:, 1:] & 1) << 31
        carry[:, 1:] |= d[:, :-1] >> 31
        x = x | carry
    d = x
    axes = ([0] if dilate_z else []) + ([2] if dilate_y else [])
    for axis in axes:
        d = d | torch.roll(d, 1, axis) | torch.roll(d, -1, axis)
    d = torch.where(d >= 2**31, d - 2**32, d)  # uint32 bits → int32
    return d.to(torch.int32).reshape(zc, ytot)


def dilated_bits(coarse: torch.Tensor, c, by, bx) -> torch.Tensor:
    """Bits (c, by, bx) of the prepass's mip, ``dilate_occupancy`` applied
    twice (±1 block in x and y, then ±1 more in x), read from the undilated
    mip ``coarse`` [n/8, n/8] of an n ≤ 256 grid: the OR of rows by − 1, by,
    by + 1 of z-row c (y wraps) tested on the x window [bx − 2, bx + 2] of
    the 32-bit word (x shifts drop bits at its ends).  ``c``, ``by``, ``bx``
    are integer tensors that broadcast; returns a bool tensor of their
    shape.  Plain twin of ``csrc/prepass.cuh`` ``dilated_bit``."""
    nb = coarse.shape[1]
    words = coarse.to(torch.int64) & 0xFFFFFFFF
    w = words[c, (by - 1) % nb] | words[c, by] | words[c, (by + 1) % nb]
    x = w | ((w << 1) & 0xFFFFFFFF) | (w >> 1) | ((w << 2) & 0xFFFFFFFF) | (w >> 2)
    return ((x >> bx) & 1) == 1


def occupied_box(coarse: torch.Tensor, n: int) -> torch.Tensor:
    """The box of the occupied 8³ blocks of the mip of an n³ grid, as the
    int32 [8] words of ``OccBox`` (``csrc/sweep.cuh``): ``empty``, ``full``,
    ``zc0``, ``zc1`` (the first and last 8-plane column holding an occupied
    block), then the float32 bits of ``x0``, ``x1``, ``y0``, ``y1``: the x / y
    extent of the occupied blocks' cells in volume coordinates, grown by one
    cell, ``(b·8 − 1)/n − 0.5`` and ``(b·8 + 9)/n − 0.5`` in float32 with
    1/n rounded once, and ±inf on a side whose block touches the volume's
    face.  ``full``: the box is the whole volume.  An empty mip gives
    ``empty`` = 1 and zeros.  Plain twin of ``csrc/occupied_box.cu`` and of
    the box ``csrc/coarse_occupancy.cu`` writes; the result lies on the
    mip's device."""
    nb = n // BLOCK
    xg = -(-n // 256)
    if tuple(coarse.shape) != coarse_shape(n):
        raise ValueError(f"coarse must have shape {coarse_shape(n)}, got {tuple(coarse.shape)}")
    box = np.zeros(BOX_WORDS, np.int32)
    words = coarse.reshape(nb, xg, nb) != 0  # [z, x-group, y]
    if not bool(words.any()):
        box[0] = 1
        return torch.from_numpy(box).to(coarse.device)
    zs = torch.nonzero(words.any(2).any(1)).flatten()
    ys = torch.nonzero(words.any(1).any(0)).flatten()
    # The x-blocks: bit b of group g is block 32g + b.
    bits = (coarse.to(torch.int64).reshape(nb, xg, nb, 1)
            >> torch.arange(32, device=coarse.device)) & 1
    xs = torch.nonzero(bits.amax(dim=(0, 2)).flatten()).flatten()
    (xb0, xb1), (yb0, yb1) = (int(xs[0]), int(xs[-1])), (int(ys[0]), int(ys[-1]))
    zmin, zmax = int(zs[0]), int(zs[-1])
    full = (xb0, xb1, yb0, yb1, zmin, zmax) == (0, nb - 1, 0, nb - 1, 0, nb - 1)
    inv_n, half, inf = np.float32(1.0 / n), np.float32(0.5), np.float32(np.inf)

    def lo(b):
        return -inf if b == 0 else np.float32(b * 8 - 1) * inv_n - half

    def hi(b):
        return inf if b == nb - 1 else np.float32(b * 8 + 9) * inv_n - half

    box[:4] = (0, int(full), zmin, zmax)
    box[4:] = np.array([lo(xb0), hi(xb1), lo(yb0), hi(yb1)], np.float32).view(np.int32)
    return torch.from_numpy(box).to(coarse.device)


def occupied_box_cuda(coarse: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`occupied_box` on the card (``csrc/occupied_box.cu``, one
    block) for a mip the caller brings; ``coarse`` must be a contiguous,
    16-byte aligned CUDA tensor.  No frame path launches it: they take the
    box from :func:`coarse_occupancy_box_cuda`."""
    kernels.require(coarse, "coarse", torch.int32, coarse_shape(n), align=16)
    box = torch.empty(BOX_WORDS, dtype=torch.int32, device=coarse.device)
    err = kernels.library().ca3d_occupied_box(
        coarse.device.index or 0, coarse.data_ptr(), n, box.data_ptr(),
        kernels.stream_of(coarse))
    kernels.check(err, "occupied_box")
    occupied_box_cuda.launches += 1
    return box


occupied_box_cuda.launches = 0
