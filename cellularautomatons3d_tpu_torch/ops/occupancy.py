"""Coarse occupancy mip for empty-space skipping, in plain torch.

Port of ``cellularautomatons3d_tpu.ops.occupancy.coarse_occupancy``: one
bit per 8³-cell block, 32 blocks per word along x; and of its
``dilate_occupancy``, which the reference's patch prepass (K6) takes its
mip from.  The port's K6 reads the undilated mip and dilates on read
(:func:`dilated_bits`, ``csrc/prepass.cuh`` ``dilated_bit``).
:func:`plane_occupancy` is the plane-level mip (one bit per 1×8×8 block, at
full z resolution) that K1's opt-in ``CA3D_MIP1`` descent reads; on the
card ``csrc/plane_occupancy.cu`` computes it (:func:`plane_occupancy_cuda`).

Input:  packed ``[W, Z, Y]`` words (int32 holding uint32 bits).
Output: ``[Zc, XG·Yc]`` words with Zc = Z/8, Yc = Y/8 and XG = ⌈W/8⌉
x-block groups laid out group-major along the minor axis: bit ``xc & 31``
of ``coarse[zc, (xc >> 5)·Yc + yc]`` = any live cell in block (xc, yc, zc).
For N ≤ 256 (XG = 1) this is the plain ``[Zc, Yc]`` bitmap that the render
kernels (``csrc/sweep.cuh``) stage in shared memory; above, they read it
from global memory (32 KiB at 512³, 256 KiB at 1024³).

Each byte of a packed word is one 8-cell x-block (bit b of word w is cell
32w + b, and the words are little-endian), so the mip is an ``any`` over
bytes followed by packing the block bits into words: a handful of launches
per rebuild, which matters because the fused loop rebuilds it every frame.

:func:`occupied_box` reduces a mip to the box of its occupied blocks, which
K2, K4 and K5 clip their sweeps to; on the card ``csrc/occupied_box.cu``
computes it (:func:`occupied_box_cuda`, and inside K2's, K4's and K5's entry
points).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

__all__ = [
    "coarse_occupancy", "coarse_shape", "plane_occupancy", "plane_occupancy_cuda",
    "dilate_occupancy", "dilated_bits", "occupied_box", "occupied_box_cuda", "BLOCK",
    "BOX_WORDS",
]

BLOCK = 8  # downsample factor per axis
BOX_WORDS = 8  # the OccBox of csrc/sweep.cuh: 4 int32, then 4 float32 bits


def coarse_shape(n: int) -> tuple[int, int]:
    """Shape of the mip of an n³ grid: [n/8, XG·n/8], XG = ⌈n/256⌉."""
    return n // BLOCK, -(-n // 256) * (n // BLOCK)


def coarse_occupancy(packed: torch.Tensor) -> torch.Tensor:
    """8× occupancy mip; see module docstring."""
    w, z, y = packed.shape
    if z % BLOCK or y % BLOCK:
        raise ValueError(f"grid extents must be multiples of {BLOCK}")
    zc, yc = z // BLOCK, y // BLOCK
    # [W, Zc, 8, Yc, 8, 4 bytes] → any over the 8×8 (z, y) cells of a block.
    v = packed.contiguous().view(torch.uint8).reshape(w, zc, BLOCK, yc, BLOCK, 4)
    return _pack_blocks((v != 0).any(dim=4).any(dim=2))


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
    plain twin of :func:`plane_occupancy_cuda`."""
    w, z, y = packed.shape
    if y % BLOCK:
        raise ValueError(f"grid extents must be multiples of {BLOCK}")
    v = packed.reshape(w, z, y // BLOCK, BLOCK)
    v = v[..., :4] | v[..., 4:]
    v = v[..., :2] | v[..., 2:]
    v = v[..., 0] | v[..., 1]  # [W, Z, Yc]
    return _pack_blocks(v.contiguous().view(torch.uint8).reshape(w, z, y // BLOCK, 4) != 0)


def plane_occupancy_cuda(packed: torch.Tensor) -> torch.Tensor:
    """:func:`plane_occupancy` on the card in one launch
    (``csrc/plane_occupancy.cu``, a thread an output word); ``packed`` must
    be a contiguous, 16-byte aligned CUDA tensor [n/32, n, n], n ≤ 1024."""
    n = packed.shape[-1]
    kernels.require(packed, "packed", torch.int32, (n // 32, n, n), align=16)
    out = torch.empty((n, -(-n // 256) * (n // BLOCK)), dtype=torch.int32,
                      device=packed.device)
    err = kernels.library().ca3d_plane_occupancy(
        packed.device.index or 0, packed.data_ptr(), n, out.data_ptr(),
        kernels.stream_of(packed))
    kernels.check(err, "plane_occupancy")
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
    ``empty`` = 1 and zeros.  Plain twin of ``csrc/occupied_box.cu``; the
    result lies on the mip's device."""
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
    block); ``coarse`` must be a contiguous, 16-byte aligned CUDA tensor.
    K2's, K4's and K5's wrappers add to its count the launches of it that
    their entry points report."""
    kernels.require(coarse, "coarse", torch.int32, coarse_shape(n), align=16)
    box = torch.empty(BOX_WORDS, dtype=torch.int32, device=coarse.device)
    err = kernels.library().ca3d_occupied_box(
        coarse.device.index or 0, coarse.data_ptr(), n, box.data_ptr(),
        kernels.stream_of(coarse))
    kernels.check(err, "occupied_box")
    occupied_box_cuda.launches += 1
    return box


occupied_box_cuda.launches = 0
