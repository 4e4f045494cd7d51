"""Coarse occupancy mip for empty-space skipping, in plain torch.

Port of ``cellularautomatons3d_tpu.ops.occupancy.coarse_occupancy``: one
bit per 8³-cell block, 32 blocks per word along x; and of its
``dilate_occupancy``, which the patch prepass (K6) takes its mip from.

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
"""

from __future__ import annotations

import torch

__all__ = ["coarse_occupancy", "coarse_shape", "dilate_occupancy", "BLOCK"]

BLOCK = 8  # downsample factor per axis


def coarse_shape(n: int) -> tuple[int, int]:
    """Shape of the mip of an n³ grid: [n/8, XG·n/8], XG = ⌈n/256⌉."""
    return n // BLOCK, -(-n // 256) * (n // BLOCK)


def coarse_occupancy(packed: torch.Tensor) -> torch.Tensor:
    """8× occupancy mip; see module docstring."""
    w, z, y = packed.shape
    if z % BLOCK or y % BLOCK:
        raise ValueError(f"grid extents must be multiples of {BLOCK}")
    zc, yc = z // BLOCK, y // BLOCK
    xg = max(1, -(-w // BLOCK))
    # [W, Zc, 8, Yc, 8, 4 bytes] → any over the 8×8 (z, y) cells of a block.
    v = packed.contiguous().view(torch.uint8).reshape(w, zc, BLOCK, yc, BLOCK, 4)
    occ = (v != 0).any(dim=4).any(dim=2)              # [W, Zc, Yc, 4]
    occ = occ.permute(1, 2, 0, 3).reshape(zc, yc, w * 4)  # x-block = 4w + byte
    if w * 4 < xg * 32:  # a partial last group (grids 288-480): empty blocks
        occ = torch.nn.functional.pad(occ, (0, xg * 32 - w * 4))
    shifts = torch.arange(32, dtype=torch.int64, device=packed.device)
    words = (occ.reshape(zc, yc, xg, 32).to(torch.int64) << shifts).sum(-1)
    # uint32 bits → int32 (two's complement), groups laid out group-major.
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    return words.permute(0, 2, 1).reshape(zc, xg * yc).contiguous()


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
