"""Coarse occupancy mip for empty-space skipping, in plain torch.

Port of ``cellularautomatons3d_tpu.ops.occupancy.coarse_occupancy``: one
bit per 8³-cell block, 32 blocks per word along x.

Input:  packed ``[W, Z, Y]`` words (int32 holding uint32 bits).
Output: ``[Zc, XG·Yc]`` words with Zc = Z/8, Yc = Y/8 and XG = ⌈W/8⌉
x-block groups laid out group-major along the minor axis: bit ``xc & 31``
of ``coarse[zc, (xc >> 5)·Yc + yc]`` = any live cell in block (xc, yc, zc).
For N ≤ 256 (XG = 1) this is the plain ``[Zc, Yc]`` bitmap that the render
kernel (``csrc/render_fast.cu``) keeps in shared memory.

Each byte of a packed word is one 8-cell x-block (bit b of word w is cell
32w + b, and the words are little-endian), so the mip is an ``any`` over
bytes followed by packing the block bits into words: a handful of launches
per rebuild, which matters because the fused loop rebuilds it every frame.
"""

from __future__ import annotations

import torch

__all__ = ["coarse_occupancy", "BLOCK"]

BLOCK = 8  # downsample factor per axis


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
