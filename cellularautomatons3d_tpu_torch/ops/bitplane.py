"""Bit-sliced (bitboard) arithmetic on packed word planes, in plain torch.

Port of ``cellularautomatons3d_tpu.ops.bitplane``: every bitwise op on a
word plane processes 32 cells at once.  Planes are ``torch.int32`` tensors
holding the reference's ``uint32`` bits (torch's CPU ``uint32`` has no
shifts); the plane arithmetic uses only ``&``, ``|``, ``^`` and ``~``, which
are the same on both types, and the two bit-axis helpers shift logically.

This is the plain twin of the CUDA step kernel (``csrc/ca_step.cu``): the
CPU path runs it, and the kernel is held to it bit for bit.
"""

from __future__ import annotations

import torch

__all__ = [
    "popcount_planes",
    "eq_const",
    "rule_hit",
    "select_planes",
    "increment_planes",
    "planes_to_int",
    "int_to_planes",
]


def _full_adder(a, b, c):
    """(sum, carry) of three one-bit planes: 5 ops."""
    axb = a ^ b
    return axb ^ c, (a & b) | (axb & c)


def _half_adder(a, b):
    return a ^ b, a & b


def popcount_planes(planes):
    """Sum K one-bit planes → list of count bit-planes, LSB first.

    The reference's carry-save reduction, in the same order: full adders
    on triples at each bit weight until ≤ 1 plane per weight remains.
    """
    if not planes:
        raise ValueError("need at least one plane")
    levels: list[list] = [list(planes)]
    out = []
    w = 0
    while w < len(levels):
        level = levels[w]
        while len(level) >= 3:
            a, b, c = level.pop(), level.pop(), level.pop()
            s, cy = _full_adder(a, b, c)
            level.append(s)
            if w + 1 >= len(levels):
                levels.append([])
            levels[w + 1].append(cy)
        if len(level) == 2:
            a, b = level.pop(), level.pop()
            s, cy = _half_adder(a, b)
            level.append(s)
            if w + 1 >= len(levels):
                levels.append([])
            levels[w + 1].append(cy)
        out.append(level[0] if level else None)
        w += 1
    zero = torch.zeros_like(planes[0])
    return [p if p is not None else zero for p in out]


def eq_const(count_planes, value: int, nbits: int | None = None):
    """Plane where the bit-sliced count equals ``value`` (low ``nbits``)."""
    nbits = len(count_planes) if nbits is None else nbits
    acc = None
    for i in range(nbits):
        p = count_planes[i]
        term = p if (value >> i) & 1 else ~p
        acc = term if acc is None else (acc & term)
    return acc


def rule_hit(count_planes, mask: int):
    """Plane where the count is a member of the 27-bit rule ``mask``."""
    if mask == 0:
        return torch.zeros_like(count_planes[0])
    nbits = len(count_planes)
    if mask == (1 << (1 << nbits)) - 1:
        return ~torch.zeros_like(count_planes[0])
    acc = None
    v = 0
    m = mask
    while m:
        if m & 1:
            e = eq_const(count_planes, v, nbits)
            acc = e if acc is None else (acc | e)
        m >>= 1
        v += 1
    return acc


def select_planes(mask_plane, a_planes, b_planes):
    """Per-bit select: mask ? a : b, over lists of planes (zero-padded)."""
    n = max(len(a_planes), len(b_planes))
    zero = torch.zeros_like(mask_plane)
    out = []
    for i in range(n):
        a = a_planes[i] if i < len(a_planes) else zero
        b = b_planes[i] if i < len(b_planes) else zero
        out.append((mask_plane & a) | (~mask_plane & b))
    return out


def increment_planes(planes):
    """Bit-sliced +1 with ripple carry (no wrap plane returned)."""
    out = []
    carry = ~torch.zeros_like(planes[0])  # +1 == carry-in of 1
    for p in planes:
        out.append(p ^ carry)
        carry = p & carry
    return out


def planes_to_int(planes, dtype=torch.int32):
    """Testing helper: expands planes over an explicit bit axis.  Returns a
    tensor of shape ``(32,) + plane.shape`` whose entry ``[b, ...]`` is the
    value encoded at bit ``b`` of each word."""
    shifts = torch.arange(32, dtype=torch.int32, device=planes[0].device)
    shifts = shifts.reshape((32,) + (1,) * planes[0].ndim)
    vals = None
    for i, p in enumerate(planes):
        bit = (p[None, ...] >> shifts) & 1  # the mask makes the shift logical
        contrib = bit.to(dtype) << i
        vals = contrib if vals is None else vals + contrib
    return vals


def int_to_planes(values, nbits: int):
    """Testing helper: int tensor over a leading 32-bit axis → packed planes
    (int32 words holding the uint32 bits)."""
    shifts = torch.arange(32, dtype=torch.int64, device=values.device)
    shifts = shifts.reshape((32,) + (1,) * (values.ndim - 1))
    planes = []
    for i in range(nbits):
        bits = (values.to(torch.int64) >> i) & 1
        word = (bits << shifts).sum(dim=0)  # in [0, 2^32)
        planes.append(torch.where(word >= 2**31, word - 2**32, word).to(torch.int32))
    return planes
