"""Bit-sliced (bitboard) arithmetic on packed word planes, in plain torch.

Port of ``cellularautomatons3d_tpu.ops.bitplane``: every bitwise op on a
word plane processes 32 cells at once.  Planes are ``torch.int32`` tensors
holding the reference's ``uint32`` bits (torch's CPU ``uint32`` has no
shifts); only ``&``, ``|``, ``^`` and ``~`` are used here, which are the
same on both types.

This is the plain twin of the CUDA step kernel (``csrc/ca_step.cu``): the
CPU path runs it, and the kernel is held to it bit for bit.
"""

from __future__ import annotations

import torch

__all__ = ["popcount_planes", "eq_const", "rule_hit"]


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
