"""The plain reference of the automaton: dense cells, one generation at a
time, written from the rule's statement and not from the port.

A configuration's ``rule`` gives the neighbourhood's offsets, the counts at
which a dead cell is born and a live one survives, and the boundary:
``clamp_ref`` is the reference shader's (compute_clustered.wgsl:104, 56-66):
a neighbour past the far edge reads the first row or plane of its axis, one
before the near edge reads dead.  Cells are ``uint8[Z, Y, X]``; the packed
form is the port's interface (``uint32[X/32, Z, Y]`` as int32 bits, bit
``x % 32`` of word ``[x // 32, z, y]``).
"""

from __future__ import annotations

import numpy as np
import torch


def seed_centre(grid: int) -> np.ndarray:
    """The reference app's default start (main_pathtraced.js:1287-1295): one
    live cell at ``grid // 2 - 1`` on every axis."""
    dense = np.zeros((grid,) * 3, dtype=np.uint8)
    c = grid // 2 - 1
    dense[c, c, c] = 1
    return dense


def seed_block(grid: int, seed: int) -> np.ndarray:
    """The reference's random initial state (main_pathtraced.js:1243-1270):
    a 5³ block at ``grid // 2 - 1`` ± 2, each cell alive where a uniform
    draw of ``numpy.random.default_rng(seed)`` exceeds 0.5, in (z, y, x)
    order."""
    dense = np.zeros((grid,) * 3, dtype=np.uint8)
    c = grid // 2 - 1
    block = (np.random.default_rng(seed).random((5, 5, 5)) > 0.5).astype(np.uint8)
    dense[c - 2 : c + 3, c - 2 : c + 3, c - 2 : c + 3] = block
    return dense


def _neighbour(a: torch.Tensor, d: int, axis: int, boundary: str) -> torch.Tensor:
    """out[..., i, ...] = a[..., i + d, ...] along ``axis`` (a tensor axis)."""
    if d == 0:
        return a
    if boundary == "wrap" or (boundary == "clamp_ref" and d > 0):
        return torch.roll(a, -d, axis)
    out = torch.zeros_like(a)
    n = a.shape[axis]
    src = [slice(None)] * 3
    dst = [slice(None)] * 3
    src[axis] = slice(d, n) if d > 0 else slice(0, n + d)
    dst[axis] = slice(0, n - d) if d > 0 else slice(-d, n)
    out[tuple(dst)] = a[tuple(src)]
    return out


def step(cells: torch.Tensor, rule: dict) -> torch.Tensor:
    """One generation of a binary rule on dense cells [Z, Y, X]."""
    count = torch.zeros(cells.shape, dtype=torch.int32, device=cells.device)
    for dx, dy, dz in rule["offsets"]:
        shifted = cells
        for d, axis in ((dx, 2), (dy, 1), (dz, 0)):
            shifted = _neighbour(shifted, d, axis, rule["boundary"])
        count += shifted
    born = torch.zeros_like(cells, dtype=torch.bool)
    for c in rule["born"]:
        born |= count == c
    survive = torch.zeros_like(born)
    for c in rule["survive"]:
        survive |= count == c
    alive = cells == 1
    return torch.where(alive, survive, born).to(torch.uint8)


def pack(cells: torch.Tensor) -> torch.Tensor:
    """Dense [Z, Y, X] cells → packed int32 words [X/32, Z, Y]."""
    z, y, x = cells.shape
    bits = cells.reshape(z, y, x // 32, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=cells.device)
    word = (bits << shifts).sum(dim=-1)
    word = torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)
    return word.permute(2, 0, 1).contiguous()


def scenes(cells: np.ndarray, rule: dict, start: int, period: int, device) -> list:
    """The packed states the cells of a mix render: generation ``start``
    from the dense start ``cells`` and the ``period`` generations after it
    (``period + 1`` states)."""
    cells = torch.from_numpy(cells).to(device)
    for _ in range(start):
        cells = step(cells, rule)
    out = [pack(cells)]
    for _ in range(period):
        cells = step(cells, rule)
        out.append(pack(cells))
    return out


NEIGHBOURHOODS = {
    "von neumann": [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)],
}


def _counts(text: str) -> list[int]:
    """The neighbour counts of a rule string: ``"1,3"``, ``"0-6"``, or a
    mix of both."""
    out = []
    for part in text.split(","):
        part = part.strip()
        if "-" in part:
            a, b = part.split("-")
            out += list(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def rule_of(engine: dict) -> dict:
    """The rule of a configuration's Engine settings: offsets, born and
    survive counts, boundary.  The reference holds binary rules whose edge
    and corner groups are off (``"27"``, the reference app's default)."""
    if int(engine.get("total_states", 2)) != 2:
        raise NotImplementedError("the reference holds binary rules")
    for key in ("born_edges", "survive_edges", "born_corners", "survive_corners"):
        if str(engine.get(key, "27")) != "27":
            raise NotImplementedError(f"{key} groups are not in the reference")
    return {"offsets": NEIGHBOURHOODS[engine["neighbourhood"]],
            "born": _counts(engine["born"]), "survive": _counts(engine["survive"]),
            "boundary": engine["boundary"]}
