"""The plain reference of the automaton: dense cells, one generation at a
time, written from the rule's statement and not from the port.

A configuration's ``rule`` gives the neighbourhood's offsets, the counts at
which a dead cell is born and a live one survives, the number of states and
the boundary: ``clamp_ref`` is the reference shader's
(compute_clustered.wgsl:104, 56-66): a neighbour past the far edge reads the
first row or plane of its axis, one before the near edge reads dead.  Cells
are ``uint8[Z, Y, X]``; the packed form is the port's interface
(``uint32[X/32, Z, Y]`` as int32 bits, bit ``x % 32`` of word ``[x // 32, z,
y]``).

A rule of ``states`` > 2 is a Generations rule on dense ages (0 dead, 1
alive, 2 .. states − 1 dying): a dead cell whose count of live (age 1)
neighbours is in ``born`` becomes 1; a live cell whose count is in
``survive`` stays 1, else becomes 2; a dying cell ages by one each
generation, and from ``states − 1`` goes to 0.  Only age-1 cells count as
neighbours.  Its packed form is the port's age bit-planes ``[B, X/32, Z,
Y]``, plane ``b`` holding bit ``b`` of each age.  The Moore neighbourhood's
count is a separable 3×3×3 box sum less the centre, in ``uint8``: a 1024³
generation takes ~40 ms on an H100, where 26 shifted copies would take ~10
times as long.
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


def _offset_count(cells: torch.Tensor, rule: dict) -> torch.Tensor:
    """The live neighbours of every cell (uint8 0/1 [Z, Y, X]), one shifted
    copy an offset, int32."""
    count = torch.zeros(cells.shape, dtype=torch.int32, device=cells.device)
    for dx, dy, dz in rule["offsets"]:
        shifted = cells
        for d, axis in ((dx, 2), (dy, 1), (dz, 0)):
            shifted = _neighbour(shifted, d, axis, rule["boundary"])
        count += shifted
    return count


def step(cells: torch.Tensor, rule: dict) -> torch.Tensor:
    """One generation of a binary rule on dense cells [Z, Y, X]."""
    count = _offset_count(cells, rule)
    born = torch.zeros_like(cells, dtype=torch.bool)
    for c in rule["born"]:
        born |= count == c
    survive = torch.zeros_like(born)
    for c in rule["survive"]:
        survive |= count == c
    alive = cells == 1
    return torch.where(alive, survive, born).to(torch.uint8)


def _box3(a: torch.Tensor, axis: int, boundary: str) -> torch.Tensor:
    """out[i] = a[i - 1] + a[i] + a[i + 1] along ``axis`` under the
    boundary (a neighbour outside the grid reads dead, or the far edge's
    reads index 0 under ``clamp_ref``, or both wrap)."""
    n = a.shape[axis]
    out = a.clone()
    out.narrow(axis, 1, n - 1).add_(a.narrow(axis, 0, n - 1))
    out.narrow(axis, 0, n - 1).add_(a.narrow(axis, 1, n - 1))
    if boundary in ("wrap", "clamp_ref"):
        out.narrow(axis, n - 1, 1).add_(a.narrow(axis, 0, 1))
    if boundary == "wrap":
        out.narrow(axis, 0, 1).add_(a.narrow(axis, n - 1, 1))
    return out


def moore_count(alive: torch.Tensor, boundary: str) -> torch.Tensor:
    """The live Moore neighbours (26 offsets) of every cell of ``alive``
    (uint8 0/1 [Z, Y, X]): the 3×3×3 box sum less the cell, uint8."""
    box = alive
    for axis in (2, 1, 0):
        box = _box3(box, axis, boundary)
    return box - alive


def _in_counts(count: torch.Tensor, counts: list[int]) -> torch.Tensor:
    """count ∈ counts."""
    hit = torch.zeros(count.shape, dtype=torch.bool, device=count.device)
    for c in counts:
        hit |= count == c
    return hit


def step_ages(ages: torch.Tensor, rule: dict) -> torch.Tensor:
    """One generation of ``rule`` on dense ages [Z, Y, X] (uint8): the
    Generations update of the module's docstring, or for two states the
    binary update."""
    alive = ages == 1
    cells = alive.view(torch.uint8)
    count = (moore_count(cells, rule["boundary"]) if rule["moore"]
             else _offset_count(cells, rule))
    born = _in_counts(count, rule["born"])
    survive = _in_counts(count, rule["survive"])
    states = rule["states"]
    if states == 2:
        return torch.where(alive, survive, born).to(torch.uint8)
    one = torch.ones_like(ages)
    aged = torch.where(ages == states - 1, 0, ages + 1).to(torch.uint8)
    live_next = torch.where(survive, one, 2 * one)
    return torch.where(ages == 0, born.to(torch.uint8), torch.where(alive, live_next, aged))


def pack(cells: torch.Tensor) -> torch.Tensor:
    """Dense [Z, Y, X] cells → packed int32 words [X/32, Z, Y]."""
    z, y, x = cells.shape
    bits = cells.reshape(z, y, x // 32, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=cells.device)
    word = (bits << shifts).sum(dim=-1)
    word = torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)
    return word.permute(2, 0, 1).contiguous()


def pack_ages(ages: torch.Tensor, bits: int, block: int = 64) -> torch.Tensor:
    """Dense ages [Z, Y, X] → the age bit-planes [bits, X/32, Z, Y], packed
    ``block`` z-planes at a time so that a 1024³ grid packs in little
    memory."""
    return torch.stack([
        torch.cat([pack((ages[z : z + block] >> b) & 1) for z in range(0, ages.shape[0], block)],
                  dim=1)
        for b in range(bits)])


def visible(state: torch.Tensor) -> torch.Tensor:
    """The packed cells a frame sees: a binary state itself, of age planes
    every cell of age ≥ 1 (any bit set)."""
    if state.ndim == 3:
        return state
    vis = state[0]
    for plane in state[1:]:
        vis = vis | plane
    return vis


def scenes(cells: np.ndarray, rule: dict, start: int, period: int, device) -> list:
    """The packed states the cells of a mix render: generation ``start``
    from the dense start ``cells`` and the ``period`` generations after it
    (``period + 1`` states): packed words for a binary rule, age bit-planes
    for a Generations one."""
    if rule["states"] > 2 or rule["moore"]:
        return _age_scenes(cells, rule, start, period, device)
    cells = torch.from_numpy(cells).to(device)
    for _ in range(start):
        cells = step(cells, rule)
    out = [pack(cells)]
    for _ in range(period):
        cells = step(cells, rule)
        out.append(pack(cells))
    return out


def _age_scenes(cells: np.ndarray, rule: dict, start: int, period: int, device) -> list:
    """:func:`scenes` by :func:`step_ages`."""
    ages = torch.from_numpy(cells).to(device)
    bits = max(1, (rule["states"] - 1).bit_length())

    def packed(a):
        planes = pack_ages(a, bits)
        return planes if rule["states"] > 2 else planes[0]

    for _ in range(start):
        ages = step_ages(ages, rule)
    out = [packed(ages)]
    for _ in range(period):
        ages = step_ages(ages, rule)
        out.append(packed(ages))
    return out


NEIGHBOURHOODS = {
    "von neumann": [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)],
    "moore": [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
              if (dx, dy, dz) != (0, 0, 0)],
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
    survive counts, number of states, boundary.  The reference holds the von
    Neumann and Moore neighbourhoods, 2 to 10 states, and rules whose edge
    and corner groups are off (``"27"``, the reference app's default)."""
    states = int(engine.get("total_states", 2))
    if not 2 <= states <= 10:
        raise NotImplementedError(f"{states} states are not in the reference (2 to 10 are)")
    if engine["neighbourhood"] not in NEIGHBOURHOODS:
        raise NotImplementedError(f"the {engine['neighbourhood']!r} neighbourhood is not in the "
                                  f"reference ({sorted(NEIGHBOURHOODS)} are)")
    for key in ("born_edges", "survive_edges", "born_corners", "survive_corners"):
        if str(engine.get(key, "27")) != "27":
            raise NotImplementedError(f"{key} groups are not in the reference")
    return {"offsets": NEIGHBOURHOODS[engine["neighbourhood"]],
            "born": _counts(engine["born"]), "survive": _counts(engine["survive"]),
            "boundary": engine["boundary"], "states": states,
            "moore": engine["neighbourhood"] == "moore"}
