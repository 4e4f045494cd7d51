"""Neighbourhood presets for 3D totalistic cellular automata.

A neighbourhood is a set of integer (dx, dy, dz) offsets around a cell whose
live-cell count drives the born/survive rule lookup.

Capability parity with the reference's six presets
(main_pathtraced.js:12-94): Moore (26), Moore 2D (8),
von Neumann (6), von Neumann 2D (4), edges (12), corners (8), plus the
fixed *edges* and *corners* sets that always back the mixed-neighbourhood
rule groups (main_pathtraced.js:63-85,
compute_clustered.wgsl:11-13).

The offsets are stored as an (K, 3) int32 array in (dx, dy, dz) order.  The
*order* of offsets is irrelevant (counts are totalistic); membership matches
the reference exactly.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "NEIGHBOURHOOD_MAP",
    "EDGES",
    "CORNERS",
    "MOORE",
    "MOORE_2D",
    "VON_NEUMANN",
    "VON_NEUMANN_2D",
    "get_neighbourhood",
    "MAX_NEIGHBOURS",
    "NEIGHBOURS_STORAGE_LEN",
]

# 26 is the maximum possible number of neighbours (full Moore shell); 27 rule
# slots cover counts 0..26 inclusive (main_pathtraced.js:10,155-159).
MAX_NEIGHBOURS = 26
NEIGHBOURS_STORAGE_LEN = 27


def _offsets(flat) -> np.ndarray:
    a = np.asarray(flat, dtype=np.int32).reshape(-1, 3)
    a.setflags(write=False)
    return a


# von Neumann: 6 face neighbours (main_pathtraced.js:13-19).
VON_NEUMANN = _offsets([
    1, 0, 0, -1, 0, 0,
    0, 1, 0, 0, -1, 0,
    0, 0, 1, 0, 0, -1,
])

# von Neumann 2D: 4 in-plane face neighbours (main_pathtraced.js:21-26).
VON_NEUMANN_2D = _offsets([
    1, 0, 0, -1, 0, 0,
    0, 1, 0, 0, -1, 0,
])

# Moore: full 26-cell shell (main_pathtraced.js:29-51).
MOORE = _offsets([
    # middle layer (z = 0)
    1, 0, 0, -1, 0, 0,
    0, 1, 0, 0, -1, 0,
    1, 1, 0, -1, 1, 0,
    1, -1, 0, -1, -1, 0,
    # front layer (z = +1)
    1, 0, 1, -1, 0, 1,
    0, 1, 1, 0, -1, 1,
    1, 1, 1, -1, 1, 1,
    1, -1, 1, -1, -1, 1,
    0, 0, 1,
    # back layer (z = -1)
    1, 0, -1, -1, 0, -1,
    0, 1, -1, 0, -1, -1,
    1, 1, -1, -1, 1, -1,
    1, -1, -1, -1, -1, -1,
    0, 0, -1,
])

# Moore 2D: 8 in-plane neighbours (main_pathtraced.js:53-61).
MOORE_2D = _offsets([
    1, 0, 0, -1, 0, 0,
    0, 1, 0, 0, -1, 0,
    1, 1, 0, -1, 1, 0,
    1, -1, 0, -1, -1, 0,
])

# Edges: the 12 edge-adjacent cells of the Moore shell
# (main_pathtraced.js:63-75).  Also the fixed neighbourhood of the "edges"
# mixed rule group (compute_clustered.wgsl:12,115-138).
EDGES = _offsets([
    # above cell
    1, 1, 0, -1, 1, 0,
    0, 1, 1, 0, 1, -1,
    # below cell
    1, -1, 0, -1, -1, 0,
    0, -1, 1, 0, -1, -1,
    # same level
    1, 0, 1, -1, 0, 1,
    1, 0, -1, -1, 0, -1,
])

# Corners: the 8 corner cells of the Moore shell (main_pathtraced.js:77-85).
# Also the fixed neighbourhood of the "corners" mixed rule group
# (compute_clustered.wgsl:13,140-163).
CORNERS = _offsets([
    1, 1, 1, -1, 1, 1,
    1, 1, -1, -1, 1, -1,
    1, -1, 1, -1, -1, 1,
    1, -1, -1, -1, -1, -1,
])

# Name → offsets map; keys match the reference UI option strings
# (main_pathtraced.js:87-94).
NEIGHBOURHOOD_MAP: dict[str, np.ndarray] = {
    "moore": MOORE,
    "moore 2D": MOORE_2D,
    "von neumann": VON_NEUMANN,
    "von neumann 2D": VON_NEUMANN_2D,
    "edges": EDGES,
    "corners": CORNERS,
}


def get_neighbourhood(name: str) -> np.ndarray:
    """Look up a neighbourhood preset by its reference-UI name."""
    try:
        return NEIGHBOURHOOD_MAP[name]
    except KeyError:
        raise ValueError(
            f"unknown neighbourhood {name!r}; "
            f"expected one of {sorted(NEIGHBOURHOOD_MAP)}"
        ) from None
