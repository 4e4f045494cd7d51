"""Bit-packed voxel state: pack/unpack and seeding.

State layout (TPU-native, differs from the reference's memory order but is
semantically the same bit-packing):

* Dense form: ``uint8[Z, Y, X]`` (or ``uint8[Z, Y, X]`` ages for multi-state).
* Packed form: ``uint32[W, Z, Y]`` with ``W = X // 32``; bit ``b`` of word
  ``[w, z, y]`` is cell ``x = 32*w + b``.

The packed *bit* mapping (cell → (word ``x//32``, bit ``x%32``)) matches the
reference's cluster addressing (compute_clustered.wgsl:56-66,79-86;
main_pathtraced.js:1170-1178).  The reference stores words as a flat array
``idx = w + y*W + z*W*N`` (w minor); we instead put the packed-word axis
*major* and the y axis *minor* so that on TPU the y axis maps onto the 128
vector lanes (a W=8 minor axis at 256³ would waste 94% of each lane tile).
Conversion helpers keep the two orders interchangeable at the host boundary.

Seeding replicates the reference's two initial states
(main_pathtraced.js:1241-1312): a single live cell at ``N//2 - 1`` on every
axis, or a 5³ block near the centre with ~50% random fill.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "pack_grid",
    "unpack_grid",
    "packed_shape",
    "seed_center",
    "seed_random_block",
    "to_reference_order",
    "from_reference_order",
]


def packed_shape(grid_size: int | tuple[int, int, int]) -> tuple[int, int, int]:
    """(W, Z, Y) packed shape for a dense (Z, Y, X) grid."""
    if isinstance(grid_size, int):
        z = y = x = grid_size
    else:
        z, y, x = grid_size
    if x % 32 != 0:
        raise ValueError(f"X extent must be a multiple of 32, got {x}")
    return (x // 32, z, y)


def pack_grid(dense: np.ndarray) -> np.ndarray:
    """Dense ``uint8/bool[Z, Y, X]`` (0/1 occupancy) → packed ``uint32[W, Z, Y]``."""
    dense = np.asarray(dense)
    if dense.ndim != 3:
        raise ValueError(f"expected 3D dense grid, got shape {dense.shape}")
    z, y, x = dense.shape
    if x % 32 != 0:
        raise ValueError(f"X extent must be a multiple of 32, got {x}")
    # Bit b of word w is cell x = 32w + b (LSB-first, masks[] order:
    # compute_clustered.wgsl:21-54): little-endian bytes of LSB-first bits,
    # one byte per 8 cells, so a 1024³ grid packs without a 4-byte-per-cell
    # temporary.
    octets = np.packbits(dense != 0, axis=-1, bitorder="little")
    words = octets.view("<u4").astype(np.uint32, copy=False)  # [Z, Y, W]
    return np.ascontiguousarray(words.transpose(2, 0, 1))  # [W, Z, Y]


def unpack_grid(packed: np.ndarray) -> np.ndarray:
    """Packed ``uint32[W, Z, Y]`` → dense ``uint8[Z, Y, X]`` of 0/1."""
    packed = np.asarray(packed, dtype=np.uint32)
    words = np.ascontiguousarray(packed.transpose(1, 2, 0), dtype="<u4")  # [Z, Y, W]
    return np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little")


def to_reference_order(packed: np.ndarray) -> np.ndarray:
    """[W, Z, Y] words → the reference's flat ``uint32[(N/32)*N*N]`` order
    (``idx = w + y*W + z*W*N``, main_pathtraced.js:1170-1178)."""
    return np.ascontiguousarray(packed.transpose(1, 2, 0)).reshape(-1)


def from_reference_order(flat: np.ndarray, grid_size: int) -> np.ndarray:
    """Inverse of :func:`to_reference_order`."""
    w = grid_size // 32
    return np.ascontiguousarray(
        np.asarray(flat, dtype=np.uint32)
        .reshape(grid_size, grid_size, w)
        .transpose(2, 0, 1)
    )


def seed_center(grid_size: int, dtype=np.uint8) -> np.ndarray:
    """Single live cell at ``(c, c, c)`` with ``c = N//2 - 1`` on every axis,
    matching the reference default (main_pathtraced.js:1287-1295).

    Returns a dense ``[Z, Y, X]`` grid.
    """
    dense = np.zeros((grid_size,) * 3, dtype=dtype)
    c = grid_size // 2 - 1
    dense[c, c, c] = 1
    return dense


def seed_random_block(
    grid_size: int, rng: np.random.Generator | int | None = None, dtype=np.uint8
) -> np.ndarray:
    """5³ block at centre-1 ±2 with ~50% fill (main_pathtraced.js:1243-1270).

    The reference sets bit ``(center+i) & 31`` of the word holding x =
    center+i — which is exactly cell ``(center+i, center+j, center+k)``
    (JS ``<<`` masks the shift count by 31, so the "absolute coord as bit
    index" quirk flagged in SURVEY.md §2.1 is in fact a correct x%32).
    """
    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)
    dense = np.zeros((grid_size,) * 3, dtype=dtype)
    c = grid_size // 2 - 1
    block = (rng.random((5, 5, 5)) > 0.5).astype(dtype)
    # Reference loop order i(x), j(y), k(z) over -2..2; membership only.
    dense[c - 2 : c + 3, c - 2 : c + 3, c - 2 : c + 3] = block
    return dense
