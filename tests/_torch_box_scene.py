"""Volumes whose occupied box (``ops.occupancy.occupied_box``) has a chosen
shape, for holding K2, K4 and the box kernel to their plain versions at the
box's edges: shared by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``
phase (i).  Imports numpy only."""

import numpy as np

BOX_CASES = ("empty", "corner", "face", "centre", "full")


def box_edge_volume(n, case, seed):
    """Packed words (numpy uint32 [n/32, n, n], the port's layout) of an n³
    volume whose occupied blocks make the box of ``case``, with 5 % of the
    cells of a region live and its 8 corner cells too, so live cells lie on
    the box's edges: none ("empty"); a region at the (-x, -y, +z) corner,
    touching three faces; a slab on the -x face; a region at the centre, off
    the 8³ block grid; or 0.2 % of the whole volume with the cells (0, 0, 0)
    and (n-1, n-1, n-1) ("full": the box is the whole volume).  Returns
    (words, region): the region's cells [lo, hi) per axis (x, y, z), or
    None."""
    rng = np.random.default_rng(seed)
    q = n // 4
    region = {
        "empty": None,
        "corner": ((0, 0, n - q), (q + 3, q - 5, n)),
        "face": ((0, n // 2 - q, n // 2 - 3), (q // 2, n // 2 + 5, n // 2 + q)),
        "centre": ((n // 2 - q // 2 + 3, n // 2 - 13, n // 2 - 5),
                   (n // 2 + q // 2 - 3, n // 2 + 11, n // 2 + q // 2 + 1)),
        "full": ((0, 0, 0), (n, n, n)),
    }[case]
    words = np.zeros((n // 32, n, n), np.uint32)
    if region is not None:
        lo, hi = np.array(region[0]), np.array(region[1])
        k = int((0.002 if case == "full" else 0.05) * np.prod(hi - lo))
        corners = np.array([[(lo, hi - 1)[(i >> a) & 1][a] for a in range(3)]
                            for i in range(8)])
        x, y, z = np.concatenate([rng.integers(lo, hi, (k, 3)), corners]).T
        np.bitwise_or.at(words, (x >> 5, z, y), np.uint32(1) << (x & 31).astype(np.uint32))
    return words, region
