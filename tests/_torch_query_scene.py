"""Per-query operands as the lighting passes leave them, for holding K5 and
K3 (which read each query's tensors in place) to their plain versions (which
take them stacked): shared by ``tests/test_torch_queries.py`` and
``tests/test_torch_cuda.py``.  Made from a seed with numpy; returned as
numpy arrays, which the tests move to their device."""

import numpy as np


def occlusion_queries(n, nq, h, w, seed, region=None):
    """nq occlusion queries (start f32 [H, W, 3], target f32 [H, W, 3] or
    one light position [3], excl int [H, W, 3], active bool [H, W]) at n³:
    starts in [-0.7, 0.7]³ (inside and outside the volume); every other
    query aims at one shared [3] target, as the GI slots aim at the light;
    with ``region`` (cells [lo, hi) per axis) half the other rays aim at its
    centre; the last query's rays half flat (dz == 0, never occluded).  The
    excluded cell is the start's cell, a random cell, or one with a
    coordinate of -1, n or 2n + 3 (outside the volume: no cell is skipped);
    int32 in even queries and int64 in odd ones, as the port's soft-shadow
    and GI-slot queries carry them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(nq):
        start = rng.uniform(-0.7, 0.7, (h, w, 3)).astype(np.float32)
        if i % 2:
            target = rng.uniform(-1.0, 1.0, 3).astype(np.float32)
        else:
            target = rng.uniform(-1.0, 1.0, (h, w, 3)).astype(np.float32)
            if region is not None:
                mid = np.array([(a + b) / 2 / n - 0.5 for a, b in zip(*region)], np.float32)
                target = np.where(rng.random((h, w, 1)) < 0.5, mid, target)
        if i == nq - 1 and target.ndim == 3:
            target[..., 2] = np.where(rng.random((h, w)) < 0.5, start[..., 2], target[..., 2])
        cell = np.floor((start + 0.5) * n).astype(np.int64)
        other = rng.integers(-1, n + 1, (h, w, 3))
        edge = rng.choice(np.array([-1, n, 2 * n + 3]), (h, w, 3))
        pick = rng.integers(0, 4, (h, w, 1))
        excl = np.where(pick == 0, cell, np.where(pick == 1, other,
                                                  np.where(pick == 2, edge, cell)))
        excl = excl.astype(np.int64 if i % 2 else np.int32)
        active = rng.random((h, w)) < 0.7
        out.append((start, target, excl, active))
    return out


def cell_queries(n, nq, h, w, seed):
    """nq lookups (coords int [H, W, 3], active bool [H, W]) at n³:
    coordinates in [-3, 2n + 5], a quarter of them exactly -1, n or 2n + 3
    (the wrap's edges), int32 in even lookups and int64 in odd ones."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(nq):
        coords = rng.integers(-3, 2 * n + 6, (h, w, 3))
        edge = rng.choice(np.array([-1, n, 2 * n + 3]), (h, w, 3))
        coords = np.where(rng.random((h, w, 3)) < 0.25, edge, coords)
        coords = coords.astype(np.int64 if i % 2 else np.int32)
        out.append((coords, rng.random((h, w)) < 0.7))
    return out


def cell_states_oracle(dense, queries):
    """uint8 [nq, H, W]: the state of the dense grid ([z, y, x]) at
    max(c, 0) mod n per active lane, 0 elsewhere."""
    n = dense.shape[0]
    out = []
    for coords, active in queries:
        x, y, z = np.moveaxis(np.maximum(coords.astype(np.int64), 0) % n, -1, 0)
        out.append(np.where(active, dense[z, y, x], 0).astype(np.uint8))
    return np.stack(out)
