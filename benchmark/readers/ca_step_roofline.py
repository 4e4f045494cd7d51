"""The CA step's share of its bytes bound, in %: a generation reads the
packed volume once and writes it once, ``2 · n³ / 8`` bytes, at the card's
peak HBM bandwidth, over the step kernel's device time of each launch."""

from . import kernel_seconds


def step_bytes(grid: int) -> int:
    return 2 * grid**3 // 8


def read(ctx, spec):
    secs, n = kernel_seconds(ctx, spec["kernels"])
    if not n or secs <= 0 or ctx.peaks is None:
        return None
    bound = n * step_bytes(int(ctx.engine["grid_size"])) / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * bound / secs
