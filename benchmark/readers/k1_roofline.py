"""K1's share of its bytes bound, in %: a composed frame reads the packed
volume once (``n³ / 8`` bytes) and writes each pixel's colour once at the
float16 the Engine carries between frames (``W · H · 3 · 2`` bytes), at the
card's peak HBM bandwidth, over K1's device time of each launch.  Only the
bytes no implementation of the frame can avoid are counted, so the share
cannot pass 100 %."""

from . import kernel_seconds


def frame_bytes(grid: int, width: int, height: int) -> int:
    return grid**3 // 8 + width * height * 3 * 2


def read(ctx, spec):
    secs, n = kernel_seconds(ctx, spec["kernels"])
    if not n or secs <= 0 or ctx.peaks is None:
        return None
    e = ctx.engine
    bound = n * frame_bytes(int(e["grid_size"]), int(e["width"]), int(e["height"]))
    return 100.0 * bound / ctx.peaks["hbm_bytes_per_s"] / secs
