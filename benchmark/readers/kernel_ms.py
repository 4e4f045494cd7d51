"""Device ms a frame of the kernels the metric names."""

from . import kernel_seconds


def read(ctx, spec):
    secs, n = kernel_seconds(ctx, spec["kernels"])
    return secs * 1e3 / ctx.frames if n else None
