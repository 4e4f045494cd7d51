"""Device ns a lane of the kernels the metric names, over the program's
work counter ``counter``: K2's time over the occlusion lanes it traced."""

from . import kernel_seconds, program


def read(ctx, spec):
    c = program.counts()
    secs, n = kernel_seconds(ctx, spec["kernels"])
    if not c or not n or not c.get(spec["counter"]):
        return None
    return secs * 1e9 / c[spec["counter"]]
