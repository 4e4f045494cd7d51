"""Device events (hand kernels, torch kernels, copies and fills) a frame."""


def read(ctx, spec):
    n = ctx.summary["device_events"]
    return n / ctx.frames if n else None
