"""The device's idle share of the traced window, in %: the window runs from
the first device event's start to the last one's end."""


def read(ctx, spec):
    if not ctx.summary["device_events"] or ctx.summary["window_ms"] <= 0:
        return None
    return 100.0 * ctx.summary["idle_share"]
