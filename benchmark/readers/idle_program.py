"""The device's idle share of the traced window while a ``ca3d.*`` span of
the program is open on the host, in % (``span_arith``): the part of
``device_idle_share`` the program's own host work holds; the rest is
outside it (the harness, the interpreter, the profiler)."""

from . import program


def read(ctx, spec):
    s = program.spans()
    if not s or s["window_ms"] <= 0:
        return None
    return 100.0 * s["idle_in_spans_ms"] / s["window_ms"]
