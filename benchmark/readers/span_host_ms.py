"""The host's own ms a frame inside the program's span the metric names
(``span``): the span's time less the CUDA runtime and driver calls inside
it (``span_arith``)."""

from . import program


def read(ctx, spec):
    s = program.spans()
    row = s and s["spans"].get(spec["span"])
    return row["host_ms"] / ctx.frames if row else None
