"""Readers of the per-layer metrics: ``benchmark/metrics/<name>.json``
names its reader, a module here with ``read(ctx, spec) -> float | None``.

``ctx`` is a :class:`readers.Context`: the traced stretch's summary, its
frames, the configuration's Engine sizes and the card's peaks (None for a
card the table does not hold).  A reader that finds nothing to read returns
None, and the harness leaves the metric out of the line.
"""

from __future__ import annotations

from typing import NamedTuple


class Context(NamedTuple):
    summary: dict        # trace.summarize(...) over the traced stretch
    frames: int          # frames in the traced stretch
    engine: dict         # the configuration's Engine settings
    peaks: dict | None   # the card's row of peaks.json


def kernel_seconds(ctx: Context, matches) -> tuple[float, int]:
    """Device seconds and launches of the trace's kernels whose names hold
    any of ``matches``."""
    secs, n = 0.0, 0
    for row in ctx.summary["kernels"]:
        if any(m in row["name"] for m in matches):
            secs += row["device_ms"] / 1e3
            n += row["launches"]
    return secs, n
