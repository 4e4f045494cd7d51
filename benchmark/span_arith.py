"""The program's spans in a ``torch.profiler`` Chrome trace: for each span
name, its count, its time and the host's own time in it, and the device's
idle time inside and outside the program's spans.

The port marks its layers with ``record_function`` ranges named ``ca3d.*``
(``cellularautomatons3d_tpu_torch/utils/profiling.py``), which the trace holds
as host operations (``user_annotation``) on the clock of the device's
events.  A span's host time (``host_ms``) is its time less the part covered
by the CUDA runtime and driver calls inside it on its thread: a launch
blocked on a full queue is the device's pace, not the host's work.  The idle
time is ``trace_arith``'s: the window from the first device event's start to
the last one's end, less the union of the device events; the part of it
inside the union of the program's spans on the main thread (the thread with
the most host operations) is time the device waited while the host ran the
program, and the rest is time it waited on the harness, the interpreter or
the profiler.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict

from trace_arith import DEVICE_CATS, LAUNCH_CATS, _events, _merged

PREFIX = "ca3d."


def _span(e):
    ts = float(e["ts"])
    return ts, ts + float(e.get("dur", 0.0))


def _clipped(intervals, starts, a, b) -> float:
    """The length of the merged ``intervals`` (sorted, disjoint; ``starts``
    their starts) inside [a, b]."""
    total = 0.0
    i = max(0, bisect.bisect_right(starts, a) - 1)
    while i < len(intervals) and intervals[i][0] < b:
        lo, hi = max(intervals[i][0], a), min(intervals[i][1], b)
        if hi > lo:
            total += hi - lo
        i += 1
    return total


def summarize(trace, prefix: str = PREFIX, gaps: int = 10) -> dict:
    """The summary of a trace's spans (a path, or its list of events):

    * ``spans``: for each span name that starts with ``prefix``, ``count``,
      ``ms`` (its time, summed) and ``host_ms`` (less the runtime and
      driver calls inside it);
    * ``window_ms``, ``idle_ms`` (as ``trace_arith``), ``idle_in_spans_ms``
      and ``idle_outside_spans_ms``;
    * ``gaps``: the ``gaps`` longest idle stretches, each with the innermost
      span open on the main thread at its start (None outside every span).
    """
    events = _events(trace)
    device = [_span(e) for e in events if e.get("cat") in DEVICE_CATS]
    busy = _merged(device)
    w0 = min((a for a, _ in device), default=0.0)
    w1 = max((b for _, b in device), default=0.0)
    idle = [(a, b) for (_, a), (b, _) in zip(busy[:-1], busy[1:]) if b > a]

    ops = Counter()
    calls = defaultdict(list)
    spans = []
    for e in events:
        cat, key = e.get("cat"), (e.get("pid"), e.get("tid"))
        if cat == "cpu_op":
            ops[key] += 1
        elif cat in LAUNCH_CATS:
            calls[key].append(_span(e))
        elif cat == "user_annotation" and str(e.get("name", "")).startswith(prefix):
            spans.append((key, e["name"], *_span(e)))
    main = ops.most_common(1)[0][0] if ops else None

    merged_calls = {k: _merged(v) for k, v in calls.items()}
    call_starts = {k: [a for a, _ in v] for k, v in merged_calls.items()}
    table = defaultdict(lambda: {"count": 0, "ms": 0.0, "host_ms": 0.0})
    for key, name, a, b in spans:
        blocked = _clipped(merged_calls.get(key, []), call_starts.get(key, []), a, b)
        row = table[name]
        row["count"] += 1
        row["ms"] += (b - a) / 1e3
        row["host_ms"] += (b - a - blocked) / 1e3

    program = _merged([(a, b) for key, _, a, b in spans if key == main])
    starts = [a for a, _ in program]
    in_spans = sum(_clipped(program, starts, a, b) for a, b in idle)
    idle_us = (w1 - w0) - sum(b - a for a, b in busy)

    gap_rows = []
    for a, b in sorted(idle, key=lambda s: s[0] - s[1])[:gaps]:
        open_ = [(sa, name) for key, name, sa, sb in spans if key == main and sa <= a < sb]
        gap_rows.append({"start_ms": (a - w0) / 1e3, "ms": (b - a) / 1e3,
                         "span": max(open_)[1] if open_ else None})

    return {
        "spans": dict(table),
        "window_ms": (w1 - w0) / 1e3,
        "idle_ms": idle_us / 1e3,
        "idle_in_spans_ms": in_spans / 1e3,
        "idle_outside_spans_ms": (idle_us - in_spans) / 1e3,
        "gaps": gap_rows,
    }
