"""Summarize a Chrome-format trace that ``torch.profiler`` exported (the
port's counterpart of ``tools/xplane_summary.py``, which decodes a
``jax.profiler`` xplane); needs no GPU::

    python -m cellularautomatons3d_tpu_torch.tools.trace_summary TRACE.json \\
        [--frames K] [--top N] [--gaps N]

Prints one JSON line:

* ``kernels``: per kernel name (device events: kernels, memcpys, memsets),
  its device ms and launches in the trace and per frame (the totals over
  ``--frames``), the top N by device time;
* ``window_ms``, ``busy_ms``, ``busy_share``, ``idle_share``: the window
  runs from the first device event's start to the last one's end (with no
  device event, over the host's events); the device is busy where any
  device event runs (the union over streams) and idle elsewhere.
  ``lead_ms`` is the host's time before the first device event, outside the
  window: the profiler's first operations pay its start-up there;
* ``gaps``: the N longest idle stretches of the device inside the window,
  each with the host operation (an aten op or a ``record_function`` range)
  open on the thread that launched the device event after it at the gap's
  start, and the stack of host events open there (runtime calls included),
  outermost first;
* ``ranges`` (:func:`by_range`): the device time and kernels that each
  ``record_function`` range launched, each device event going to the
  innermost range open at its launch.

A device event finds its launch through its ``correlation`` (the runtime or
driver call that carries the same one) or, failing that, its ``External
id`` (the host op that carries it); one found neither way counts as
``unattributed``.  The shape is a per-layer breakdown's: time by kernel,
busy and idle share, where the idle time goes.
"""

from __future__ import annotations

import argparse
import bisect
import json
from collections import Counter, defaultdict

__all__ = ["load", "summarize", "by_range", "main"]

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_OPS = frozenset({"cpu_op", "user_annotation"})
LAUNCH_CATS = frozenset({"cuda_runtime", "cuda_driver"})
WINDOW_CATS = DEVICE_CATS | HOST_OPS | LAUNCH_CATS


def load(path) -> list[dict]:
    """The complete events (``"ph": "X"``) of a Chrome trace file."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "ts" in e]


def _events(trace) -> list[dict]:
    return load(trace) if isinstance(trace, (str, bytes)) or hasattr(trace, "__fspath__") \
        else [e for e in trace if e.get("ph") == "X" and "ts" in e]


def _span(e):
    ts = float(e["ts"])
    return ts, ts + float(e.get("dur", 0.0))


class _Host:
    """The host side of a trace: launch calls by correlation, host ops by
    external id, and each thread's events sorted by start."""

    def __init__(self, events):
        self.launch = {}
        self.by_ext = {}
        self.threads = defaultdict(list)
        self.ranges = defaultdict(list)
        for e in events:
            cat = e.get("cat")
            args = e.get("args") or {}
            if cat in LAUNCH_CATS and "correlation" in args:
                self.launch[args["correlation"]] = e
            if cat in HOST_OPS and "External id" in args:
                self.by_ext.setdefault(args["External id"], e)
            if cat in HOST_OPS or cat in LAUNCH_CATS:
                self.threads[(e.get("pid"), e.get("tid"))].append(e)
            if cat == "user_annotation":
                self.ranges[(e.get("pid"), e.get("tid"))].append(e)
        for table in (self.threads, self.ranges):
            for evs in table.values():
                evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
        ops = Counter()
        for k, evs in self.threads.items():
            ops[k] = sum(1 for e in evs if e.get("cat") == "cpu_op")
        self.main = ops.most_common(1)[0][0] if ops else None

    def origin(self, dev_event):
        """(thread, host time) of a device event's launch, or None."""
        args = dev_event.get("args") or {}
        e = self.launch.get(args.get("correlation"))
        if e is None:
            e = self.by_ext.get(args.get("External id"))
        if e is None:
            return None
        return (e.get("pid"), e.get("tid")), float(e["ts"])

    @staticmethod
    def open_at(table, thread, t):
        """The events of ``table[thread]`` open at time ``t`` (started at or
        before it, ending after it), outermost first."""
        evs = table.get(thread, [])
        i = bisect.bisect_right(evs, t, key=lambda e: float(e["ts"]))
        return [e for e in evs[:i] if _span(e)[1] > t]


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(trace, frames: int = 1, top: int = 20, gaps: int = 5) -> dict:
    """The summary of a trace (a path, or its list of events) over
    ``frames`` frames: see the module docstring."""
    events = _events(trace)
    frames = max(1, int(frames))
    device = sorted((e for e in events if e.get("cat") in DEVICE_CATS),
                    key=lambda e: float(e["ts"]))
    host_spans = [_span(e) for e in events if e.get("cat") in WINDOW_CATS]
    h0 = min((a for a, _ in host_spans), default=0.0)
    spans = [_span(e) for e in device] or host_spans
    w0 = min((a for a, _ in spans), default=0.0)
    w1 = max((b for _, b in spans), default=0.0)
    busy_us = sum(b - a for a, b in _merged([_span(e) for e in device]))
    window_us = w1 - w0

    per = defaultdict(lambda: [0.0, 0])
    for e in device:
        a, b = _span(e)
        per[e["name"]][0] += b - a
        per[e["name"]][1] += 1
    rows = sorted(per.items(), key=lambda kv: -kv[1][0])
    kernels = [{"name": name, "device_ms": us / 1e3, "launches": n,
                "device_ms_per_frame": us / 1e3 / frames, "launches_per_frame": n / frames}
               for name, (us, n) in rows[:top]]

    host = _Host(events)
    # Idle stretches between device events: (start, end, the event after
    # it, the one before it); with no device event, the whole window.
    stretches = [] if device else [(w0, w1, None, None)]
    end, last = w0, None
    for e in device:
        a, b = _span(e)
        if a > end:
            stretches.append((end, a, e, last))
        if b >= end:
            end, last = b, e
    stretches.sort(key=lambda s: -(s[1] - s[0]))
    gap_rows = []
    for a, b, nxt, prv in stretches[:gaps]:
        src = host.origin(nxt) if nxt is not None else None
        if src is None and prv is not None:
            src = host.origin(prv)
        thread = src[0] if src is not None else host.main
        stack = host.open_at(host.threads, thread, a)
        ops = [e for e in stack if e.get("cat") in HOST_OPS]
        gap_rows.append({
            "start_ms": (a - w0) / 1e3, "ms": (b - a) / 1e3,
            "host_op": ops[-1]["name"] if ops else None,
            "host_stack": [e["name"] for e in stack],
            "next": nxt["name"] if nxt is not None else None,
        })

    return {
        "frames": frames,
        "window_ms": window_us / 1e3,
        "lead_ms": (w0 - h0) / 1e3,
        "busy_ms": busy_us / 1e3,
        "busy_share": busy_us / window_us if window_us > 0 else 0.0,
        "idle_share": 1.0 - busy_us / window_us if window_us > 0 else 0.0,
        "device_events": len(device),
        "launches_per_frame": len(device) / frames,
        "busy_ms_per_frame": busy_us / 1e3 / frames,
        "window_ms_per_frame": window_us / 1e3 / frames,
        "kernels": kernels,
        "launches_by_name": {name: n for name, (_, n) in per.items()},
        "gaps": gap_rows,
    }


def by_range(trace) -> dict:
    """Device ms, launches and kernels by name that each
    ``record_function`` range launched: each device event goes to the
    innermost range open on its launching thread at its launch (``None``:
    launched outside every range; ``"unattributed"``: its launch is not in
    the trace).  Each range also has its host wall ms (summed over its
    occurrences) and occurrences."""
    events = _events(trace)
    host = _Host(events)
    out = {}

    def row(name):
        return out.setdefault(name, {"device_ms": 0.0, "launches": 0, "kernels": {},
                                     "wall_ms": 0.0, "occurrences": 0})

    for e in events:
        if e.get("cat") == "user_annotation":
            r = row(e["name"])
            r["wall_ms"] += float(e.get("dur", 0.0)) / 1e3
            r["occurrences"] += 1
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        src = host.origin(e)
        if src is None:
            name = "unattributed"
        else:
            ranges = host.open_at(host.ranges, src[0], src[1])
            name = ranges[-1]["name"] if ranges else None
        r = row(name)
        a, b = _span(e)
        r["device_ms"] += (b - a) / 1e3
        r["launches"] += 1
        k = r["kernels"].setdefault(e["name"], [0.0, 0])
        k[0] += (b - a) / 1e3
        k[1] += 1
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="a Chrome-format trace.json")
    ap.add_argument("--frames", type=int, default=1, help="frames in the trace (per-frame rows)")
    ap.add_argument("--top", type=int, default=20, help="kernel names listed")
    ap.add_argument("--gaps", type=int, default=5, help="idle gaps listed")
    args = ap.parse_args(argv)
    rec = {"tool": "trace_summary", "trace": str(args.trace),
           **summarize(args.trace, args.frames, args.top, args.gaps)}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
