"""The arithmetic of a ``torch.profiler`` Chrome trace: device time and
launches by kernel name, the device's busy and idle share over the traced
window, and the longest idle gaps with the host operation open at each.

A copy of ``cellularautomatons3d_tpu_torch/tools/trace_summary.py``'s
``summarize`` (its ``load``, host index and interval union), kept with the
benchmark so that the yardstick does not move with the program.  The window
runs from the first device event's start to the last one's end; the device
is busy where any device event runs (the union over streams).  A device
event finds its launch through its ``correlation`` (the CUDA API call
that carries the same one) or its ``External id``.
"""

from __future__ import annotations

import bisect
import json
from collections import Counter, defaultdict

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_OPS = frozenset({"cpu_op", "user_annotation"})
LAUNCH_CATS = frozenset({"cuda_runtime", "cuda_driver"})
WINDOW_CATS = DEVICE_CATS | HOST_OPS | LAUNCH_CATS


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
        for e in events:
            cat = e.get("cat")
            args = e.get("args") or {}
            if cat in LAUNCH_CATS and "correlation" in args:
                self.launch[args["correlation"]] = e
            if cat in HOST_OPS and "External id" in args:
                self.by_ext.setdefault(args["External id"], e)
            if cat in HOST_OPS or cat in LAUNCH_CATS:
                self.threads[(e.get("pid"), e.get("tid"))].append(e)
        for evs in self.threads.values():
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


def load(path) -> list[dict]:
    """The complete events (``"ph": "X"``) of a Chrome trace file."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "ts" in e]


def _events(trace) -> list[dict]:
    if isinstance(trace, (str, bytes)) or hasattr(trace, "__fspath__"):
        return load(trace)
    return [e for e in trace if e.get("ph") == "X" and "ts" in e]
