"""What the readers read of the program itself: the port's spans in the
traced stretch, and its work counters.

Spans: :func:`spans` summarises them with ``span_arith``.  The harness hands
a reader the trace's ``trace_arith`` summary and removes the trace file
before the readers run; the profiler it traced with is still live in its
frame, so the events come from there: the profiler's kineto events, the
Chrome trace's events on its clock (:func:`trace_events`).  Where no
profiler is live (a summary made elsewhere, as in the synthetic tests) or
its trace holds no ``ca3d.*`` span (a program without them), there are none.

Counts: :func:`counts` reads ``utils.profiling.work_counts()``.  The
program counts only while a profiler records, and a run records only its
traced stretch, so the cumulative counts are the stretch's.  A program
without the counters, or one that counted nothing, has none.

A reader of either returns None where they are missing.
"""

from __future__ import annotations

import sys
import traceback

import span_arith

_last: tuple | None = None   # (profiler, its summary): five readers read one stretch


def _live_profiler():
    """The ``torch.profiler.profile`` held by a caller's frame, or None."""
    import torch

    f = sys._getframe(1)
    while f is not None:
        for v in f.f_locals.values():
            if isinstance(v, torch.profiler.profile):
                return v
        f = f.f_back
    return None


def trace_events(prof) -> list[dict]:
    """A finished profiler's events as Chrome-trace events of the categories
    ``span_arith`` reads: name, start and duration (µs), the thread (host)
    or stream (device), and the category by what the event is -- a span
    (``user_annotation``), a CUDA runtime or driver call (``cuda_runtime``:
    every such name starts with ``cu``), another host operation
    (``cpu_op``), a device event (``kernel``: kernels, copies, fills).  A
    span's range on the device's timeline is left out, as the Chrome trace's
    ``gpu_user_annotation`` is from the device's events."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()  # µs from here keep float64's sub-ns steps
    events = [e for e in res.events() if not e.is_hidden_event()]
    spans = {e.name() for e in events if e.is_user_annotation()}
    out = []
    for e in events:
        name = e.name()
        host = e.device_type() == type(e.device_type()).CPU
        if host:
            cat = ("user_annotation" if e.is_user_annotation()
                   else "cuda_runtime" if name.startswith("cu") else "cpu_op")
        elif e.is_user_annotation() or name in spans:
            continue
        else:
            cat = "kernel"
        out.append({"ph": "X", "cat": cat, "name": name,
                    "ts": (e.start_ns() - t0) / 1e3, "dur": e.duration_ns() / 1e3,
                    "pid": "host" if host else f"device{e.device_index()}",
                    "tid": e.start_thread_id() if host else e.device_resource_id(),
                    "args": {"correlation": e.correlation_id()}})
    return out


def spans() -> dict | None:
    """The ``span_arith`` summary of the traced stretch's spans, or None."""
    global _last
    prof = _live_profiler()
    if prof is None:
        return None
    if _last is None or _last[0] is not prof:
        try:
            summary = span_arith.summarize(trace_events(prof))
        except Exception:  # noqa: BLE001 -- a metric left out, not a failed run
            traceback.print_exc()
            summary = {"spans": {}}
        _last = (prof, summary)
    return _last[1] if _last[1]["spans"] else None


def counts() -> dict | None:
    """The program's work counters (``profiling.work_counts()``), or None."""
    try:
        from cellularautomatons3d_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "work_counts", None)
    if read is None:
        return None
    try:
        got = read()
    except Exception:  # noqa: BLE001 -- a metric left out, not a failed run
        traceback.print_exc()
        return None
    return got if any(got.values()) else None
