"""Timing helpers: the steps/sec and frame-ms counters the reference lacks.

Port of ``cellularautomatons3d_tpu.utils.metrics``.  Torch returns before a
CUDA device has run what it was given, so :func:`device_sync` waits for the
devices that hold ``x`` (``torch.cuda.synchronize``); on the CPU it has
nothing to wait for.  :func:`cuda_time_fn` times on the device itself with
CUDA events, the host's enqueue included or, ``queued=True``, excluded.
"""

from __future__ import annotations

import time

import torch

__all__ = ["device_sync", "time_fn", "cuda_time_fn", "Timer"]


def _devices(x) -> set:
    """The CUDA devices of the tensors in ``x`` (a tensor, a sequence or
    mapping of them, or anything with ``shards``, such as a sharded state)."""
    if isinstance(x, torch.Tensor):
        return {x.device} if x.device.type == "cuda" else set()
    if hasattr(x, "shards"):
        x = list(x.shards.flat)
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return set().union(*(_devices(v) for v in x)) if x else set()
    return set()


def device_sync(x) -> None:
    """Block until the work that produces ``x`` (any tensor or nest of
    tensors) has run on its CUDA devices; a no-op for CPU tensors."""
    for dev in _devices(x):
        torch.cuda.synchronize(dev)


def time_fn(fn, *args, reps: int = 5, warmup: int = 1, **kwargs) -> float:
    """Median wall-clock seconds per call, synchronised on the devices of
    each call's result."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    device_sync(out)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        device_sync(out)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def cuda_time_fn(fn, *args, reps: int = 10, warmup: int = 2, device=None,
                 queued: bool = False, **kwargs) -> float:
    """Mean device milliseconds per call over ``reps`` back-to-back calls,
    between two CUDA events on ``device``'s current stream (the current
    device by default).  Where the host enqueues slower than the device
    runs, the events read the host's time.  ``queued=True`` reads the
    device's alone: the stream first sleeps until every call is enqueued,
    which the timer checks (the start event must still be pending once the
    last call is in), doubling the sleep until it holds; ``fn`` must not
    synchronise, and ``reps`` calls must not launch more kernels than the
    stream queues while it sleeps (600 could, 2,400 could not on an H100).
    Needs a CUDA device."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    torch.cuda.synchronize(device)
    stream = torch.cuda.current_stream(device)
    cycles = _SLEEP_CYCLES
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            with torch.cuda.stream(stream):
                torch.cuda._sleep(cycles)
        start.record(stream)
        for _ in range(reps):
            fn(*args, **kwargs)
        ahead = not start.query()
        end.record(stream)
        end.synchronize()
        if not queued or ahead:
            return start.elapsed_time(end) / reps
        cycles *= 2
        if cycles > _MAX_SLEEP_CYCLES:
            raise RuntimeError("the host could not enqueue the calls within the longest sleep")


_SLEEP_CYCLES = 1 << 22       # ~2 ms at the H100's 1.98 GHz
_MAX_SLEEP_CYCLES = 1 << 31   # ~1 s


class Timer:
    """Accumulating section timer (host clock)."""

    def __init__(self):
        self.sections: dict[str, float] = {}

    def section(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                timer.sections[name] = timer.sections.get(name, 0.0) + (
                    time.perf_counter() - self.t0
                )

        return _Ctx()
