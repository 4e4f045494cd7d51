"""Profiling hooks on ``torch.profiler``.

Port of ``cellularautomatons3d_tpu.utils.profiling`` (a ``jax.profiler``
trace and section timing there)::

    with profile_trace("trace_dir") as prof:   # a Chrome trace in trace_dir
        engine.step(100)
    print(prof.key_averages().table(sort_by="cuda_time_total"))

    stats = profile_engine(engine, steps=50, frames=10)
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from .metrics import device_sync

__all__ = ["profile_trace", "profile_engine"]


@contextlib.contextmanager
def profile_trace(log_dir: str | None = None):
    """A ``torch.profiler`` trace of the block: host operations and, where a
    CUDA device is present, its kernels.  Yields the profiler (for
    ``key_averages()`` / ``events()``); with ``log_dir``, writes
    ``trace.json`` (Chrome trace format) there on exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def profile_engine(engine, steps: int = 50, frames: int = 5) -> dict:
    """Wall-clock Engine stats, each timed window ended by a synchronise of
    the devices that hold the state or the frame."""
    engine.step(1)
    device_sync(engine.state)
    t0 = time.perf_counter()
    engine.step(steps)
    device_sync(engine.state)
    step_s = (time.perf_counter() - t0) / steps

    frame = engine.render()
    device_sync(frame)
    t0 = time.perf_counter()
    for _ in range(frames):
        frame = engine.render()
    device_sync(frame)
    frame_s = (time.perf_counter() - t0) / frames

    return {
        "steps_per_sec": 1.0 / step_s,
        "step_ms": step_s * 1e3,
        "frame_ms": frame_s * 1e3,
        "fps": 1.0 / frame_s,
        "grid_size": engine.config.grid_size,
        "resolution": (engine.config.width, engine.config.height),
        "pipeline": engine.config.pipeline,
        "device": str(engine.device if engine.mesh is None else engine.mesh),
    }
