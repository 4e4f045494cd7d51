"""Profiling hooks on ``torch.profiler``: traces, the port's spans and its
work counters.

Port of ``cellularautomatons3d_tpu.utils.profiling`` (a ``jax.profiler``
trace there)::

    with profile_trace("trace_dir") as prof:   # a Chrome trace in trace_dir
        engine.run_fused(150)
    print(prof.key_averages().table(sort_by="cuda_time_total"))

The port marks its layers with :func:`span`: while a profiler records, each
is a ``record_function`` range in the trace, on the clock of the device's
events and of every ``cudaLaunchKernel``, so an idle stretch of the device
can be set against the layer the host was in:

=========================  ==================================================
``ca3d.run_fused``         ``Engine.run_fused``
``ca3d.tick``              ``Engine.tick``
``ca3d.frame``             one frame of the fused loop (its steps and its
                           frame); the whole of a tick
``ca3d.step``              ``Engine.step``
``ca3d.occupancy``         a rendered frame's occupancy rebuild
                           (``render.renderer_fast``, ``render.render_slab``)
``ca3d.k1``                a rendered frame's ``raytrace_tiles``
``ca3d.lighting``          ``render.render_slab.lighting_passes``, with
                           ``.queries``, ``.states``, ``.occlusion`` and
                           ``.shade`` for its four steps
``ca3d.compose``           ``render.renderer_fast.compose_frame(_cuda)``
=========================  ==================================================

Inside the fused loop's frames of K1 alone only ``ca3d.frame`` opens: with a
profiler recording, the step, rebuild and K1 spans of every frame cost the
host more than that loop's headroom over the card (``PERF.md``).

Under the same test the occlusion kernel and the shade kernel count lanes
(:func:`work_counts`).  With no profiler recording a span is one attribute
test and a shared no-op context, and nothing counts.
"""

from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["profile_trace", "span", "recording", "count", "work_counts", "WORK_COUNTS"]

# The work counters: the lanes the occlusion kernel (K2) traced, and the
# lanes whose flag the shade kernel read.
WORK_COUNTS = ("occlusion_lanes", "occlusion_lanes_read")

_profiler = torch.autograd.profiler   # its _is_profiler_enabled is rebound, so read it here
_NO_SPAN = contextlib.nullcontext()
_twin_counts = dict.fromkeys(WORK_COUNTS, 0)


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


def recording() -> bool:
    """Whether a ``torch.profiler`` records: the test of every span and of
    the work counters."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A named range of the host's work: ``torch.profiler.record_function``
    while a profiler records, else a shared no-op context (no torch call,
    no allocation)."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def count(name: str, n) -> None:
    """Add ``n`` (an int or a tensor) to a plain twin's work counter; the
    twins call it only while a profiler records."""
    _twin_counts[name] += int(n)


def work_counts(device=None) -> dict[str, int]:
    """The work counters, cumulative, of the lanes counted while a profiler
    recorded: ``occlusion_lanes``, the lanes the occlusion kernel K2
    (``csrc/shadow_sweep.cu``) traced: active at its launch and, in a
    multi-bounce frame, alive by its gate of the last GI level's states, and
    ``occlusion_lanes_read``, the lanes whose flag the shade kernel
    (``csrc/lighting_shade.cu``, every form) read: a hit's direct-shadow
    lanes and each GI slot it evaluated as live.  On a CUDA device (the
    current one by default, where there is one) the kernels' counters, one
    pair a device, zero when the kernels' library loads: the call
    synchronises the device and copies them once, so no frame path calls
    it.  On ``"cpu"`` the plain twins' counts, wherever the twins ran.  K5
    (``CA3D_OCC_SWEEP=0``) counts nothing."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cpu":
        return dict(_twin_counts)
    from .. import kernels

    if not kernels.loaded():
        return dict.fromkeys(WORK_COUNTS, 0)
    index = torch.cuda.current_device() if device.index is None else device.index
    torch.cuda.synchronize(index)
    return kernels.work_counts(index)
