"""The test size of a run: a 32³ grid, a 64×32 window, short mixes."""

SMALL = {"grid": 32, "width": 64, "height": 32,
         "mix": {"start_generation": 6, "frames_per_call": 4, "reset_every": 2, "warmup_calls": 2, "trace_calls": 1,
                 "warmup_ticks": 4, "trace_ticks": 3, "sample_below": 2}}
SEED = 2**31 + 977   # beyond 32 signed bits: seeds may be that large


def run(cell, seconds=0.2, trace=False, **kw):
    import time

    import harness
    return harness.run(cell, SEED, seconds, trace, time.perf_counter(), device="cpu",
                       small=SMALL, **kw)
