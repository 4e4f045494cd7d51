#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the card::

    python3 benchmark/run.py --workload clustered256.pinned --seed 7 --seconds 10 --trace 0

Prints one JSON line as the last line of standard output: ``correct``,
``attempted`` (frames completed in the window), ``failed`` (checked answers
the reference refused), ``metrics`` (with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a traced
stretch), ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``:
each number compared with the reference beside its limit, which also end
standard error.  Exits non-zero with nothing on standard output without the
CUDA devices the cell needs, when a module of JAX or of the JAX package is
loaded once the window has closed, when the trace lost kernel launches, or,
before the Engine is built, for a configuration whose frames take a path the
check cannot replay.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # the set-up time counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]
os.environ.setdefault("USE_FLAX", "0")

import harness  # noqa: E402

T_HARNESS = time.perf_counter() - T0  # torch, numpy and the harness loaded


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        rec, extra = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T0)
    except harness.HarnessError as err:
        print(f"benchmark: {err}", file=sys.stderr, flush=True)
        return err.code
    except harness.NotInReference as err:
        print(f"benchmark: {type(err).__name__}: {err}", file=sys.stderr, flush=True)
        return 5
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: modules of {', '.join(found)} are loaded", file=sys.stderr, flush=True)
        return 3
    stages = [("torch", T_HARNESS)] + extra["stages"]
    print("set-up stages (s from start): " + ", ".join(f"{k} {v:.3f}" for k, v in stages),
          file=sys.stderr)
    print("frame ms by quarter of the window: " + ", ".join(f"{q:.5f}" for q in extra["quarters"]),
          file=sys.stderr)
    for i, r in enumerate(extra["readings"]):
        print(f"answer {i}: " + ", ".join(f"{k} {v}" for k, v in r.items()), file=sys.stderr)
    for k, c in rec["checks"].items():
        print(f"{k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
