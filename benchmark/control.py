#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card::

    python3 benchmark/control.py --workload pbr256.orbit --seeds 11,12,13 --seconds 2 \\
        [--control-seeds 3] [--out FILE]

For each seed, one run of the cell with a short window: the numbers the
check compares for the program's answers (the lower readings), and for the
first ``--control-seeds`` seeds the same numbers for the control, the
reference computed in bfloat16, one precision below the configuration's
float32, put in the program's place on the same inputs (the upper
readings).  One process for every seed, so the set-up is paid once for the
CUDA context.  Prints one JSON line per seed and writes them to ``--out``
too.  The benchmark's own runs do not run the control.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import torch  # noqa: E402

import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        rec, extra = harness.run(args.workload, seed, args.seconds, False, t0, keep_samples=True)
        row = {"workload": args.workload, "seed": seed, "correct": rec["correct"],
               "program": extra["readings"], "frame_ms": rec["metrics"]["frame_ms"]["value"]}
        if i < args.control_seeds:
            cell = harness.load_cell(args.workload)
            e = harness.engine_settings(cell.config, cell.mix, seed, None)
            row["control"] = harness.check(cell, e, seed, extra["samples"], torch.device("cuda"),
                                           control=torch.bfloat16)
        row["seconds"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del extra
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
