"""Readings that the limits of ``correct`` are set from, in one process.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 --controls 3 --seconds 2

For each seed, one run of the cell at its own size and load (a short window
of ``--seconds``) with the program's readings; for the first ``--controls``
seeds also the controls' readings: the reference computed in the precision
below the configuration's (``fp8`` for a bf16 cell, ``tf32`` for a float32
one) and, for training, the reference on half of each batch
(``half_batch``).  One JSON line per seed; the benchmark's own runs never
compute the controls.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    from benchmark import spec
    from benchmark.run import execute

    cell = spec.load_cell(args.workload)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        out = execute(cell, seed, args.seconds, False, "cuda", controls=i < args.controls)
        r = out["result"]
        print(json.dumps({"seed": seed, "readings": out["readings"],
                          "controls": out["controls"], "attempted": r["attempted"],
                          "failed": r["failed"], "metrics": r["metrics"],
                          "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
