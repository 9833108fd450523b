"""The control readings of a cell at its own size: the plain reference in
bfloat16, the precision below the float32 the configuration states, put in
the program's place and judged as a run judges the program.

    python3 portbench/control.py --workload memcache.panel96 --jobs 230 \
        --seeds 11 12 13

`--jobs`: how many jobs a run's window completes, so that the control is
compared as often as the program is. Prints one JSON line a seed. Needs no
card; the benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--jobs", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import spec
    cell = spec.load_cell(args.workload)
    kind = spec.job_kind(cell.traffic["job"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        state = kind.draw(cell.config, cell.traffic, seed)
        checks, details = kind.control(state, args.jobs,
                                       workers=kind.reference_workers())
        print(json.dumps({
            "workload": args.workload, "seed": seed, "control": "bf16",
            "fails": any(v > lim for v, lim in checks.values()),
            "checks": {k: {"value": v, "limit": lim}
                       for k, (v, lim) in checks.items()},
            "details": details, "seconds": time.perf_counter() - t0}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
