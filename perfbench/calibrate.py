"""Readings for the limits of a cell's ``correct`` check, in one process.

    python3 -m perfbench.calibrate --workload <cell> --seeds 1,2,3 [--control none|fp8] [--units 2]

For each seed: the program's set-up, a window of ``--units`` units (at the
cell's own load) and the check, printing one JSON line of the compared
numbers. With ``--control fp8`` the reference computed in fp8 stands in
the program's place over the same inputs and tokens: the control, whose
numbers have to fail the limits; ``--fault`` plants one of
:mod:`perfbench.faults` under the program. The limits in
``perfbench/limits/`` are set from these readings (PERF.md gives them); the
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", choices=("none", "fp8"), default="none")
    ap.add_argument("--units", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--fault", default="", help="a fault of perfbench.faults, planted")
    args = ap.parse_args(argv)

    import torch

    import contextlib

    from .faults import FAULTS
    from .run import run_cell

    if not torch.cuda.is_available():
        print("perfbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        control = None if args.control == "none" else args.control
        with FAULTS[args.fault]() if args.fault else contextlib.nullcontext():
            out = run_cell(args.workload, seed, args.seconds, False, control=control,
                           units=args.units)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "fault": args.fault,
                          "checks": out["checks"], "attempted": out["attempted"],
                          "failed": out["failed"], "metrics": out["metrics"],
                          "notes": out["_notes"],
                          "wall_s": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
