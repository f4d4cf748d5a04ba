"""Find the serving knee: the highest arrival rate the program sustains.

    python3 -m perfbench.sweep --workload <serving cell> --rates 4,6,8,10 [--seconds 30]

One process sets the cell up once, then runs one window per rate on the
cell's traffic with only ``rate_per_s`` changed, and prints one JSON line per
rate: requests, failures, served tokens per second, the median and 95th
percentile latency over all requests and over the first and last third of
the arrivals, the backlog at the close and the generator's lateness. A rate
is sustained when nothing fails and the last third's tail is not above the
first third's by more than the spread of a steady queue (the backlog does
not grow through the window). The cell's rate is about 0.8 of the highest
sustained one; PERF.md keeps the sweep.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=4242)
    args = ap.parse_args(argv)

    import torch

    from . import spec
    from .trace import Recorder

    if not torch.cuda.is_available():
        print("perfbench.sweep: no CUDA device", file=sys.stderr)
        return 2
    w = spec.workload(spec.benchmark(), args.workload)
    traffic = spec.traffic(w["traffic"])
    drv = spec.driver(traffic["driver"]).Driver(spec.config(w["config"]), traffic, args.seed,
                                               Recorder(False), "cuda", seconds=args.seconds)
    drv.setup()
    for rate in (float(r) for r in args.rates.split(",")):
        drv.plan = drv.schedule(rate, args.seconds)
        stats = drv.run_window()
        print(json.dumps({"rate_per_s": rate, "requests": stats["attempted"],
                          "failed": stats["failed"],
                          "p95_ms": stats["e2e"]["request_p95_ms"], **stats["notes"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
