"""A run of one cell with the program's spans: the span metrics and where
the host's time goes.

    python3 -m perfbench.span_report --workload <cell> --seed <n> --seconds <s> [--trace 0|1]
    python3 -m perfbench.span_report --disabled-cost

The first form is ``perfbench.run --workload ... --trace <0|1>`` with the
recorder of :mod:`perfbench.spans`: the program's span sink installed over
the window, and, traced, the launches kept. It prints one ``notes`` line
and then the result line, whose ``metrics`` are the benchmark's own (the
end-to-end ones untraced, the per-layer ones traced) and whose
``span_metrics`` are :data:`perfbench.spans.READERS` that find something to
read. Traced, the notes add the idle gaps by program span, each span's self
time, and the clocks' agreement: the share of the launches the harness
gives to ``decoder_step`` that start in a ``decode.forward`` or
``serve.step`` span. Untraced, the span times are read at the cell's own
load, with no profiler in the way (the launch metrics need it, and read
nothing). The traced run without the sink, to hold the sink's cost
against, is ``perfbench.run --trace 1``. The second form times the
program's span, record, count and stamp calls with no sink installed, on
the host (ns a call).
"""

from __future__ import annotations

import argparse
import json
import sys
import timeit
from unittest import mock


def report(cell: str, seed: int, seconds: float, *, traced: bool = True, device: str = "cuda",
           config=None, units: int = 0) -> dict:
    """Run the cell through :func:`perfbench.run.run_cell` with a
    :class:`perfbench.spans.SpanRecorder`; returns its result with
    ``span_metrics`` added, and, traced, the span notes."""
    from . import run, spans, trace

    made = []

    def recorder(traced, dev="cuda"):
        made.append(spans.SpanRecorder(traced, dev))
        return made[-1]

    with mock.patch.object(trace, "Recorder", recorder):
        out = run.run_cell(cell, seed, seconds, traced, device=device, config=config,
                           units=units)
    r = spans.SpanReadings(made[-1], {})
    out["span_metrics"] = spans.read_all(r)
    if not traced:
        return out
    out["_notes"].update(spans.notes(r), clock={
        "decoder_step_in_decode_forward": r.range_launches_in_span("decoder_step",
                                                                   "decode.forward"),
        "decoder_step_in_serve_step": r.range_launches_in_span("decoder_step", "serve.step"),
        "launches": len(r.launch_ns)})
    return out


def disabled_cost(calls: int = 1_000_000) -> dict:
    """ns per call of each of the program's span calls with no sink."""
    from whisper_flamingo_tpu_torch import profiling

    env = {"profiling": profiling}
    stmts = {"span": 'with profiling.span("decode.step"):\n    pass',
             "record": 'profiling.record("serve.queued", 0, 1, rid=3)',
             "count": 'profiling.count("serve.slot_steps", 16)',
             "stamp": "profiling.stamp()",
             "empty_loop": "pass"}
    return {name: 1e9 * min(timeit.repeat(stmt, globals=env, number=calls, repeat=5)) / calls
            for name, stmt in stmts.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--disabled-cost", action="store_true")
    args = ap.parse_args(argv)
    if args.disabled_cost:
        print(json.dumps({"disabled_ns_per_call": disabled_cost()}), flush=True)
        return 0
    if not args.workload:
        ap.error("--workload is required")

    import torch

    if not torch.cuda.is_available():
        print("perfbench.span_report: no CUDA device", file=sys.stderr)
        return 2
    from .run import result_line

    out = report(args.workload, args.seed, args.seconds, traced=bool(args.trace))
    print(json.dumps({"notes": out.pop("_notes")}), flush=True)
    line = json.loads(result_line(out))
    line["span_metrics"] = out["span_metrics"]
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
