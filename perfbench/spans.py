"""The program's own spans and counters in a run, beside the harness's
ranges.

:class:`SpanRecorder` is a run's :class:`perfbench.trace.Recorder` that also
installs the program's span sink (``whisper_flamingo_tpu_torch.profiling.
collect``) over the window, traced or not, and, when traced, keeps from the
profiler the start of every runtime call that put at least one device
operation on the card: a *launch* (a CUDA-graph launch, whose operations
share its correlation id, counts once). :class:`SpanReadings` adds to
:class:`perfbench.readings.Readings` the spans, the counters and a second
attribution, separate from the harness's: each launch goes to every
program span whose interval holds its start, on any thread (so the autograd
thread's launches count inside the main thread's ``train.step``). Untraced,
it holds the spans and counters alone, and the metrics that need the
profiler or the harness's ranges read ``None``.

``READERS`` are the span metrics, each ``read(readings) -> float or None``
like a reader of ``perfbench/metrics/``; :func:`notes` puts each idle gap of
the device down to the innermost program span the main thread was in at
its start (else its harness range) and sums each span's self time. The
benchmark's own runs (``perfbench.run``) read neither yet:
``python3 -m perfbench.span_report`` runs a cell with them.
"""

from __future__ import annotations

import bisect
import threading
from collections import defaultdict
from statistics import fmean
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .readings import Readings
from .trace import Recorder, TraceEvents

# spans recorded with ``profiling.record``: they cross calls and do not nest
CROSSING = ("serve.queued", "serve.in_slot")


def runtime_launches(raw) -> Dict[int, int]:
    """Correlation id -> start (ns) of each runtime call that put at least
    one device operation on the card."""
    cuda = torch.autograd.DeviceType.CUDA
    with_ops = {e.correlation_id() for e in raw if e.device_type() == cuda}
    calls: Dict[int, int] = {}
    for e in raw:
        c = e.correlation_id()
        if e.device_type() != cuda and c in with_ops:
            calls.setdefault(c, e.start_ns())
    return calls


class SpanRecorder(Recorder):
    """A :class:`Recorder` that also installs the program's span sink over
    the window, traced or not, and, when traced, keeps the launches' starts
    (``launches``: correlation id -> ns)."""

    def __init__(self, traced: bool, device="cuda"):
        super().__init__(traced, device)
        self.spans: list = []
        self.counters: Dict[str, int] = {}
        self.launches: Dict[int, int] = {}
        self._collect = None

    def start(self) -> None:
        super().start()
        from whisper_flamingo_tpu_torch import profiling

        self._collect = profiling.collect()
        self._spans = self._collect.__enter__()

    def stop(self) -> None:
        if self._collect is not None:
            self._collect.__exit__(None, None, None)
            self._collect = None
            self.spans, self.counters = list(self._spans.spans), dict(self._spans.counters)
        prof = self._prof
        super().stop()
        if prof is not None and self.cuda:
            self.launches = runtime_launches(prof.profiler.kineto_results.events())


def _merged(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def count_within(times: List[int], intervals: List[Tuple[int, int]]) -> int:
    """How many of the sorted ``times`` lie in the union of ``intervals``
    (ends included)."""
    return sum(bisect.bisect_right(times, e) - bisect.bisect_left(times, s)
               for s, e in _merged(intervals))


class SpanReadings(Readings):
    """:class:`Readings` with the program's spans and counters, and the
    launches by the program span they started in."""

    def __init__(self, rec: SpanRecorder, stats: dict):
        if rec.events is not None:
            super().__init__(rec, stats)
        else:  # untraced: the program's spans and counters alone
            self.events = None
        self.spans = rec.spans
        self.counters = rec.counters
        self.launches = rec.launches
        self.launch_ns = sorted(rec.launches.values())
        kids: Dict[int, int] = defaultdict(int)
        for sp in self.spans:
            if sp.parent is not None:
                kids[sp.parent] += sp.end_ns - sp.start_ns
        self._child_ns = kids

    def named(self, name: str) -> list:
        return [sp for sp in self.spans if sp.name == name]

    def durations_ms(self, name: str) -> List[float]:
        return [(sp.end_ns - sp.start_ns) / 1e6 for sp in self.named(name)]

    def self_ms(self, name: str) -> List[float]:
        """Each span's duration less its direct children's."""
        return [(sp.end_ns - sp.start_ns - self._child_ns.get(sp.id, 0)) / 1e6
                for sp in self.named(name)]

    def launches_in(self, name: str) -> Optional[int]:
        """Launches started inside ``name`` spans; ``None`` when the trace
        holds no launch at all (no device, or untraced)."""
        if not self.launch_ns:
            return None
        return count_within(self.launch_ns, [(sp.start_ns, sp.end_ns) for sp in self.named(name)])

    def per_span(self, name: str, total: Optional[float]) -> Optional[float]:
        n = len(self.named(name))
        return total / n if (n and total is not None) else None

    def harness_calls(self, range_name: str) -> int:
        """The harness ranges of ``range_name`` in the window (none when
        untraced)."""
        if self.events is None:
            return 0
        t0, t1 = self.events.span()
        return sum(1 for s, e, name in self.events.ranges if name == range_name and t0 <= s <= t1)

    def range_launches_in_span(self, range_name: str, span_name: str) -> Optional[float]:
        """The share of the launches the harness gives to ``range_name``
        (distinct runtime calls) whose start lies in a ``span_name`` span:
        the two clocks' agreement."""
        if self.events is None:
            return None
        corr = {c for (_, _, _, c), r in zip(self.events.device, self.events.range_of)
                if r == range_name and c in self.launches}
        if not corr:
            return None
        times = sorted(self.launches[c] for c in corr)
        inside = count_within(times, [(sp.start_ns, sp.end_ns) for sp in self.named(span_name)])
        return inside / len(times)


def _p95(values: List[float]) -> Optional[float]:
    """The nearest-rank 95th percentile (the serving cell's own rule)."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, -(-95 * len(v) // 100) - 1)]


def _mean(values: List[float]) -> Optional[float]:
    return fmean(values) if values else None


def _per_call(r: SpanReadings, span: str, range_name: str) -> Optional[float]:
    calls = r.harness_calls(range_name)
    spans = r.durations_ms(span)
    return sum(spans) / calls if (calls and spans) else None


def _share(num: float, den: float) -> Optional[float]:
    return 100.0 * num / den if den else None


READERS: Dict[str, Callable[[SpanReadings], Optional[float]]] = {
    "launches_per_step.decode": lambda r: r.per_span("decode.step", r.launches_in("decode.step")),
    "select_ms.decode": lambda r: _mean(r.self_ms("decode.step")),
    "sync_wait_ms.decode": lambda r: r.per_span("decode.step", sum(r.durations_ms("decode.sync"))),
    "tokenize_ms.decode": lambda r: _per_call(r, "conditioner.tokenize", "conditioner"),
    "bert_ms.decode": lambda r: _per_call(r, "conditioner.bert", "conditioner"),
    "launches_per_step.serve": lambda r: r.per_span("serve.step", r.launches_in("serve.step")),
    "queue_wait_ms.serve": lambda r: _p95(r.durations_ms("serve.queued")),
    "in_slot_ms.serve": lambda r: _p95(r.durations_ms("serve.in_slot")),
    "slot_use.serve": lambda r: _share(r.counters.get("serve.tokens", 0),
                                       r.counters.get("serve.slot_steps", 0)),
    "prefill_share.serve": lambda r: _share(sum(r.durations_ms("serve.admit")),
                                            sum(r.durations_ms("serve.poll"))),
    "launches_per_step.train": lambda r: r.per_span("train.step", r.launches_in("train.step")),
    "forward_ms.train": lambda r: r.per_span("train.step", sum(r.durations_ms("train.forward"))),
    "backward_ms.train": lambda r: r.per_span("train.step",
                                              sum(r.durations_ms("train.backward"))),
}


def read_all(r: SpanReadings) -> Dict[str, float]:
    """Every span metric that finds something to read."""
    out = {}
    for name, read in READERS.items():
        value = read(r)
        if value is not None:
            out[name] = value
    return out


def notes(r: SpanReadings, main_thread: Optional[int] = None) -> dict:
    """``idle_gaps_by_span``: each idle gap of the device in the window put
    down to the innermost program span open on the main thread at its
    start, else to its harness range (``range:<name>``): [gaps, seconds,
    longest ms]; ``span_cover``: per harness range, the share of the idle
    time it holds that a program span covers; ``span_self_ms``: per span
    name, [count, total self ms]; ``launches_by_span``: per span name,
    [launches started inside (its children's included), spans]."""
    main = main_thread if main_thread is not None else threading.main_thread().ident
    t0, t1 = r.events.span()
    holes: List[Tuple[int, int]] = []
    prev = t0
    for s, e in r.events.busy_intervals(t0, t1) + [(t1, t1)]:
        if s > prev:
            holes.append((prev, s - prev))
        prev = max(prev, e)
    starts = [h[0] for h in holes]
    nested = [(sp.start_ns, sp.end_ns, sp.name) for sp in r.spans
              if sp.thread == main and sp.name not in CROSSING]
    by_span = TraceEvents([], nested)._innermost(starts)  # one thread's spans nest in time
    by_range = r.events._innermost(starts)
    gaps: Dict[str, List[int]] = defaultdict(list)
    cover: Dict[str, List[int]] = defaultdict(lambda: [0, 0])
    for (_, length), sp, rng in zip(holes, by_span, by_range):
        rng = rng or "outside any range"
        gaps[sp if sp is not None else f"range:{rng}"].append(length)
        cover[rng][0] += length if sp is not None else 0
        cover[rng][1] += length
    self_ms: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for sp in r.spans:
        self_ms[sp.name][0] += 1
        self_ms[sp.name][1] += (sp.end_ns - sp.start_ns - r._child_ns.get(sp.id, 0)) / 1e6
    return {
        "idle_gaps_by_span": {k: [len(g), sum(g) / 1e9, max(g) / 1e6]
                              for k, g in sorted(gaps.items(), key=lambda kv: -sum(kv[1]))},
        "span_cover": {k: c / total for k, (c, total) in cover.items() if total},
        "span_self_ms": dict(self_ms),
        "launches_by_span": {name: [r.launches_in(name), len(r.named(name))]
                             for name in sorted({sp.name for sp in r.spans} - set(CROSSING))
                             if r.launch_ns},
    }
