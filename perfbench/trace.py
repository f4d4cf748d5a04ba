"""What a traced run records, and its reduction to per-layer inputs.

With ``--trace 1`` the window runs under ``torch.profiler`` with CUDA
activity only (the device's operations and the runtime calls that launched
them, kept in memory, no file written): recording every host operation as
well slowed a host-bound decode batch by 40-80% on the H100, against 10-40%
for this. The harness keeps its own ranges, on the host's realtime clock,
which is the profiler's, around its calls into the program and, through
:mod:`perfbench.instrument`, around the port's public kernel entry points.
Each device operation is given to the innermost harness range that was open
when the runtime call that launched it started (the profiler pairs them by
correlation id), so a renamed kernel still counts where it ran. Without
``--trace`` nothing is recorded and every range is a no-op.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch


class Recorder:
    """Ranges, call shapes and host spans of one run (empty when not traced)."""

    def __init__(self, traced: bool, device="cuda"):
        self.traced = traced
        self.cuda = torch.device(device).type == "cuda"
        self.calls: Dict[str, List[dict]] = defaultdict(list)
        self.host_ms: Dict[str, List[float]] = defaultdict(list)
        self.ranges: List[Tuple[int, int, str]] = []
        self._prof = None
        self.events = None

    @contextlib.contextmanager
    def range(self, name: str):
        if not self.traced:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.ranges.append((t0, time.time_ns(), name))

    @contextlib.contextmanager
    def host_span(self, name: str, sync: bool = True):
        """A range whose host time, synchronised on both sides, is kept."""
        if not self.traced:
            yield
            return
        sync = sync and self.cuda
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with self.range(name):
            yield
            if sync:
                torch.cuda.synchronize()
        self.host_ms[name].append((time.perf_counter() - t0) * 1e3)

    @contextlib.contextmanager
    def profiling(self):
        """The profiler around the window; the trace is reduced on the way
        out, and the profiler stopped whatever happens inside."""
        self.start()
        try:
            yield
        finally:
            self.stop()

    def start(self) -> None:
        if not self.traced:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if self.cuda else [ProfilerActivity.CPU]
        self._prof = profile(activities=acts)
        self._prof.__enter__()

    def stop(self) -> None:
        if not self.traced:
            return
        if self._prof is not None:
            if self.cuda:
                torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            raw = self._prof.profiler.kineto_results.events() if self.cuda else []
            self._prof = None
        else:
            raw = []
        self.events = TraceEvents(raw, self.ranges)


class TraceEvents:
    """Device operations with the harness range each was launched from."""

    def __init__(self, raw, ranges):
        cuda = torch.autograd.DeviceType.CUDA
        launches: Dict[int, int] = {}  # runtime call (correlation id) -> its start (ns)
        device: List[Tuple[int, int, str, int]] = []  # start, end, name, correlation
        for e in raw:
            if e.device_type() == cuda:
                device.append((e.start_ns(), e.end_ns(), e.name(), e.correlation_id()))
            elif e.correlation_id() > 0:
                launches.setdefault(e.correlation_id(), e.start_ns())
        ranges = sorted(ranges)
        self.ranges = [(s, e, name) for s, e, name in ranges]
        self.device = sorted(device)
        times = [launches.get(c) for _, _, _, c in self.device]
        self.unlinked = sum(t is None for t in times)
        self.range_of = self._innermost(times)

    def _innermost(self, times: List[Optional[int]]) -> List[Optional[str]]:
        """The innermost harness range open at each host time (ns): one sweep
        over the ranges' opening and closing, which nest in time (the
        autograd thread's ranges open while the main thread waits in
        ``backward``)."""
        marks = []
        for s, e, name in self.ranges:
            marks.append((s, 0, name))
            marks.append((e, 2, name))
        for i, t in enumerate(times):
            if t is not None:
                marks.append((t, 1, i))
        marks.sort(key=lambda m: (m[0], m[1]))
        out: List[Optional[str]] = [None] * len(times)
        stack: List[str] = []
        for _, kind, what in marks:
            if kind == 0:
                stack.append(what)
            elif kind == 2:
                for j in range(len(stack) - 1, -1, -1):
                    if stack[j] == what:
                        del stack[j]
                        break
            else:
                out[what] = stack[-1] if stack else None
        return out

    def device_s(self, range_name: str) -> float:
        """Summed device time of the operations launched inside ``range_name``."""
        return sum(e - s for (s, e, _, _), r in zip(self.device, self.range_of)
                   if r == range_name) / 1e9

    def by_range(self) -> Dict[str, float]:
        """Device seconds by the harness range the operations came from."""
        out: Dict[str, float] = defaultdict(float)
        for (s, e, _, _), r in zip(self.device, self.range_of):
            out[r or "none"] += (e - s) / 1e9
        return dict(out)

    def busy_intervals(self, t0: int, t1: int) -> List[Tuple[int, int]]:
        """The union of device operation intervals within [t0, t1] (ns)."""
        merged: List[List[int]] = []
        for s, e, _, _ in self.device:
            s, e = max(s, t0), min(e, t1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def span(self) -> Tuple[int, int]:
        """The window: the outermost ``window`` range."""
        for s, e, name in self.ranges:
            if name == "window":
                return s, e
        raise ValueError("no window range in the trace")

    def breakdown(self, top: int = 10) -> dict:
        t0, t1 = self.span()
        by_name: Dict[str, int] = defaultdict(int)
        for s, e, name, _ in self.device:
            if e > t0 and s < t1:
                by_name[name[:96]] += min(e, t1) - max(s, t0)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        holes: List[Tuple[int, int]] = []
        prev = t0
        for s, e in self.busy_intervals(t0, t1) + [(t1, t1)]:
            if s > prev:
                holes.append((prev, s - prev))
            prev = max(prev, e)
        gaps: Dict[str, List[int]] = defaultdict(list)
        for (_, length), where in zip(holes, self._innermost([h[0] for h in holes])):
            gaps[where or "outside any range"].append(length)
        idle = sorted(gaps.items(), key=lambda kv: -sum(kv[1]))[:top]
        return {
            "device_ops": [[n, ns / 1e9] for n, ns in ops],
            "idle_gaps": [[f"{n} ({len(g)} gaps, longest {max(g) / 1e6:.3f} ms)", sum(g) / 1e9]
                          for n, g in idle],
        }

    def busy_window_s(self) -> Tuple[float, float]:
        t0, t1 = self.span()
        busy = sum(e - s for s, e in self.busy_intervals(t0, t1))
        return busy / 1e9, (t1 - t0) / 1e9
