"""What a per-layer metric's reader is given in a traced run.

- ``events``: the device operations with their harness ranges
  (:class:`perfbench.trace.TraceEvents`), ``busy_s`` and ``window_s``;
- ``calls``: the shapes of each instrumented call, by range name;
- ``host_ms``: host spans (synchronised ones and the gaps between
  consecutive decoder steps), by name;
- ``stats``: the driver's counts for the window (``units``, ``flops``,
  ``window_s`` ...).

A reader returns ``None`` when its cell gives it nothing to read.
"""

from __future__ import annotations

from statistics import fmean
from typing import Optional


class Readings:
    def __init__(self, rec, stats: dict):
        self.events = rec.events
        self.calls = rec.calls
        self.host_ms = rec.host_ms
        self.stats = stats
        self.busy_s, self.window_s = rec.events.busy_window_s()

    def mean_host_ms(self, name: str) -> Optional[float]:
        values = self.host_ms.get(name)
        return fmean(values) if values else None

    def device_s(self, range_name: str) -> float:
        return self.events.device_s(range_name)

    def roofline_pct(self, range_name: str, least_s) -> Optional[float]:
        """100 x (the calls' summed least time) / (their device time)."""
        calls = self.calls.get(range_name)
        dev = self.device_s(range_name)
        if not calls or dev <= 0:
            return None
        return 100.0 * sum(least_s(c) for c in calls) / dev
