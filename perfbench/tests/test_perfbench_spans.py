"""The span metrics (``perfbench/spans.py``) on a hand-built trace with known
answers, a traced CPU run of each cell at the debug widths through
``perfbench.span_report``, and the benchmark's own readers reading the same
with the program's spans present as without them."""

import math
from types import SimpleNamespace

import pytest
import torch

from perfbench import spans, spec
from perfbench.readings import Readings
from perfbench.span_report import disabled_cost, report
from perfbench.trace import Recorder

from .conftest import small_config

MAIN, OTHER = 1, 2
CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    """A profiler event: a runtime call (CPU) or a device operation."""

    def __init__(self, dev, corr, start, end, name="op"):
        self._dev, self._corr, self._start, self._end, self._name = dev, corr, start, end, name

    def device_type(self):
        return self._dev

    def correlation_id(self):
        return self._corr

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def name(self):
        return self._name


def _sp(i, name, start, end, parent=None, rid=None, thread=MAIN):
    return SimpleNamespace(id=i, name=name, start_ns=start, end_ns=end, parent=parent, rid=rid,
                           thread=thread)


# runtime call (correlation, start ns) -> its device operations [(start, end)]
CALLS = {
    1: (120, [(130, 140)]),  # decode.step 0, outside its children
    2: (160, [(170, 200)]),  # decode.forward
    3: (200, [(210, 220), (220, 230), (230, 240)]),  # a graph launch: one launch
    4: (310, [(315, 318)]),  # the sync's copy
    5: (550, [(560, 570)]),  # decode.step 3
    6: (800, [(810, 820)]),  # no span
    9: (450, []),  # an event record: no device operation, no launch
    20: (2600, [(2610, 2620)]),  # the autograd thread, in train.backward by time
    21: (2100, [(2110, 2120)]),  # train.forward
    22: (3100, [(3110, 3120)]),  # after the step
    30: (4350, [(4360, 4370)]),
    31: (4550, [(4555, 4558)]),
    32: (4560, [(4570, 4580)]),
    40: (6150, [(6200, 6400)]),  # BERT
}
SPANS = [
    _sp(0, "decode.step", 100, 400), _sp(1, "decode.forward", 150, 250, 0),
    _sp(2, "decode.sync", 300, 380, 0), _sp(3, "decode.step", 500, 700),
    _sp(4, "decode.sync", 520, 600, 3),
    _sp(10, "train.step", 2000, 3000), _sp(11, "train.forward", 2000, 2400, 10),
    _sp(12, "train.backward", 2500, 2900, 10),
    _sp(13, "autograd.elsewhere", 3100, 3200, thread=OTHER),
    _sp(30, "serve.poll", 4000, 5000), _sp(31, "serve.admit", 4000, 4200, 30),
    _sp(32, "serve.step", 4300, 4400, 30), _sp(33, "serve.step", 4500, 4600, 30),
    _sp(34, "serve.queued", 3500, 4000, rid=0), _sp(35, "serve.queued", 3900, 4000, rid=1),
    _sp(36, "serve.in_slot", 4000, 5000, rid=0), _sp(37, "serve.in_slot", 4000, 5000, rid=1),
    _sp(40, "conditioner.tokenize", 6000, 6100), _sp(41, "conditioner.bert", 6100, 6500),
]
RANGES = [(0, 10_000, "window"), (90, 710, "decode"), (150, 250, "decoder_step"),
          (5990, 6600, "conditioner"), (2000, 3000, "train_step"),
          (2700, 2800, "optimizer"), (2050, 2150, "flash64_fwd"),
          (4340, 4390, "decode_attn")]
SHAPES = {"decode_attn": [{"rows": 8, "d": 768, "offsets": 66, "dtype": "bfloat16"}],
          "flash64_fwd": [{"bh": 96, "t": 1500, "dtype": "bfloat16", "with_lse": False}]}
EXPECTED = {
    "launches_per_step.decode": 5 / 2, "select_ms.decode": 120e-6,
    "sync_wait_ms.decode": 80e-6, "tokenize_ms.decode": 100e-6, "bert_ms.decode": 400e-6,
    "launches_per_step.serve": 3 / 2, "queue_wait_ms.serve": 500e-6,
    "in_slot_ms.serve": 1000e-6, "slot_use.serve": 75.0, "prefill_share.serve": 20.0,
    "launches_per_step.train": 2.0, "forward_ms.train": 400e-6, "backward_ms.train": 400e-6,
}


def _raw():
    raw = []
    for corr, (start, ops) in CALLS.items():
        raw.append(Ev(CPU, corr, start, start + 5, "cudaLaunchKernel"))
        raw.extend(Ev(CUDA, corr, s, e, f"k{corr}") for s, e in ops)
    return raw


def _stopped(cls, monkeypatch):
    """A recorder of ``cls`` stopped over the synthetic profiler events, as
    on the card."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    rec = cls(True, "cpu")
    rec.cuda = True
    rec.ranges = list(RANGES)
    rec._prof = _Prof(_raw())
    rec.stop()
    rec.host_ms.update({"conditioner": [0.61], "step.decode": [0.4, 0.5],
                        "step.serve": [0.2]})
    rec.calls.update(SHAPES)
    return rec


class _Prof:
    def __init__(self, events):
        self.profiler = SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events))

    def __exit__(self, *exc):
        return False


def _span_rec(monkeypatch) -> spans.SpanRecorder:
    rec = _stopped(spans.SpanRecorder, monkeypatch)
    rec.spans = list(SPANS)
    rec.counters = {"serve.tokens": 3, "serve.slot_steps": 4}
    return rec


def _span_readings(monkeypatch) -> spans.SpanReadings:
    return spans.SpanReadings(_span_rec(monkeypatch), {})


def test_launches_are_runtime_calls_with_device_work():
    calls = spans.runtime_launches(_raw())
    assert 9 not in calls and 3 in calls  # the event record is none, the graph one
    assert len(calls) == len(CALLS) - 1 and calls[20] == 2600


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_on_a_hand_built_trace(metric, monkeypatch):
    r = _span_readings(monkeypatch)
    assert spans.READERS[metric](r) == pytest.approx(EXPECTED[metric], rel=1e-12)


def test_readers_read_nothing_without_spans(monkeypatch):
    rec = _stopped(spans.SpanRecorder, monkeypatch)  # stopped, never started: no spans
    assert spans.read_all(spans.SpanReadings(rec, {})) == {}


def test_untraced_recorder_keeps_the_spans_alone():
    """Untraced, the sink is installed over the window all the same: the
    span times and counters read, the launches and the harness's calls do
    not."""
    from whisper_flamingo_tpu_torch import profiling

    rec = spans.SpanRecorder(False, "cpu")
    with rec.profiling():
        with profiling.span("decode.step"):
            with profiling.span("decode.sync"):
                pass
        profiling.count("serve.tokens", 3)
        profiling.count("serve.slot_steps", 4)
    assert profiling.span("decode.step") is profiling.span("x")  # the sink is gone again
    assert rec.events is None and rec.launches == {}
    got = spans.read_all(spans.SpanReadings(rec, {}))
    assert set(got) == {"select_ms.decode", "sync_wait_ms.decode", "slot_use.serve"}
    assert got["slot_use.serve"] == 75.0


def test_clock_agreement_and_idle_gaps(monkeypatch):
    r = _span_readings(monkeypatch)
    assert r.range_launches_in_span("decoder_step", "decode.forward") == 1.0
    assert r.range_launches_in_span("decoder_step", "serve.step") == 0.0
    assert r.range_launches_in_span("encoder", "decode.forward") is None
    notes = spans.notes(r, main_thread=MAIN)
    gaps = notes["idle_gaps_by_span"]
    # 140-170 in the step outside its children; 200-210 and 240-315 in the forward
    assert gaps["decode.step"][0] >= 1
    assert gaps["decode.forward"][:2] == [2, pytest.approx(85e-9, rel=1e-12)]
    # the gap from 3120 lies in another thread's span only: the harness range takes it
    assert "autograd.elsewhere" not in gaps and "range:window" in gaps
    assert notes["span_cover"]["decoder_step"] == 1.0
    assert 0 < notes["span_cover"]["window"] < 1
    assert notes["span_self_ms"]["decode.step"] == [2, 240e-6]
    by = notes["launches_by_span"]
    assert by["decode.step"] == [5, 2] and by["decode.forward"] == [2, 1]
    assert by["decode.sync"] == [2, 2] and by["train.backward"] == [1, 1]
    total = sum(g[1] for g in gaps.values())
    busy, window = r.busy_s, r.window_s
    assert math.isclose(total, window - busy, rel_tol=1e-12)


def test_existing_readers_unchanged_with_program_spans(monkeypatch):
    plain = _stopped(Recorder, monkeypatch)
    with_spans = _span_rec(monkeypatch)
    stats = {"units": 2, "flops": 1e12, "window_s": 1e-5}
    a = Readings(plain, stats)
    b = spans.SpanReadings(with_spans, stats)
    assert plain.events.range_of == with_spans.events.range_of
    assert plain.events.breakdown() == with_spans.events.breakdown()
    assert plain.events.by_range() == with_spans.events.by_range()
    names = {m["name"] for m in spec.benchmark()["per_layer"]}
    read = {n: (spec.reader(n)(a), spec.reader(n)(b)) for n in sorted(names)}
    assert all(x == y for x, y in read.values()), read
    assert sum(x is not None for x, _ in read.values()) >= 10


CELLS = {
    "flamingo-small-text.beam15": ("flamingo-small-text", {"units": 1}, ".decode"),
    "whisper-large-v2.serve-poisson": ("whisper-large-v2", {"seconds": 3}, ".serve"),
    "whisper-large-v2.finetune": ("whisper-large-v2", {"units": 1}, ".train"),
}


def test_untraced_cpu_run_reads_the_serving_span_metrics():
    out = report("whisper-large-v2.serve-poisson", 3_000_000_019, 3, traced=False,
                 device="cpu", config=small_config("whisper-large-v2"))
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"request_p95_ms", "setup_s"}
    got = out["span_metrics"]
    assert set(got) == {n for n in spans.READERS
                        if n.endswith(".serve") and not n.startswith("launches_per")}, got
    assert all(math.isfinite(v) for v in got.values())
    assert 0 < got["slot_use.serve"] <= 100


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_traced_cpu_run_reads_every_span_metric(cell):
    cfg_name, window, kind = CELLS[cell]
    out = report(cell, 3_000_000_019, window.get("seconds", 0), device="cpu",
                 config=small_config(cfg_name), units=window.get("units", 0))
    assert out["correct"], out["checks"]
    want = {n for n in spans.READERS if n.endswith(kind) and not n.startswith("launches_per")}
    got = out["span_metrics"]
    assert set(got) == want, got
    assert all(math.isfinite(v) for v in got.values())
    assert not any(n.startswith("launches_per") for n in got)  # no device on the CPU
    # no device operation: the whole window is one gap, from its start
    assert list(out["_notes"]["idle_gaps_by_span"]) == ["range:window"]
    assert out["_notes"]["span_self_ms"]


def test_disabled_cost_reports_every_call():
    cost = disabled_cost(calls=1000)
    assert set(cost) == {"span", "record", "count", "stamp", "empty_loop"}
    assert all(v > 0 for v in cost.values())
