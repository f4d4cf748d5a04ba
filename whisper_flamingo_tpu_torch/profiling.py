"""Profiling: spans and counters inside the program, and the trace, FLOP
and device-time helpers.

Port of ``whisper_flamingo_tpu/profiling.py``, with the span recorder added:

- :func:`collect` installs an in-memory :class:`Spans` sink for the block;
  while it is installed, :func:`span` records a named interval (with its
  parent, the innermost span open on the same thread, a request id and the
  thread), :func:`record` one that crosses calls (a request's wait in a
  queue), :func:`count` adds to a named counter and :func:`stamp` reads the
  clock. With no sink installed each of them returns at once after one
  test of a module global: no clock read, no allocation. Times are
  ``time.time_ns()``, the clock of ``torch.profiler``'s runtime events, so
  spans and the profiler's device operations share one timeline. Spans do
  no device work and never synchronise;
- :func:`trace`: a ``torch.profiler`` context (CPU and CUDA activities)
  that writes a Chrome trace into a directory;
- :func:`model_flops`: analytic FLOPs of one Whisper forward (encoder and
  teacher-forced decoder), the JAX package's count;
- :func:`mfu`: model FLOPs utilization against the H100's dense bf16 peak;
- :func:`device_span_ms`: the device time of one call between CUDA events.

The spans the port opens, and where: ``conditioner.tokenize`` and
``conditioner.bert`` (``models/bert.HFBertConditioner.encode``);
``decode.step``, its children ``decode.forward`` and ``decode.sync``, and
the counters ``decode.reorder_indirect`` and ``decode.reorder_copied``, the
beam steps whose reorder was the row table's and those that still moved
the self cache (int8kv) (``decoding.DecodingTask._main_loop``);
``decode.capture`` inside a
``decode.forward`` and the counters ``decode.graph_steps``,
``decode.eager_steps`` and ``decode.graph_captures``
(``models.whisper.StepGraphs``); the counters ``decode.xattn_kernel`` and
``decode.xattn_plain``, the cached cross-attentions on the card sent to the
kernel and to the plain product (``ops.attention.xa_qkv_attention``, counted
at the Python call: a captured segment's calls once, at capture);
``serve.poll``, ``serve.admit``,
``serve.step``, per request ``serve.queued`` and ``serve.in_slot``, and the
counters ``serve.slot_steps`` and ``serve.tokens``
(``serving.ContinuousBatcher``); ``train.step``, ``train.forward`` and
``train.backward`` (``training/steps``), and in the audio-visual step
``train.frozen`` (the frozen trunk and encoder forwards) and the counters
``train.av_both``, ``train.av_audio`` and ``train.av_video`` (its
modality draws); ``train.allreduce`` and the counter
``train.allreduce_bytes`` (``training/optim.WhisperOptimizer``: the
data-parallel gradient average); ``av.trunk`` with its children
``av.frontend`` and ``av.transformer``, and the counters ``av.frames`` and
``av.pad_frames`` (``models/avhubert.avhubert_encoder_apply``,
``models/visual.visual_frontend_apply``).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import Counter
from typing import Iterator, List, NamedTuple, Optional

from .models.dims import ModelDimensions

H100_BF16_PEAK_FLOPS = 989e12  # dense, SXM part at its 700 W limit


class SpanRecord(NamedTuple):
    """One closed span: ``parent`` is the ``id`` of the innermost span open
    on ``thread`` when it opened (``None`` at the top, and for
    :func:`record`); times in ns on ``time.time_ns()``."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    rid: Optional[int]
    thread: int


class Spans:
    """The in-memory sink :func:`collect` installs: the closed spans in the
    order they closed, and the counters. Spans may close on any thread;
    counters are added to by the thread that owns the counted object."""

    def __init__(self):
        self.spans: List[SpanRecord] = []
        self.counters: Counter = Counter()
        self._ids = itertools.count()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


class _Span:
    """An open span of an installed sink."""

    __slots__ = ("sink", "name", "rid", "id", "parent", "start_ns")

    def __init__(self, sink: Spans, name: str, rid: Optional[int]):
        self.sink, self.name, self.rid = sink, name, rid

    def __enter__(self) -> "_Span":
        stack = self.sink._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(self.sink._ids)
        stack.append(self.id)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        self.sink._stack().pop()
        self.sink.spans.append(SpanRecord(self.id, self.name, self.start_ns, end, self.parent,
                                          self.rid, threading.get_ident()))
        return False


class _NoSpan:
    """The one shared no-op span handed out while no sink is installed."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()
_sink: Optional[Spans] = None


@contextlib.contextmanager
def collect() -> Iterator[Spans]:
    """Install a fresh :class:`Spans` sink over the block and yield it; the
    sink installed before (usually none) comes back on the way out."""
    global _sink
    prev, _sink = _sink, Spans()
    try:
        yield _sink
    finally:
        _sink = prev


def span(name: str, rid: Optional[int] = None):
    """A context that records ``name`` around its block while a sink is
    installed; else the shared no-op context."""
    sink = _sink
    if sink is None:
        return _NO_SPAN
    return _Span(sink, name, rid)


def record(name: str, start_ns: int, end_ns: int, rid: Optional[int] = None) -> None:
    """Record a span whose ends were stamped apart (:func:`stamp`)."""
    sink = _sink
    if sink is None:
        return
    sink.spans.append(SpanRecord(next(sink._ids), name, start_ns, end_ns, None, rid,
                                 threading.get_ident()))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a sink is installed."""
    sink = _sink
    if sink is None:
        return
    sink.counters[name] += n


def stamp() -> Optional[int]:
    """``time.time_ns()`` while a sink is installed, else ``None``."""
    if _sink is None:
        return None
    return time.time_ns()


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (CPU and, with a card, CUDA
    activities); writes ``<log_dir>/trace.json`` (open it in Perfetto or
    chrome://tracing) and yields the profiler for ``key_averages()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def model_flops(
    dims: ModelDimensions,
    batch: int,
    mel_frames: int = 3000,
    text_len: int = 128,
    n_xt_streams: int = 0,
    xt_len: int = 0,
) -> float:
    """Analytic forward FLOPs (multiply+add = 2 FLOPs) for one batch."""
    Ta = min(mel_frames // 2, dims.n_audio_ctx)
    D, L = dims.n_audio_state, dims.n_audio_layer
    Dt, Lt, T = dims.n_text_state, dims.n_text_layer, text_len

    conv = 2 * mel_frames * 3 * dims.n_mels * D + 2 * Ta * 3 * D * D
    enc_layer = (
        4 * 2 * Ta * D * D  # qkv + out projections
        + 2 * 2 * Ta * Ta * D  # attention matmuls
        + 2 * 2 * Ta * D * 4 * D  # mlp
    )
    encoder = conv + L * enc_layer

    dec_layer = (
        4 * 2 * T * Dt * Dt
        + 2 * 2 * T * T * Dt
        + 2 * 2 * Dt * Dt * Ta  # cross k/v (amortized per fwd)
        + 2 * 2 * T * Dt * Dt  # cross q/out
        + 2 * 2 * T * Ta * Dt  # cross attention matmuls
        + 2 * 2 * T * Dt * 4 * Dt
        + n_xt_streams * (
            4 * 2 * T * Dt * Dt + 2 * 2 * T * xt_len * Dt + 2 * 2 * T * Dt * 4 * Dt
        )
    )
    logits = 2 * T * Dt * dims.n_vocab
    decoder = Lt * dec_layer + logits
    return float(batch * (encoder + decoder))


def mfu(flops_per_sec: float) -> float:
    """Model FLOPs utilization against the H100's dense bf16 peak."""
    return flops_per_sec / H100_BF16_PEAK_FLOPS


def device_span_ms(fn, calls: int, flush=None, spin_cycles: int = 1_000_000) -> float:
    """Device time per call of ``fn`` (ms, the median over ``calls``
    calls): from a CUDA event recorded just before the call to one just
    after it, on the current stream.

    Before each call a read (sum) of ``flush`` runs, when given: a tensor
    larger than the 50 MB L2, so that the call finds its inputs in device
    memory (without it L2 stays warm). Then the device spins for
    ``spin_cycles`` clock cycles (~0.5 ms at 1M), long enough for the host
    to enqueue the whole call first; so the time is what the device takes
    to run the call's kernels one after another, gaps between them
    included, and none of the host's time. No profiler, so no record is
    dropped or told apart by name."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(calls)]
    for start, end in marks:
        if flush is not None:
            flush.sum()
        torch.cuda._sleep(spin_cycles)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in marks)
