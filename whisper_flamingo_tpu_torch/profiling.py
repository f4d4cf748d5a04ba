"""Profiling and step-timing utilities.

Port of ``whisper_flamingo_tpu/profiling.py``:

- :class:`StepTimer`: rolling wall-clock and throughput stats for train or
  decode loops;
- :func:`trace`: a ``torch.profiler`` context (CPU and CUDA activities)
  that writes a Chrome trace into a directory;
- :func:`model_flops`: analytic FLOPs of one Whisper forward (encoder and
  teacher-forced decoder), the JAX package's count;
- :func:`mfu`: model FLOPs utilization against the H100's dense bf16 peak.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .models.dims import ModelDimensions

H100_BF16_PEAK_FLOPS = 989e12  # dense, SXM part at its 700 W limit


@dataclass
class StepTimer:
    """Rolling step timing; call ``tick(n_tokens=..., n_audio_sec=...)``.
    The caller synchronizes the device before a tick where it times device
    work."""

    window: int = 100
    _times: List[float] = field(default_factory=list)
    _tokens: List[int] = field(default_factory=list)
    _audio: List[float] = field(default_factory=list)
    _last: Optional[float] = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def tick(self, n_tokens: int = 0, n_audio_sec: float = 0.0) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            self._tokens.append(n_tokens)
            self._audio.append(n_audio_sec)
            if len(self._times) > self.window:
                self._times.pop(0)
                self._tokens.pop(0)
                self._audio.pop(0)
        self._last = now

    def stats(self) -> Dict[str, float]:
        if not self._times:
            return {}
        times = np.asarray(self._times)
        total = float(times.sum())
        out = {
            "step_time_mean": float(times.mean()),
            "step_time_p50": float(np.percentile(times, 50)),
            "step_time_p99": float(np.percentile(times, 99)),
        }
        if sum(self._tokens):
            out["tokens_per_sec"] = sum(self._tokens) / total
        if sum(self._audio):
            out["rtf"] = sum(self._audio) / total
        return out


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
