#!/usr/bin/env python3
"""Where the time of one decode goes, for the PyTorch port on one GPU.

    python3 tools/torch_decode_profile.py [--beam 15] [--quantize int8|int8kv]
                                          [--decode_mlp] [--pairs N]

Runs the port's ``DecodingTask`` on the bench protocol (``small``, bf16,
batch 8 of 30 s synthetic audio, English, no timestamps, 64 tokens with
EOT suppressed, random weights from seed 0): one warm-up run, one run timed with the host
clock, then one run under ``torch.profiler``. ``--quantize`` selects an
int8 serving mode and ``--decode_mlp`` sets ``ops.decode_mlp.ENABLED`` (the
streaming decode-MLP kernel). ``--pairs N`` compares the decode-MLP kernel
off and on in one process instead: N pairs of timed runs, alternating which
runs first, then one profiled run of each. Prints one JSON line per
variant: the wall time of the run(s), the device-busy time (the sum of the
kernels' device times: one stream, so they do not overlap) and the idle
share, the kernels and host-side operators that take the most time, and
the card's name and power limit. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import whisper_flamingo_tpu_torch as wt
    from whisper_flamingo_tpu_torch.ops import decode_mlp
    from whisper_flamingo_tpu_torch.tokenizer import get_tokenizer

    ap = argparse.ArgumentParser()
    ap.add_argument("--beam", type=int, default=None)
    ap.add_argument("--quantize", default=None, choices=(None, "int8", "int8kv"))
    ap.add_argument("--decode_mlp", action="store_true")
    ap.add_argument("--pairs", type=int, default=0)
    args = ap.parse_args()
    top = 12
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    batch, sample_len = 8, 64
    eot = get_tokenizer(True, language="en", task="transcribe").eot
    audio = np.random.default_rng(0).standard_normal((batch, 480_000)).astype(np.float32) * 0.05
    mel = wt.log_mel_spectrogram(audio, device="cuda")
    model = wt.load_model("small", device="cuda", seed=0)
    task = wt.DecodingTask(model, wt.DecodingOptions(
        language="en", without_timestamps=True, sample_len=sample_len, fp16=True,
        beam_size=args.beam, suppress_tokens=f"-1,{eot}", quantize=args.quantize,
    ))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()

    def timed_run(enabled: bool) -> float:
        decode_mlp.ENABLED = enabled
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        task.run(mel)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    variants = [False, True] if args.pairs else [args.decode_mlp]
    walls = {v: [] for v in variants}
    for v in variants:  # warm-up: builds the kernels and the decode weights
        timed_run(v)
    for i in range(max(args.pairs, 1)):
        for v in (variants if i % 2 == 0 else variants[::-1]):
            walls[v].append(timed_run(v))

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    for v in variants:
        decode_mlp.ENABLED = v
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            task.run(mel)
            torch.cuda.synchronize()
        events = prof.key_averages()
        # the kernels themselves (device-side events), not the operators that
        # launched them, so nothing is counted twice
        kernels = sorted(
            (e for e in events
             if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0),
            key=dev_us, reverse=True,
        )
        busy_us = sum(dev_us(e) for e in kernels)
        cpu_ops = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)
        wall_ms = statistics.median(walls[v]) * 1e3
        out = {
            "model": "small", "beam": args.beam, "dtype": "bfloat16",
            "quantize": args.quantize, "decode_mlp": v,
            "batch": batch, "sample_len": sample_len, "card": smi,
            "wall_ms_unprofiled": wall_ms,
            "wall_ms_runs": [w * 1e3 for w in walls[v]],
            "device_busy_ms_profiled": busy_us / 1e3,
            "idle_share_vs_unprofiled_wall": 1.0 - busy_us / 1e3 / wall_ms,
            "kernel_launches_profiled": int(sum(e.count for e in kernels)),
            "top_device": [
                {"name": e.key[:90], "ms": dev_us(e) / 1e3, "count": e.count}
                for e in kernels[:top]
            ],
            "top_host_ops": [
                {"name": e.key[:90], "self_cpu_ms": e.self_cpu_time_total / 1e3,
                 "count": e.count}
                for e in cpu_ops[:top]
            ],
        }
        print(json.dumps(out), flush=True)
    decode_mlp.ENABLED = False
    return 0


if __name__ == "__main__":
    sys.exit(main())
