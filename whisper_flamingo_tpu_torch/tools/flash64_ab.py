"""The flash64 kernels of this checkout against those of another checkout,
on one card, timed in turns.

    python -m whisper_flamingo_tpu_torch.tools.flash64_ab --other DIR
        [--iters 20] [--steps 10]

DIR is the root of another checkout of this repository (for example an
unpacked ``git archive`` of an earlier commit). Its
``whisper_flamingo_tpu_torch/csrc/flash64_fwd.cu`` and ``flash64_bwd.cu``
are built as they stand (:func:`..ops.cuda_build.build_all`, named by the
hash of their sources), and this checkout's wrappers (:mod:`..ops.flash64`)
call either side's library through the same C entry points, so both sides
run the same Python. Each side is first held
to the plain versions at bf16 (8, 12, 1500, 64) (the tolerances of
``chip_smoke.py`` phase 7). Then, in the order other, this, this, other
(each side the mean of its two turns):

- ``fwd``, ``fwd_lse``, ``bwd``: ms per call at bf16 (8, 12, 1500, 64),
  CUDA events over ``--iters`` calls after a warm-up;
- ``train_step``: ms per step of ``small`` b8, bf16 compute, remat
  "full", on the train bench protocol of ``chip_smoke.py`` phase 8 (the
  median of ``--steps`` steps after two of warm-up).

It prints the card's name and power limit, then one JSON line per
measurement. It needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from ..ops import cuda_build, flash64

SHAPE = (8, 12, 1500)
TURNS = ("other", "this", "this", "other")


NAMES = ("flash64_fwd", "flash64_bwd")


class Sides:
    """Points the wrappers at this checkout's flash64 libraries or at those
    built from the other checkout's sources (one nvcc each, together)."""

    def __init__(self, other_root: str):
        csrc = os.path.join(other_root, "whisper_flamingo_tpu_torch", "csrc")
        paths = cuda_build.build_all(NAMES, csrc=csrc)
        self.libs = {"this": {n: cuda_build.load(n) for n in NAMES},
                     "other": {n: ctypes.CDLL(p) for n, p in zip(NAMES, paths)}}

    def use(self, side: str) -> None:
        # flash64's wrappers fetch their library through cuda_build.load
        cuda_build._LIBS.update(self.libs[side])

    def restore(self) -> None:
        self.use("this")


def time_ms(fn: Callable[[], object], iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(q, k, v, do) -> Dict[str, float]:
    """The current side against the plain versions (phase 7's gates)."""
    o, lse = flash64.flash64_forward(q, k, v, with_lse=True)
    grads = flash64.flash64_backward(q, k, v, o, lse, do)
    o_ref, lse_ref = flash64.flash64_forward_plain(q, k, v, with_lse=True)
    ref = flash64.flash64_backward_plain(q, k, v, o, lse, do)
    errs = {"o": (o.float() - o_ref.float()).abs().max().item(),
            "lse": (lse - lse_ref).abs().max().item()}
    ok = errs["o"] <= 2e-2 and errs["lse"] <= 1e-4
    for name, a, r in zip(("dq", "dk", "dv"), grads, ref):
        errs[name] = (a.float() - r.float()).abs().max().item()
        ok = ok and errs[name] <= 1e-2 * max(r.float().abs().max().item(), 1.0)
    if not ok:
        raise AssertionError(f"flash64_ab: a side disagrees with the plain versions: {errs}")
    return errs


def train_step_ms(sides: Sides, steps: int) -> Dict[str, List[float]]:
    """ms per train step (median of ``steps``) for each turn."""
    import whisper_flamingo_tpu_torch as wt
    from whisper_flamingo_tpu_torch.training.optim import whisper_optimizer
    from whisper_flamingo_tpu_torch.training.steps import TrainState, make_ce_train_step

    rng = np.random.default_rng(0)
    b = SHAPE[0]
    batch = {"input_ids": rng.standard_normal((b, 80, 3000)).astype(np.float32),
             "dec_input_ids": rng.integers(0, 1000, (b, 128)).astype(np.int32),
             "labels": rng.integers(0, 1000, (b, 128)).astype(np.int32)}
    model = wt.load_model("small", device="cuda", seed=0)
    tx, _ = whisper_optimizer(model, 1e-5, total_steps=1000)
    step = make_ce_train_step(model.dims, dtype=torch.bfloat16, remat="full")
    state = TrainState.create(model, tx)
    turns: Dict[str, List[float]] = {"this": [], "other": []}
    for side in TURNS:
        sides.use(side)
        for _ in range(2):
            state, _ = step(state, batch)
        times = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(m["loss"].item()):
            raise AssertionError(f"flash64_ab: non-finite loss on the {side} side")
        turns[side].append(float(np.median(times)))
    return turns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash64_ab: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    sides = Sides(args.other)
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, t = SHAPE
    q, k = ((torch.randn(b, h, t, 64, generator=gen, device="cuda") * 64 ** -0.25).bfloat16()
            for _ in range(2))
    v, do = (torch.randn(b, h, t, 64, generator=gen, device="cuda").bfloat16() for _ in range(2))
    try:
        for side in ("other", "this"):
            sides.use(side)
            print(json.dumps({"check": side, "max_abs_err": check(q, k, v, do)}), flush=True)
        o, lse = flash64.flash64_forward(q, k, v, with_lse=True)
        calls = {
            "fwd": lambda: flash64.flash64_forward(q, k, v),
            "fwd_lse": lambda: flash64.flash64_forward(q, k, v, with_lse=True),
            "bwd": lambda: flash64.flash64_backward(q, k, v, o, lse, do),
        }
        for what, fn in calls.items():
            turns: Dict[str, List[float]] = {"this": [], "other": []}
            for side in TURNS:
                sides.use(side)
                turns[side].append(time_ms(fn, args.iters))
            print(json.dumps({"what": what, "shape": [b, h, t, 64], "order": TURNS,
                              "other_ms": sum(turns["other"]) / 2,
                              "this_ms": sum(turns["this"]) / 2, "turns": turns}), flush=True)
        turns = train_step_ms(sides, args.steps)
        print(json.dumps({"what": "train_step", "model": "small", "batch": b, "remat": "full",
                          "order": TURNS, "other_ms": sum(turns["other"]) / 2,
                          "this_ms": sum(turns["this"]) / 2, "turns": turns}), flush=True)
    finally:
        sides.restore()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
