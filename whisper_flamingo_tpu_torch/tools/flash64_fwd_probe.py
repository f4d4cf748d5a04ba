"""Three ways to form the softmax of the flash64 forward, timed side by side.

    python -m whisper_flamingo_tpu_torch.tools.flash64_fwd_probe [--device cpu]
        [--iters 20]

The port of ``tools/flash64_fwd_probe.py``. On the same bf16 q, k, v
((8, 12, 1500, 64) as in the JAX probe; q and k are 0.3 N(0, 1), already
scaled, v is N(0, 1); numpy seed 0) it runs

- ``shipped``: the encoder's forward (:func:`..ops.flash64.flash64_forward`,
  max, exp, row sum);
- ``augv``: the row sum from a ones column of V (``flash64_fwd_augv``);
- ``csbound+augv``: the Cauchy-Schwarz bound in place of the row max
  (``flash64_fwd_csbound``),

and prints, as the JAX probe does, the ms per call and the largest
difference from ``shipped`` of each. On the card (the default) the kernels
run and are timed with CUDA events over ``--iters`` calls after a warm-up,
in the order shipped, augv, csbound, csbound, augv, shipped (each time the
mean of its two turns). ``--device cpu`` runs the plain versions at
(1, 2, 300, 64), timed with the host clock: a check of the program, not of
a device.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from ..ops import flash64, flash64_variants

VARIANTS = ("shipped", "augv", "csbound+augv")
CUDA_SHAPE = (8, 12, 1500)  # the JAX probe's B, H, T
CPU_SHAPE = (1, 2, 300)


def variant(name: str) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    if name == "shipped":
        return lambda q, k, v: flash64.flash64_forward(q, k, v)
    if name == "augv":
        return flash64_variants.flash64_fwd_augv
    if name == "csbound+augv":
        return flash64_variants.flash64_fwd_csbound
    raise ValueError(name)


def make_inputs(batch: int, heads: int, t: int, device: str):
    """bf16 q, k = 0.3 N(0, 1) and v = N(0, 1), (batch, heads, t, 64), from
    numpy seed 0, as the JAX probe draws them (pre-scaled magnitudes)."""
    rng = np.random.default_rng(0)
    shape = (batch, heads, t, 64)
    q, k = (rng.standard_normal(shape, dtype=np.float32) * 0.3 for _ in range(2))
    v = rng.standard_normal(shape, dtype=np.float32)
    return tuple(torch.from_numpy(x).to(device=device, dtype=torch.bfloat16) for x in (q, k, v))


def time_ms(fn: Callable[[], object], iters: int, device: str, warmup: int = 2) -> float:
    """Mean ms per call: CUDA events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device == "cpu":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, iters: int) -> List[Dict]:
    """Each variant's output difference from ``shipped`` and its ms per
    call, timed in turns (A B C C B A)."""
    device = q.device.type
    outs = {name: variant(name)(q, k, v) for name in VARIANTS}
    ref = outs["shipped"].float()
    turns: Dict[str, List[float]] = {name: [] for name in VARIANTS}
    for name in VARIANTS + VARIANTS[::-1]:
        fn = variant(name)
        turns[name].append(time_ms(lambda: fn(q, k, v), iters, device))
    return [{"name": name, "ms": float(np.mean(turns[name])), "ms_turns": turns[name],
             "max_abs_delta_vs_shipped": (outs[name].float() - ref).abs().max().item(),
             "out": outs[name]} for name in VARIANTS]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--iters", type=int, default=20, help="timed calls per turn")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("flash64_fwd_probe: no CUDA device (pass --device cpu for the plain "
                         "versions)")
    b, h, t = CUDA_SHAPE if args.device == "cuda" else CPU_SHAPE
    q, k, v = make_inputs(b, h, t, args.device)
    where = (torch.cuda.get_device_name(0) if args.device == "cuda"
             else "cpu (plain versions, host clock)")
    print(f"device: {where}  q/k/v: ({b}, {h}, {t}, 64) bf16")
    for row in run(q, k, v, args.iters):
        print(f"{row['name']:14s}: {row['ms']:6.3f} ms/op   "
              f"max|delta vs shipped|={row['max_abs_delta_vs_shipped']:.2e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
