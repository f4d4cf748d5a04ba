"""The tensor-core rate of the attention matmul pair at head widths 64, 128
and 256, and of the head-pair packed layout.

    python -m whisper_flamingo_tpu_torch.tools.packed_probe2 [--device cpu]
        [--rows 512] [--iters N]

The port of ``tools/packed_probe2.py``. The kernel (``ops/mma_pair.py``,
``csrc/mma_pair.cu``) loops the pair o = bf16(0.01 (w @ v)),
w = bf16(0.01 (o @ u)) over w (rows, n) with v (n, d) and u (d, n), at the
JAX probe's four points: d 64, 128 and 256 at n 1536, and the packed pair
(d 128, n 3072, half of its work useful). It prints, as the JAX probe does,
the ms per launch, the raw and useful TF/s, the d64 / d128 rate ratio and
the packed useful rate over d64's (on a full card at d >= 128 both
ratios read the kernel's exchange of o's partial sums across its cluster
rather than the tensor cores); then the first iteration after which w is
all zero (the probe's operands decay about 10^3-fold per iteration, so a
long run is a rate on zero operands).

``--rows`` is the number of rows of w (the JAX probe's 512, its q tile; a
multiple of 64 on the card). ``--iters`` is d64's iteration count (the
other points take the JAX probe's proportions: 1/2, 1/4, 1/4); without it,
each point's count is sized so that one launch takes about 20 ms. Launches
are timed with CUDA events (one warm-up, the median of three). On the card
it then prints each point's launch plan (``ops/mma_pair.plan``: the
cluster size C, the rows per CTA, the shared memory of a CTA and how many
clusters the card holds at once) and its µs per iteration. ``--device
cpu`` runs the plain version at a few iterations with the host clock: a
check of the program, not of a device.
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..ops import mma_pair

TK = 1536  # the kv length of the JAX probe (1500 padded)
TARGET_MS = 20.0  # one launch, when the iterations are sized
POINTS = (  # name, d, n, share of the work that is useful, JAX's iters (relative)
    ("pair d=64 (whisper head)", 64, TK, 1.0, 1.0),
    ("pair d=128 (full lane)", 128, TK, 1.0, 0.5),
    ("pair d=256", 256, TK, 1.0, 0.25),
    ("packed pair (2 heads blk)", 128, 2 * TK, 0.5, 0.25),
)


def make_operands(rows: int, n: int, d: int, device: str, seed: int = 0, steady: bool = False):
    """bf16 operands from a numpy seed. The JAX probe's scales: w = N(0, 1)
    (rows, n), v = 0.1 N(0, 1) (n, d), u = 0.1 N(0, 1) (d, n), under which w
    is all zero after about a dozen iterations. ``steady``: the same w, and
    v = 100 Q, u = 100 R Q^T with Q (n, d) orthonormal columns and R (d, d)
    orthogonal (QR of N(0, 1) matrices), so that o = bf16(0.01 w v) keeps
    its scale (each iteration turns it by R) and w its scale after the
    first iteration (sqrt(d / n) of the input's): the products run on
    non-zero data at any iteration count."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((rows, n), dtype=np.float32)
    if steady:
        q = np.linalg.qr(rng.standard_normal((n, d)))[0]
        r = np.linalg.qr(rng.standard_normal((d, d)))[0]
        v, u = 100.0 * q, 100.0 * r @ q.T
    else:
        v = rng.standard_normal((n, d), dtype=np.float32) * 0.1
        u = rng.standard_normal((d, n), dtype=np.float32) * 0.1
    return tuple(torch.from_numpy(np.asarray(x, np.float32)).to(device=device, dtype=torch.bfloat16)
                 for x in (w, v, u))


def launch_ms(w, v, u, iters: int, repeats: int = 3) -> float:
    """The median ms of ``repeats`` launches (after one warm-up): CUDA
    events on the card, the host clock on the CPU."""
    mma_pair.pair_chain(w, v, u, iters)
    times = []
    for _ in range(repeats):
        if w.device.type == "cpu":
            t0 = time.perf_counter()
            mma_pair.pair_chain(w, v, u, iters)
            times.append((time.perf_counter() - t0) * 1e3)
            continue
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        mma_pair.pair_chain(w, v, u, iters)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sized_iters(w, v, u, probe_iters: int = 64) -> int:
    """The iteration count at which one launch takes about TARGET_MS."""
    per_iter = launch_ms(w, v, u, probe_iters, repeats=1) / probe_iters
    return max(probe_iters, int(round(TARGET_MS / per_iter)))


def bench(name: str, d: int, n: int, rows: int, device: str, iters: Optional[int],
          useful_frac: float = 1.0, steady: bool = False) -> Dict:
    """One point: its ms per launch, µs per iteration and raw / useful TF/s;
    on the card also its launch plan."""
    w, v, u = make_operands(rows, n, d, device, steady=steady)
    if iters is None:
        iters = sized_iters(w, v, u)
    ms = launch_ms(w, v, u, iters)
    flops = mma_pair.pair_flops(rows, n, d, iters)
    raw = flops / (ms / 1e3) / 1e12
    out = {"name": name, "d": d, "n": n, "rows": rows, "iters": iters, "ms": ms,
           "us_per_iter": ms * 1e3 / iters, "raw_tflops": raw, "useful_tflops": useful_frac * raw}
    if device == "cuda":
        p = mma_pair.plan(rows, n, d)
        out["plan"] = {**p._asdict(),
                       "max_active_clusters": mma_pair.max_active_clusters(rows, n, d)}
    return out


def run(rows: int, device: str, iters: Optional[int] = None):
    """The four points (``iters`` is d64's; None sizes each point's);
    returns their rows and the two ratios."""
    out = []
    for name, d, n, frac, rel in POINTS:
        it = None if iters is None else max(1, int(iters * rel))
        out.append(bench(name, d, n, rows, device, it, frac))
    r64, r128, _, rp = (r["raw_tflops"] for r in out)
    return out, {"d64_over_d128": r64 / r128, "packed_useful_over_d64": 0.5 * rp / r64}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rows", type=int)
    ap.add_argument("--iters", type=int, help="d64's iterations (default: sized to ~20 ms)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("packed_probe2: no CUDA device (pass --device cpu for the plain version)")
    rows = args.rows or (512 if args.device == "cuda" else 128)
    iters = args.iters if args.iters or args.device == "cuda" else 3
    where = (torch.cuda.get_device_name(0) if args.device == "cuda"
             else "cpu (plain version, host clock)")
    print(f"device: {where}  rows: {rows}")
    points, ratios = run(rows, args.device, iters)
    for p in points:
        print(f"{p['name']:28s} d={p['d']:4d} n={p['n']:5d} iters={p['iters']:7d}: "
              f"{p['ms']:8.1f} ms  {p['raw_tflops']:6.1f} TF/s raw"
              f"  {p['useful_tflops']:6.1f} TF/s useful")
    print()
    print(f"d=64 rate / d=128 rate: {ratios['d64_over_d128']:.2f} "
          "(1.0 => no depth deficit; 0.5 => half-rate claim confirmed)")
    print(f"packed useful / d=64 raw: {ratios['packed_useful_over_d64']:.2f} "
          "(>1 => packing beats padding; ~0.5 => cycle-equivalent, refuted)")
    if args.device == "cuda":
        print("note: at d >= 128 on a full card both ratios are limited by this kernel's cluster "
              "exchange of o (1 / (n / C) bytes an operation), not by the tensor cores")
    for p in points:
        if "plan" in p:
            pl = p["plan"]
            print(f"{p['name']:28s} plan: C {pl['cluster']}, {pl['rows_per_cta']} rows a CTA, "
                  f"{pl['smem']} B shared, {pl['max_active_clusters']} clusters at once; "
                  f"{p['us_per_iter']:.3f} us an iteration")
    w, v, u = make_operands(rows, TK, 64, args.device)
    zero = mma_pair.first_zero_iteration(w, v, u, 64, chain=mma_pair.pair_chain)
    print(f"d=64: w is all zero after {zero} iterations: the rates above are on zero operands "
          "from there on" if zero else "d=64: w is not all zero after 64 iterations")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
