"""The matmul-pair kernel of this checkout against another checkout's, on one
card, in turns.

    python -m whisper_flamingo_tpu_torch.tools.mma_pair_ab --other DIR
        [--iters 300] [--fill_iters 40]

DIR is the root of another checkout of this repository (for example an
unpacked ``git archive`` of an earlier commit). Each side runs in its own
process, from its own root, so each side's wrapper (``ops/mma_pair.
pair_chain``, with its own launch choice) and kernel (``csrc/mma_pair.cu``,
built at first use) are the ones timed. In the order other, this, this,
other, each process runs the probe's four points (``tools/packed_probe2.
POINTS``: d 64, 128 and 256 at n 1536, d 128 at n 3072) on the probe's
operands (numpy seed 0) at 512 rows and at 33,792 (two 128-row blocks per
SM): first three iterations against ``pair_chain_plain`` (within 2^-7 of
the output scale), then one launch of ``--iters`` iterations at 512 rows
and ``--fill_iters`` at 33,792 (each point takes the probe's share of
them: 1, 1/2, 1/4, 1/4) timed between CUDA events, the mean of three
launches after one warm-up: ms, µs per iteration and raw TF/s.

Both sides run the same script (only what every checkout since the pair
kernel has: ``packed_probe2.POINTS`` and ``make_operands``, ``mma_pair.
pair_chain``, ``pair_chain_plain`` and ``pair_flops``). It prints the
card's name and power limit, one JSON line per turn, and the mean of the
two turns of each side. It needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

TURNS = ("other", "this", "this", "other")
FILL_ROWS = 2 * 132 * 128

# Run in each side's process, from that side's root.
_MEASURE = r"""
import json, sys
import torch
from whisper_flamingo_tpu_torch.ops import mma_pair
from whisper_flamingo_tpu_torch.tools import packed_probe2 as probe

iters, fill_iters, fill_rows = (int(x) for x in sys.argv[1:4])
torch.backends.cuda.matmul.allow_tf32 = False


def launch_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


result = {}
for rows, base in ((512, iters), (fill_rows, fill_iters)):
    for name, d, n, _, share in probe.POINTS:
        w, v, u = probe.make_operands(rows, n, d, "cuda")
        got = mma_pair.pair_chain(w, v, u, 3)
        ref = mma_pair.pair_chain_plain(w, v, u, 3)
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        if not (scale > 0 and err <= 2.0 ** -7 * scale):
            raise SystemExit(f"mma_pair_ab: d {d} n {n} rows {rows}: |err| {err}, scale {scale}")
        it = max(1, int(base * share))
        ms = launch_ms(lambda: mma_pair.pair_chain(w, v, u, it))
        result[f"d{d}_n{n}_rows{rows}"] = {
            "iters": it, "ms": ms, "us_per_iter": ms * 1e3 / it, "max_abs_err": err,
            "scale": scale, "raw_tflops": mma_pair.pair_flops(rows, n, d, it) / ms / 1e9}
print(json.dumps(result))
"""


def run_side(root: str, iters: int, fill_iters: int) -> dict:
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", _MEASURE, str(iters), str(fill_iters),
                           str(FILL_ROWS)], cwd=root, env=env, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"mma_pair_ab: the side at {root} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--iters", type=int, default=300, help="d64's iterations at 512 rows")
    ap.add_argument("--fill_iters", type=int, default=40, help="d64's iterations at 33,792 rows")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("mma_pair_ab: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    roots = {"this": here, "other": os.path.abspath(args.other)}
    turns = {"this": [], "other": []}
    for side in TURNS:
        got = run_side(roots[side], args.iters, args.fill_iters)
        turns[side].append(got)
        print(json.dumps({"turn": side, **got}), flush=True)
    mean = {side: {case: {key: sum(g[case][key] for g in got) / len(got) for key in got[0][case]}
                   for case in got[0]} for side, got in turns.items()}
    for side in turns:
        print(json.dumps({"side": side, "mean_of_turns": mean[side]}), flush=True)
    print(json.dumps({"other_ms_over_this_ms": {
        case: mean["other"][case]["ms"] / mean["this"][case]["ms"] for case in mean["this"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
