"""The DTW wavefront and the decode-MLP kernel of this checkout against another
checkout's, on one card, in turns.

    python -m whisper_flamingo_tpu_torch.tools.dtw_mlp_ab --other DIR
        [--calls 100]

DIR is the root of another checkout of this repository (for example an
unpacked ``git archive`` of an earlier commit). Each side runs in its own
process, from its own root, so each side's wrappers (``ops/dtw.dtw_trace``,
``ops/decode_mlp._launch``) and kernels (``csrc/dtw.cu``,
``csrc/decode_mlp.cu``, built at first use) are the ones timed. In the order
other, this, this, other, each process:

- ``dtw`` at the shapes of ``chip_smoke.py`` phase 5, (65, 1500) and
  (224, 1500) fp32 N(0, 1) (numpy seed 0): the trace's SHA-256 (the two
  checkouts must agree) and its equality with ``dtw_trace_plain``; the
  device time per call from ``torch.profiler`` with a 64 MB buffer read
  before each call (``flushed_us``: x comes from device memory) and without
  (``warm_us``); the host time per call (``host_us``);
- ``decode_mlp`` at phase 11's shapes: bf16 x, int8 and bf16 weights, d 768,
  f 3072, 8, 32 and 120 rows: within 1e-2 of the largest output of
  ``fused_mlp_plain``, the same bits twice, the output's SHA-256 (reported:
  whether the two checkouts give the same bits); the device time per call,
  flushed and warm, as the span from the call's first kernel's start to its
  last kernel's end; the host time per call.

Both sides time with this checkout's ``profiling.device_span_ms``: its
source goes into each side's script, so an older checkout is measured the
same way. It prints the card's name and power
limit, one JSON line per turn, and the mean of the two turns of each side.
It needs a card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

from whisper_flamingo_tpu_torch.profiling import device_span_ms

TURNS = ("other", "this", "this", "other")

# Run in each side's process, from that side's root, after the source of
# device_span_ms: only what every checkout since the decode-MLP
# kernel has (dtw_trace, dtw_trace_plain, decode_mlp._weights / _launch /
# fused_mlp_plain, whisper._quantize_linear).
_MEASURE = r"""
import hashlib, json, sys, time
import numpy as np
import torch
from whisper_flamingo_tpu_torch.ops import decode_mlp, dtw
from whisper_flamingo_tpu_torch.models.whisper import _quantize_linear

calls = int(sys.argv[1])
torch.backends.cuda.matmul.allow_tf32 = False
flush = torch.zeros(32 << 20, dtype=torch.bfloat16, device="cuda")  # 64 MB > the L2


def span_us(fn, cold):
    return device_span_ms(fn, calls, flush if cold else None) * 1e3


def host_us(fn):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    out = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return out


result = {}
rng = np.random.default_rng(0)
for n, m in ((65, 1500), (224, 1500)):
    x = torch.from_numpy(rng.standard_normal((n, m)).astype(np.float32)).cuda()
    trace = dtw.dtw_trace(x)
    if not torch.equal(trace, dtw.dtw_trace_plain(x)):
        raise SystemExit(f"dtw_mlp_ab: the dtw trace at {(n, m)} differs from the plain version's")
    fn = lambda: dtw.dtw_trace(x)
    result[f"dtw_{n}x{m}"] = {
        "sha256": hashlib.sha256(trace.cpu().numpy().tobytes()).hexdigest(),
        "flushed_us": span_us(fn, True), "warm_us": span_us(fn, False), "host_us": host_us(fn)}

gen = torch.Generator(device="cuda").manual_seed(0)
for weights in ("int8", "bfloat16"):
    mlp = torch.nn.Sequential(torch.nn.Linear(768, 3072), torch.nn.GELU(),
                              torch.nn.Linear(3072, 768)).cuda().requires_grad_(False)
    for lin, fan_in in ((mlp[0], 768), (mlp[2], 3072)):
        lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen, device="cuda") * fan_in ** -0.5)
        lin.bias.copy_(torch.randn(lin.bias.shape, generator=gen, device="cuda") * 0.1)
    mlp = mlp.bfloat16()
    if weights == "int8":
        _quantize_linear(mlp[0])
        _quantize_linear(mlp[2])
    w1, w2, s1, s2 = decode_mlp._weights(mlp)
    b1, b2 = mlp[0].bias, mlp[2].bias
    for rows in (8, 32, 120):
        x = torch.randn(rows, 768, generator=gen, device="cuda").bfloat16()
        fn = lambda: decode_mlp._launch(x, w1, b1, w2, b2, s1, s2)
        out, again = fn(), fn()
        ref = decode_mlp.fused_mlp_plain(x, w1, b1, w2, b2, s1, s2)
        err = (out.float() - ref.float()).abs().max().item()
        scale = max(ref.float().abs().max().item(), 1.0)
        if not (err <= 1e-2 * scale and torch.equal(out, again)):
            raise SystemExit(f"dtw_mlp_ab: decode_mlp {weights} rows {rows}: |err| {err}, "
                             f"same bits {torch.equal(out, again)}")
        result[f"mlp_{weights}_{rows}"] = {
            "sha256": hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes()).hexdigest(),
            "max_abs_err": err, "flushed_us": span_us(fn, True), "warm_us": span_us(fn, False),
            "host_us": host_us(fn)}
print(json.dumps(result))
"""


def side_script() -> str:
    """What each side's process runs: this checkout's ``device_span_ms``,
    then ``_MEASURE``."""
    return inspect.getsource(device_span_ms) + _MEASURE


def run_side(root: str, calls: int) -> dict:
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", side_script(), str(calls)], cwd=root, env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"dtw_mlp_ab: the side at {root} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--calls", type=int, default=100)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("dtw_mlp_ab: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    roots = {"this": here, "other": os.path.abspath(args.other)}
    turns = {"this": [], "other": []}
    for side in TURNS:
        got = run_side(roots[side], args.calls)
        turns[side].append(got)
        print(json.dumps({"turn": side, **got}), flush=True)
    same = {k: turns["this"][0][k]["sha256"] == turns["other"][0][k]["sha256"]
            for k in turns["this"][0]}
    print(json.dumps({"dtw_traces_equal_across_checkouts":
                      {k: v for k, v in same.items() if k.startswith("dtw_")},
                      "mlp_outputs_equal_across_checkouts":
                      {k: v for k, v in same.items() if k.startswith("mlp_")}}), flush=True)
    for side, got in turns.items():
        mean = {case: {key: sum(g[case][key] for g in got) / len(got)
                       for key in got[0][case] if key != "sha256"} for case in got[0]}
        print(json.dumps({"side": side, "mean_of_turns": mean}), flush=True)
    if not all(v for k, v in same.items() if k.startswith("dtw_")):
        raise SystemExit("dtw_mlp_ab: the dtw traces differ between the checkouts")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
