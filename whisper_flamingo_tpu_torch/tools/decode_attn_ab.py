"""The decode-attention step of this checkout against another checkout's, on
one card, in turns.

    python -m whisper_flamingo_tpu_torch.tools.decode_attn_ab --other DIR
        [--calls 200]

DIR is the root of another checkout of this repository (for example an
unpacked ``git archive`` of an earlier commit). Each side runs in its own
process, from its own root, so each side's wrapper
(``ops/decode_attn.fused_step``) and kernel (``csrc/decode_attn.cu``, built
at first use into that checkout's ``build/``) are the ones timed. In the
order other, this, this, other, each process, at bf16, T_max 448, D 768,
12 heads, a scalar offset of 66 (the last step of the bench protocol),
for 8 and for 120 rows, and the offset passed in two forms (``tensor``: a
one-element device tensor, as the earlier decode loop passed it; ``int``:
a Python int, as the decode loop passes it now):

- checks the kernel against the plain version (output within 2e-2, caches
  bit-equal);
- ``host_us``: host time per call, ``--calls`` calls enqueued back to back
  (the wrapper and the launch);
- ``device_us``: the kernel's device time per launch from
  ``torch.profiler``, with a 64 MB buffer read before each launch so that
  the prefix comes from device memory and L2 holds clean lines, as in the
  decode loop (a layer's cache was last read a step earlier, the weights
  since); ``warm_device_us`` without it (the prefix in L2);
- the same three for SDPA over the same cached prefix (the attention only,
  without the cache write; a yardstick the port never calls).

It prints the card's name and power limit, one JSON line per turn, and the
mean of the two turns of each side. It needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

TURNS = ("other", "this", "this", "other")
ROWS = (8, 120)

# Run in each side's process, from that side's root: only the public
# ``fused_step`` / ``fused_step_plain`` of its ``ops.decode_attn``.
_MEASURE = r"""
import json, sys, time
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile
from whisper_flamingo_tpu_torch.ops import decode_attn

calls = int(sys.argv[1])
t_max, d, n_head, off = 448, 768, 12, 66
dh = d // n_head
gen = torch.Generator(device="cuda").manual_seed(0)


flush = torch.zeros(32 << 20, dtype=torch.bfloat16, device="cuda")  # 64 MB > the L2


def device_us(fn, name, cold):
    skip = set()
    if cold:  # what reading the flush buffer runs is left out
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flush.sum()
            torch.cuda.synchronize()
        skip = {e.key for e in prof.key_averages()}
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            if cold:
                flush.sum()
            fn()
        torch.cuda.synchronize()
    total, launches = 0.0, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key and e.key not in skip:
            total, launches = total + us, launches + e.count
    # per launch over the launches seen, times the launches per call (a
    # profile may drop a few records)
    return total / max(launches, 1) * max(1, round(launches / calls))


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
for rows in ROWS:
    q, kn, vn = (torch.randn(rows, 1, d, generator=gen, device="cuda").bfloat16()
                 for _ in range(3))
    kc, vc = ((torch.randn(rows, t_max, d, generator=gen, device="cuda") * 0.5).bfloat16()
              for _ in range(2))
    qh = q.view(rows, 1, n_head, dh).transpose(1, 2)
    kh = kc[:, : off + 1].view(rows, off + 1, n_head, dh).transpose(1, 2)
    vh = vc[:, : off + 1].view(rows, off + 1, n_head, dh).transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=dh ** -0.25)
    got = {"sdpa_host_us": host_us(sdpa), "sdpa_device_us": device_us(sdpa, "", True),
           "sdpa_warm_device_us": device_us(sdpa, "", False)}
    for form, offset in (("tensor", torch.tensor([off], dtype=torch.int32, device="cuda")),
                         ("int", off)):
        kc2, vc2 = kc.clone(), vc.clone()
        out = decode_attn.fused_step(q, kn, vn, kc, vc, offset, n_head)[0]
        ref = decode_attn.fused_step_plain(q, kn, vn, kc2, vc2, offset, n_head)
        err = (out.float() - ref.float()).abs().max().item()
        if not (err <= 2e-2 and torch.equal(kc, kc2) and torch.equal(vc, vc2)):
            raise SystemExit(f"decode_attn_ab: the kernel disagrees with the plain version ({err})")
        step = lambda: decode_attn.fused_step(q, kn, vn, kc, vc, offset, n_head)
        got.update({f"{form}_max_abs_err": err, f"{form}_host_us": host_us(step),
                    f"{form}_device_us": device_us(step, "decode_attn", True),
                    f"{form}_warm_device_us": device_us(step, "decode_attn", False)})
    result[rows] = got
print(json.dumps(result))
""".replace("ROWS", repr(ROWS))


def run_side(root: str, calls: int) -> dict:
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", _MEASURE, str(calls)], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"decode_attn_ab: the side at {root} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("decode_attn_ab: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    roots = {"this": here, "other": os.path.abspath(args.other)}
    turns = {"this": [], "other": []}
    for side in TURNS:
        got = run_side(roots[side], args.calls)
        turns[side].append(got)
        print(json.dumps({"turn": side, **got}), flush=True)
    for side, got in turns.items():
        mean = {rows: {key: sum(g[rows][key] for g in got) / len(got) for key in got[0][rows]}
                for rows in got[0]}
        print(json.dumps({"side": side, "mean_of_turns": mean}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
