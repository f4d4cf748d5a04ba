#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It needs nothing but the repository and one card, and exits non-zero
(printing no result) when there is no card or no port beside it. Phases,
each printing one JSON line:

1. device: the card's name and power limit (nvidia-smi); the CUDA kernels
   are built from ``whisper_flamingo_tpu_torch/csrc`` (one nvcc per source,
   all at once), with ptxas's registers and spills of the flash64 kernels.
2. flash64: the encoder-attention kernel against its plain version on the
   card at (B*H, T, 64) = (96, 1500, 64) in bf16 and fp32, a ragged
   T = 300, and in bf16 every edge of the ``wgmma`` kernel's 128-row tiles
   (T = 1, 63, 64, 65, 127, 128, 129); at T = 1500 its time beside the
   bound (with TF/s and the bound's share of the time), the plain
   version's and SDPA's, and the host time per call.
3. decode_attn: the decode-attention kernel against its plain version at
   T_max 448, D 768, 12 heads: 8 rows with a scalar and with per-row
   offsets, 120 rows (beam 15 x batch 8) with a scalar offset; output and
   both updated caches. Times beside the bound.
4. end to end through the port's entry points (``load_model("small")``,
   random weights from a seed; ``log_mel_spectrogram`` on the card;
   ``DecodingTask``) on the bench protocol: batch 8 of 30 s synthetic
   audio, English, no timestamps, 64 tokens with EOT suppressed. fp32
   greedy through the kernels must give the tokens of the plain path; bf16
   greedy and beam 15, and the small Whisper-Flamingo (one stream, gates
   at 1) in beam 15, give RTF and tokens/s. The kernels' launch counters
   are set to 0 before each run and must show 12 encoder launches and 12
   per incremental decoder step.

5. dtw: the DTW wavefront kernel against its plain version, traces
   bit-equal, at (65, 1500) and (224, 1500) fp32 N(0, 1), the tie-rich
   integer (33, 70), (1, 1500) and (448, 1500); the path equals the host
   DP (``dtw_np``) at (65, 1500). Its time beside the byte bound, the
   chain of N+M dependent diagonals and the plain version's time (no
   PyTorch call computes this DP).
6. longform: the port's ``transcribe`` on ``load_model("small")`` in bf16
   over 90 s of the bench's synthetic audio, English, greedy at
   temperature 0, 64 tokens per window with EOT suppressed, word
   timestamps on. Every segment with text has words, word times are
   ordered and inside the audio, the DTW kernel ran once per window with
   text and flash64 12 times per decode plus 12 per alignment pass. Then
   fp32 through the kernels and through the plain versions: the same
   segments and words. Wall seconds, audio seconds per wall second, the
   window count and the share of wall time in ``add_word_timestamps``;
   every writer's file.

7. flash64_bwd: the forward's lse and the backward kernels
   (``csrc/flash64_bwd.cu``: the D row pass, dK/dV, dQ) against their plain
   versions at (8, 12, T, 64) for T in 1500, 400, 100 and 1 and the tile
   edges 63, 64, 65, 127, 128, 129, bf16 and fp32; two launches give the
   same bits. At T = 1500: the forward with lse and the backward beside
   their bounds (with TF/s and the bound's share), the plain versions'
   times, and SDPA's forward and backward through autograd (a yardstick
   the port never calls).
8. train_small_b8: the JAX package's train bench protocol
   (``bench.py:105-138``): ``small``, batch 8 of (80, 3000) mel, 128
   tokens, AdamW lr 1e-5 over 1000 steps, bf16 compute over fp32 masters,
   the encoder trainable, ``remat="full"`` and ``"none"``: ms per step
   (median of 10 after warm-up), tokens/s, MFU (3 x ``model_flops`` over
   989 TFLOP/s), peak memory, flash64 launches per step, and a falling loss.
9. train_fp32_kernel_vs_plain: one fp32 step of ``small`` at full depth
   through the kernels and through the plain flash64 functions: the losses
   agree to 1e-5 relative and every gradient to 1e-4 of its largest
   magnitude.
10. recipe_whisper_ft: ``recipes.whisper_ft`` in-process on
    ``configs/smoke/ft.yaml`` with ``model_name=small``, batch 8, 16
    synthetic utterances, bf16, validation every 2 steps: a run stopped at
    step 4 of 6 (``max_steps``) and resumed equals an uninterrupted 6-step
    run (train losses to 1e-6 relative); the metrics JSONL, top-k pruning
    and ``last`` are present. The flash64 counters are read around the
    first run, the training path's main run.
11. decode_mlp: the streaming decode-MLP kernel (``csrc/decode_mlp.cu``)
    against its plain version at d 768, f 3072 and 8, 32 and 120 rows, in
    bf16, fp32 and int8 weights with bf16 x; two launches give the same
    bits. Times beside the byte bound, the plain version's, and the
    unfused ``mlp_block`` chain's (the yardstick; not called on this
    route).
12. serving_int8: ``small`` b8 on the bench protocol: greedy int8 with
    ``decode_mlp.ENABLED`` off and on, beam 15 int8kv, the Whisper-Flamingo
    beam 15 int8kv; RTF and tokens/s, with the launch counters at 0 before
    each run: 12 flash64 launches, 12 decode-attention launches per
    incremental step (0 under int8kv), 12 decode-MLP launches per decoder
    pass with the switch on. Then fp32 int8 greedy with the switch on
    through the kernels and through the plain versions: the same tokens;
    and the share of positions where bf16 int8 greedy agrees with bf16
    greedy (reported).
13. continuous_batching: ``ContinuousBatcher`` on ``small``, int8, 8 slots,
    chunk 16: 32 requests of the synthetic audio with token budgets drawn
    uniformly from 16-96 (numpy seed 0), through ``poll`` and through
    ``run_queued(sort_admission=True)``: wall time, tokens/s, audio s per
    wall s, the device idle share of one profiled ``run_queued``. Gate: in
    fp32 every request equals its per-utterance ``decode`` (a difference
    prints its position and the logit margin there).
14. speculative: ``small`` verifier, ``tiny`` draft (seeds 0 and 1),
    greedy b8, draft length 4: RTF, the share of drafts accepted, verifier
    passes per token; gate: fp32 tokens equal plain greedy.
15. flash64_fwd_probe: the probe entry point
    (``tools.flash64_fwd_probe.run``) on bf16 (8, 12, 1500, 64) with the
    probe's scales: shipped, augv and csbound timed in turns. Each variant
    kernel (``csrc/flash64_fwd_probe.cu``) against its plain version and
    against the shipped kernel (1e-2 of the output scale); two launches
    give the same bits. Times beside the bound, the plain versions' and
    SDPA's.
16. mma_pair: the pair kernel (``csrc/mma_pair.cu``) against
    ``pair_chain_plain`` at iters 1, 2, 3 for d 64, 128, 256 (one bf16 ulp
    of the output scale; bit-equal reruns); the first iteration after which
    the probe's operands are all zero; then the probe entry point
    (``tools.packed_probe2.run``) at its four (d, n) points at 512 rows and
    at 33,792 (two blocks per SM): ms, raw and useful TF/s, the two ratios;
    at d 64 and 512 rows the bound, the plain version and the chain of
    ``torch.addmm`` calls beside it.

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. TF32 is off for matmuls and cuDNN
throughout. Any failed phase raises, and the script exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense; fp32 without TF32

BATCH, SAMPLE_LEN, BEAM = 8, 64, 15
T_MAX, D_MODEL, N_HEAD = 448, 768, 12
LONGFORM_SECONDS, MAX_WINDOWS = 90, 40
CB_REQUESTS = 32
EDGE_T = (63, 64, 65, 127, 128, 129)  # with T = 1: the edges of 64-row boxes, 128-row blocks


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, dtype_name: str):
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def rate(row, flops, ms_key="ms", prefix=""):
    """TF/s on the bound's operations and the bound's share of the time."""
    row[prefix + "tflops"] = flops / row[ms_key] / 1e9
    row[prefix + "bound_share"] = row[prefix + "bound_ms"] / row[ms_key]


def host_ms(torch, fn, calls: int = 20) -> float:
    """Host time per call: the wrapper and the launch, enqueued back to back."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    out = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return out


def ptxas_report(log: str):
    """{mangled kernel name: {registers, spill_stores, spill_loads}} from
    nvcc -Xptxas -v."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)  # the mangled name
        if m:
            name = m.group(1)
            out[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def phase_flash64(torch, flash64, gen):
    import torch.nn.functional as F

    rows, results = [], {}
    cases = [("bfloat16", 1500, 1e-2), ("float32", 1500, 1e-5),
             ("bfloat16", 300, 1e-2), ("float32", 300, 1e-5), ("bfloat16", 1, 1e-2)]
    cases += [("bfloat16", t, 1e-2) for t in EDGE_T]
    for dtype_name, t, tol in cases:
        dtype = getattr(torch, dtype_name)
        q, k, v = (torch.randn(BATCH, N_HEAD, t, 64, generator=gen, device="cuda") for _ in range(3))
        q, k = q * 64 ** -0.25, k * 64 ** -0.25
        q, k, v = (x.to(dtype) for x in (q, k, v))
        out = flash64.flash64_attention(q, k, v)
        torch.cuda.synchronize()
        ref = flash64.flash64_attention_plain(q, k, v)
        err = max_err(out, ref)
        if not (torch.isfinite(out).all().item() and err <= tol):
            raise AssertionError(f"flash64 {dtype_name} t={t}: max |err| {err} > {tol}")
        row = {"dtype": dtype_name, "shape": [BATCH * N_HEAD, t, 64], "max_abs_err": err, "tol": tol}
        if t == 1500:
            bh = BATCH * N_HEAD
            row["ms"] = time_ms(lambda: flash64.flash64_attention(q, k, v), 10)
            row["plain_ms"] = time_ms(lambda: flash64.flash64_attention_plain(q, k, v), 3, 1)
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0), 10
            )
            flops = 4.0 * bh * t * t * 64
            row["bound_ms"], row["bound_by"] = bound(
                flops, 4.0 * bh * t * 64 * q.element_size(), dtype_name
            )
            rate(row, flops)
            row["host_ms"] = host_ms(torch, lambda: flash64.flash64_attention(q, k, v))
            results[dtype_name] = row
        rows.append(row)
    emit({"phase": "flash64", "cases": rows})
    return results["bfloat16"]


def phase_decode_attn(torch, decode_attn, gen):
    import torch.nn.functional as F

    dh = D_MODEL // N_HEAD
    rows, results = [], {}
    off = SAMPLE_LEN + 2  # the last step of the bench protocol (3 initial tokens)
    for dtype_name, tol in (("bfloat16", 2e-2), ("float32", 1e-5)):
        dtype = getattr(torch, dtype_name)
        for b, mode in ((8, "scalar"), (8, "per_row"), (BATCH * BEAM, "scalar")):
            q, kn, vn = (torch.randn(b, 1, D_MODEL, generator=gen, device="cuda").to(dtype)
                         for _ in range(3))
            kc = (torch.randn(b, T_MAX, D_MODEL, generator=gen, device="cuda") * 0.5).to(dtype)
            vc = (torch.randn(b, T_MAX, D_MODEL, generator=gen, device="cuda") * 0.5).to(dtype)
            if mode == "scalar":
                offset = torch.tensor([off], dtype=torch.int32, device="cuda")
            else:
                offset = torch.randint(0, T_MAX, (b,), generator=gen, device="cuda",
                                       dtype=torch.int32)
            kc2, vc2 = kc.clone(), vc.clone()
            out, _, _ = decode_attn.fused_step(q, kn, vn, kc, vc, offset, N_HEAD)
            torch.cuda.synchronize()
            ref = decode_attn.fused_step_plain(q, kn, vn, kc2, vc2, offset, N_HEAD)
            err = max_err(out, ref)
            cache_err = max(max_err(kc, kc2), max_err(vc, vc2))
            if not (torch.isfinite(out).all().item() and err <= tol and cache_err == 0.0):
                raise AssertionError(
                    f"decode_attn {dtype_name} b={b} {mode}: max |err| {err} (tol {tol}), "
                    f"cache max |err| {cache_err} (must be 0)"
                )
            row = {"dtype": dtype_name, "rows": b, "offset": mode, "max_abs_err": err,
                   "cache_max_abs_err": cache_err, "tol": tol}
            if mode == "scalar":
                row["ms"] = time_ms(
                    lambda: decode_attn.fused_step(q, kn, vn, kc, vc, offset, N_HEAD), 200, 10
                )
                row["plain_ms"] = time_ms(
                    lambda: decode_attn.fused_step_plain(q, kn, vn, kc2, vc2, offset, N_HEAD), 20
                )
                # SDPA over the same cached prefix (the attention only: it
                # does not write the cache)
                qh = q.view(b, 1, N_HEAD, dh).transpose(1, 2)
                kh = kc[:, : off + 1].view(b, off + 1, N_HEAD, dh).transpose(1, 2)
                vh = vc[:, : off + 1].view(b, off + 1, N_HEAD, dh).transpose(1, 2)
                row["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=dh ** -0.25), 200, 10
                )
                item = q.element_size()
                # the K/V prefix read once, the new token's q/k/v read, the
                # output and the new K/V row written
                nbytes = item * b * D_MODEL * (2 * off + 3 + 3)
                row["bound_ms"], row["bound_by"] = bound(4.0 * b * D_MODEL * (off + 1), nbytes,
                                                         dtype_name)
                if dtype_name == "bfloat16":
                    results[b] = row
            rows.append(row)
    emit({"phase": "decode_attn", "cases": rows})
    return results[8], results[BATCH * BEAM]


def phase_dtw(torch, dtw):
    import numpy as np

    rng = np.random.default_rng(0)
    rows, timed = [], {}
    for shape, ints in (((65, 1500), False), ((224, 1500), False), ((33, 70), True),
                        ((1, 1500), False), ((448, 1500), False)):
        x = rng.integers(0, 2, shape) if ints else rng.standard_normal(shape)
        x = torch.from_numpy(x.astype(np.float32)).cuda()
        trace = dtw.dtw_trace(x)
        torch.cuda.synchronize()
        ref = dtw.dtw_trace_plain(x)
        err = max_err(trace, ref)
        if not torch.equal(trace, ref):
            raise AssertionError(f"dtw {shape}: the trace differs from the plain version's")
        row = {"shape": list(shape), "tie_rich": ints, "max_abs_err": err, "tol": 0}
        if shape == (65, 1500):
            path = dtw.backtrace_np(trace.cpu().numpy())
            if not np.array_equal(path, dtw.dtw_np(x.cpu().numpy())):
                raise AssertionError("dtw (65, 1500): the path differs from dtw_np's")
            row["path_equals_dtw_np"] = True
        if shape in ((65, 1500), (224, 1500)):
            n, m = shape
            row["ms"] = time_ms(lambda: dtw.dtw_trace(x), 50)
            row["plain_ms"] = time_ms(lambda: dtw.dtw_trace_plain(x), 2, 1)
            row["bound_ms"], row["bound_by"] = bound(0.0, 4.0 * n * m + (n + 1) * (m + 1),
                                                     "float32")
            row["chain_steps"] = n + m
            row["library_ms"] = None  # no PyTorch call computes this DP
            timed[shape] = row
        rows.append(row)
    emit({"phase": "dtw", "cases": rows})
    return timed[(65, 1500)]


def phase_longform(torch, wt, eot):
    """Long-form transcribe with word timestamps through the entry point."""
    import importlib

    import numpy as np

    from whisper_flamingo_tpu_torch.ops import decode_attn, decode_mlp, dtw, flash64
    from whisper_flamingo_tpu_torch.writers import get_writer

    tr = importlib.import_module("whisper_flamingo_tpu_torch.transcribe")
    audio = np.random.default_rng(0).standard_normal(16000 * LONGFORM_SECONDS)
    audio = audio.astype(np.float32) * 0.05
    model = wt.load_model("small", device="cuda", seed=0)
    n_layer = model.dims.n_audio_layer
    stats = {}
    decode, add_words = tr.decode, tr.add_word_timestamps

    def counted_decode(*args, **kwargs):
        stats["decodes"] += 1
        return decode(*args, **kwargs)

    def timed_add_words(**kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        add_words(**kwargs)
        torch.cuda.synchronize()
        stats["words_s"] += time.perf_counter() - t0
        stats["with_text"] += any(t < eot for s in kwargs["segments"] for t in s["tokens"])

    def run(fp16):
        model.dtype = torch.bfloat16 if fp16 else torch.float32
        stats.update(decodes=0, words_s=0.0, with_text=0)
        for k in (flash64.flash64_forward, decode_attn.fused_step, dtw.dtw_trace):
            k.launches = 0
        tr.decode, tr.add_word_timestamps = counted_decode, timed_add_words
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = wt.transcribe(
                model, audio, language="en", temperature=0.0, word_timestamps=True,
                sample_len=SAMPLE_LEN, suppress_tokens=f"-1,{eot}", fp16=fp16,
            )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            tr.decode, tr.add_word_timestamps = decode, add_words
        launches = {"flash64": flash64.flash64_forward.launches,
                    "decode_attn": decode_attn.fused_step.launches,
                    "dtw": dtw.dtw_trace.launches}
        return result, wall, dict(stats), launches

    result, wall, st, launches = run(True)
    windows = st["decodes"]
    segs = result["segments"]
    words = [w for s in segs for w in s["words"]]
    if not (3 <= windows <= MAX_WINDOWS):
        raise AssertionError(f"longform: {windows} windows, expected 3 to {MAX_WINDOWS}")
    if any(s["text"].strip() and not s["words"] for s in segs):
        raise AssertionError("longform: a segment with text has no words")
    starts = [w["start"] for w in words]
    if not words or starts != sorted(starts) or any(
        not (0.0 <= w["start"] <= w["end"] <= LONGFORM_SECONDS) for w in words
    ):
        raise AssertionError(f"longform: word times out of order or outside the audio: {words}")
    if launches["dtw"] != st["with_text"]:
        raise AssertionError(f"longform: {launches['dtw']} DTW launches, {st['with_text']} "
                             "windows with text")
    if launches["flash64"] != n_layer * (windows + st["with_text"]):
        raise AssertionError(f"longform: {launches['flash64']} flash64 launches, expected "
                             f"{n_layer} x ({windows} decodes + {st['with_text']} alignments)")
    with tempfile.TemporaryDirectory() as out_dir:
        get_writer("all", out_dir)(result, "longform.wav", {"max_line_width": 42,
                                                            "max_line_count": 2})
        files = sorted(os.listdir(out_dir))
        sizes = {f: os.path.getsize(os.path.join(out_dir, f)) for f in files}
        with open(os.path.join(out_dir, "longform.json")) as f:
            if len(json.load(f)["segments"]) != len(segs):
                raise AssertionError("longform: the JSON writer lost segments")
    want = [f"longform.{e}" for e in ("json", "srt", "tsv", "txt", "vtt")]
    if files != want or not all(sizes.values()):
        raise AssertionError(f"longform: writer files {sizes}, expected {want}")
    out = {"phase": "longform_bf16_small", "audio_s": LONGFORM_SECONDS, "wall_s": wall,
           "audio_s_per_wall_s": LONGFORM_SECONDS / wall, "windows": windows,
           "windows_with_text": st["with_text"], "segments": len(segs), "words": len(words),
           "word_timestamps_s": st["words_s"], "word_timestamps_share": st["words_s"] / wall,
           "launches": launches, "writer_bytes": sizes}
    emit(out)

    # fp32 through the kernels, then through the plain versions
    kernel_res, _, _, _ = run(False)
    restore = _plain_kernels(decode_attn, decode_mlp, flash64)
    saved_dtw, dtw.dtw_trace = dtw.dtw_trace, dtw.dtw_trace_plain
    try:
        plain_res, _, _, _ = run(False)
    finally:
        restore()
        dtw.dtw_trace = saved_dtw

    def key(res):
        return [(s["seek"], s["start"], s["end"], s["text"], s["tokens"],
                 [(w["word"], w["start"], w["end"]) for w in s["words"]]) for s in res["segments"]]

    prob_diff = max([abs(a["probability"] - b["probability"])
                     for sa, sb in zip(kernel_res["segments"], plain_res["segments"])
                     for a, b in zip(sa["words"], sb["words"])] or [0.0])
    same = key(kernel_res) == key(plain_res)
    emit({"phase": "longform_fp32_kernel_vs_plain", "segments_and_words_equal": same,
          "segments": len(kernel_res["segments"]), "word_probability_max_diff": prob_diff})
    if not same or prob_diff > 1e-4:
        raise AssertionError("longform fp32: the kernels' segments or words differ from the "
                             f"plain path's (word probability max diff {prob_diff})")
    return out


def phase_flash64_bwd(torch, flash64, gen):
    """The lse forward and the backward kernels against their plain versions."""
    import torch.nn.functional as F

    rows, timed = [], {}
    rel = {"bfloat16": 1e-2, "float32": 1e-4}
    fwd_tol = {"bfloat16": 2e-2, "float32": 1e-5}
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for t in (1500, 400, 100, 1) + EDGE_T:
            q, k = ((torch.randn(BATCH, N_HEAD, t, 64, generator=gen, device="cuda")
                     * 64 ** -0.25).to(dtype) for _ in range(2))
            v, do = (torch.randn(BATCH, N_HEAD, t, 64, generator=gen, device="cuda").to(dtype)
                     for _ in range(2))
            o, lse = flash64.flash64_forward(q, k, v, with_lse=True)
            grads = flash64.flash64_backward(q, k, v, o, lse, do)
            again = flash64.flash64_backward(q, k, v, o, lse, do)
            torch.cuda.synchronize()
            o_ref, lse_ref = flash64.flash64_forward_plain(q, k, v, with_lse=True)
            ref = flash64.flash64_backward_plain(q, k, v, o, lse, do)
            o_err, lse_err = max_err(o, o_ref), max_err(lse, lse_ref)
            errs = {n: max_err(a, r) for n, a, r in zip(("dq", "dk", "dv"), grads, ref)}
            scales = {n: max(r.float().abs().max().item(), 1.0)
                      for n, r in zip(("dq", "dk", "dv"), ref)}
            same_bits = all(torch.equal(a, b) for a, b in zip(grads, again))
            ok = (o_err <= fwd_tol[dtype_name] and lse_err <= 1e-4 and same_bits
                  and all(errs[n] <= rel[dtype_name] * scales[n] for n in errs))
            row = {"dtype": dtype_name, "shape": [BATCH, N_HEAD, t, 64], "o_max_abs_err": o_err,
                   "lse_max_abs_err": lse_err, "max_abs_err": errs, "scale": scales,
                   "rel_tol": rel[dtype_name], "same_bits_twice": same_bits}
            if not ok:
                raise AssertionError(f"flash64_bwd {dtype_name} t={t}: {row}")
            if t == 1500:
                bh, item = BATCH * N_HEAD, q.element_size()
                row["fwd_lse_ms"] = time_ms(lambda: flash64.flash64_forward(q, k, v, with_lse=True), 10)
                row["fwd_lse_plain_ms"] = time_ms(
                    lambda: flash64.flash64_forward_plain(q, k, v, with_lse=True), 3, 1)
                row["fwd_lse_bound_ms"], row["fwd_lse_bound_by"] = bound(
                    4.0 * bh * t * t * 64, bh * t * (4 * 64 * item + 4), dtype_name)
                rate(row, 4.0 * bh * t * t * 64, "fwd_lse_ms", "fwd_lse_")
                row["bwd_ms"] = time_ms(lambda: flash64.flash64_backward(q, k, v, o, lse, do), 10)
                row["bwd_plain_ms"] = time_ms(
                    lambda: flash64.flash64_backward_plain(q, k, v, o, lse, do), 3, 1)
                # 5 products of 2*T*T*64; q, k, v, o, dO and the lse read once,
                # dQ, dK, dV written once
                row["bwd_bound_ms"], row["bwd_bound_by"] = bound(
                    5 * 2.0 * bh * t * t * 64, bh * t * (8 * 64 * item + 4), dtype_name)
                rate(row, 5 * 2.0 * bh * t * t * 64, "bwd_ms", "bwd_")
                qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
                row["sdpa_fwd_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=1.0), 10)
                out = F.scaled_dot_product_attention(qs, ks, vs, scale=1.0)
                row["sdpa_bwd_ms"] = time_ms(
                    lambda: torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True), 10)

                def sdpa_fwd_bwd():
                    o2 = F.scaled_dot_product_attention(qs, ks, vs, scale=1.0)
                    torch.autograd.grad(o2, (qs, ks, vs), do)

                row["sdpa_fwd_bwd_ms"] = time_ms(sdpa_fwd_bwd, 10)
                del out
                timed[dtype_name] = row
            rows.append(row)
    emit({"phase": "flash64_bwd", "cases": rows})
    return timed["bfloat16"]


def _train_batch(np, b):
    """The bench protocol's batch: numpy seed 0, (b, 80, 3000) mel, (b, 128)
    tokens and labels in [0, 1000)."""
    rng = np.random.default_rng(0)
    return {
        "input_ids": rng.standard_normal((b, 80, 3000)).astype(np.float32),
        "dec_input_ids": rng.integers(0, 1000, (b, 128)).astype(np.int32),
        "labels": rng.integers(0, 1000, (b, 128)).astype(np.int32),
    }


def _profile_step(torch, step, state, batch, wall_ms):
    """One train step under torch.profiler: the device-busy time (the sum of
    the kernels' device times), its share of the unprofiled step, and the
    kernels that take the most device time, grouped by name."""
    from whisper_flamingo_tpu_torch.profiling import trace

    with tempfile.TemporaryDirectory() as log_dir:
        with trace(log_dir) as prof:
            step(state, batch)
            torch.cuda.synchronize()
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    kernels = sorted(
        (e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0),
        key=dev_us, reverse=True,
    )
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    return {"device_busy_ms": busy_ms, "idle_share_vs_unprofiled_step": 1.0 - busy_ms / wall_ms,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:90], "ms": dev_us(e) / 1e3, "count": e.count}
                            for e in kernels[:14]]}


def phase_train_small(torch, wt, flash64):
    """The train bench protocol on small b8, with and without remat."""
    import numpy as np

    from whisper_flamingo_tpu_torch.profiling import mfu, model_flops
    from whisper_flamingo_tpu_torch.training.optim import whisper_optimizer
    from whisper_flamingo_tpu_torch.training.steps import TrainState, make_ce_train_step

    batch = _train_batch(np, BATCH)
    out = {}
    for remat in ("full", "none"):
        model = wt.load_model("small", device="cuda", seed=0)
        dims = model.dims
        tx, _ = whisper_optimizer(model, 1e-5, total_steps=1000)
        step = make_ce_train_step(dims, dtype=torch.bfloat16, remat=remat)
        state = TrainState.create(model, tx)
        losses = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):  # warm-up
            state, m = step(state, batch)
            losses.append(m["loss"].item())
        flash64.flash64_forward.lse_launches = flash64.flash64_backward.launches = 0
        state, m = step(state, batch)
        torch.cuda.synchronize()
        launches = {"fwd_lse": flash64.flash64_forward.lse_launches,
                    "bwd": flash64.flash64_backward.launches}
        losses.append(m["loss"].item())
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(m["loss"].item())
        n_layer = dims.n_audio_layer
        want = {"fwd_lse": n_layer * (2 if remat == "full" else 1), "bwd": n_layer}
        if launches != want or not (losses[-1] < losses[0]) or not np.all(np.isfinite(losses)):
            raise AssertionError(f"train remat={remat}: launches {launches} (expected {want}), "
                                 f"losses {losses}")
        ms = float(np.median(times)) * 1e3
        flops = 3 * model_flops(dims, BATCH, mel_frames=3000, text_len=128)
        out[remat] = {"ms_per_step": ms, "step_ms_all": [t * 1e3 for t in times],
                      "tokens_per_s": BATCH * 128 / (ms / 1e3), "mfu": mfu(flops / (ms / 1e3)),
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "flash64_launches_per_step": launches, "first_loss": losses[0],
                      "last_loss": losses[-1], "steps": len(losses)}
        if remat == "full":
            out[remat]["profile"] = _profile_step(torch, step, state, batch, ms)
        emit({"phase": f"train_small_b{BATCH}_remat_{remat}", **out[remat]})
        del model, tx, state, step
        torch.cuda.empty_cache()
    return out


def phase_train_fp32_kernel_vs_plain(torch, wt, flash64):
    """One fp32 step of small through the kernels, then through the plain
    flash64 functions: the same loss and gradients."""
    import numpy as np

    from whisper_flamingo_tpu_torch.models.whisper import decoder_apply, encoder_apply
    from whisper_flamingo_tpu_torch.training.optim import whisper_optimizer
    from whisper_flamingo_tpu_torch.training.steps import ce_loss, to_device

    model = wt.load_model("small", device="cuda", seed=0)
    whisper_optimizer(model, 1e-5, total_steps=1000)  # marks every parameter trainable
    b = to_device(_train_batch(np, 2), model.device)

    def loss_and_grads():
        feats = encoder_apply(model, model.dims, b["input_ids"], dtype=torch.float32)
        logits, _ = decoder_apply(model, model.dims, b["dec_input_ids"], feats,
                                  dtype=torch.float32)
        loss = ce_loss(logits, b["labels"])
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
        return loss.item(), grads

    flash64.flash64_forward.lse_launches = flash64.flash64_backward.launches = 0
    loss_k, grads_k = loss_and_grads()
    launches = (flash64.flash64_forward.lse_launches, flash64.flash64_backward.launches)
    saved = flash64.flash64_forward, flash64.flash64_backward
    flash64.flash64_forward = flash64.flash64_forward_plain
    flash64.flash64_backward = flash64.flash64_backward_plain
    try:
        loss_p, grads_p = loss_and_grads()
    finally:
        flash64.flash64_forward, flash64.flash64_backward = saved
    worst = max(
        ((n, max_err(grads_k[n], g) / max(g.abs().max().item(), 1e-30)) for n, g in grads_p.items()),
        key=lambda x: x[1],
    )
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    row = {"phase": "train_fp32_kernel_vs_plain", "loss_kernels": loss_k, "loss_plain": loss_p,
           "loss_rel_diff": loss_rel, "worst_grad": worst[0], "worst_grad_rel_err": worst[1],
           "n_grads": len(grads_p), "kernel_launches": launches}
    emit(row)
    n_layer = model.dims.n_audio_layer
    if loss_rel > 1e-5 or worst[1] > 1e-4 or launches != (n_layer, n_layer):
        raise AssertionError(f"train fp32: kernels vs plain {row}")
    del model, grads_k, grads_p
    torch.cuda.empty_cache()
    return row


def phase_recipe(torch, flash64):
    """The port's whisper_ft recipe: train, validate, checkpoint, resume."""
    from whisper_flamingo_tpu_torch.recipes import whisper_ft

    with tempfile.TemporaryDirectory() as tmp:
        def args(name, *extra):
            return [os.path.join(ROOT, "configs", "smoke", "ft.yaml"), "model_name=small",
                    "batch_size=8", "synthetic_n=16", "validate_every_n_batches=2",
                    "precision=16-mixed", "num_train_steps=6", "log_every=1", "save_top_k=1",
                    f"train_id={name}", f"log_output_dir={tmp}/logs",
                    f"check_output_dir={tmp}/ckpt", *extra]

        def records(name):
            with open(os.path.join(tmp, "logs", f"{name}.metrics.jsonl")) as f:
                return [json.loads(line) for line in f]

        for k in (flash64.flash64_forward, flash64.flash64_backward):
            k.launches = 0
        flash64.flash64_forward.lse_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = whisper_ft.main(args("a", "max_steps=4"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fwd": flash64.flash64_forward.launches,
                    "fwd_lse": flash64.flash64_forward.lse_launches,
                    "bwd": flash64.flash64_backward.launches}
        n_layer = state.model.dims.n_audio_layer
        if launches["bwd"] != 4 * n_layer or launches["fwd_lse"] != 8 * n_layer:
            raise AssertionError(f"recipe: flash64 launches {launches}, expected 4 steps x "
                                 f"{n_layer} backward and x {2 * n_layer} lse forward")
        recs = records("a")
        ckpt = sorted(os.listdir(os.path.join(tmp, "ckpt", "a")))
        if (state.step != 4 or [r["step"] for r in recs if "loss" in r] != [1, 2, 3, 4]
                or not any("val/wer" in r for r in recs)
                or ckpt != ["last.meta.json", "last.pt", "step-00000004.pt"]
                and ckpt != ["last.meta.json", "last.pt", "step-00000002.pt"]):
            raise AssertionError(f"recipe: step {state.step}, records {recs}, checkpoints {ckpt}")
        del state
        resumed = whisper_ft.main(args("a", "resume_training=True"))
        del resumed
        straight = whisper_ft.main(args("b"))
        del straight
        torch.cuda.empty_cache()
        la = {r["step"]: r["loss"] for r in records("a") if "loss" in r}
        lb = {r["step"]: r["loss"] for r in records("b") if "loss" in r}
        va = [r["val/loss"] for r in records("a") if r.get("phase") == "final"][-1]
        vb = [r["val/loss"] for r in records("b") if r.get("phase") == "final"][-1]
        diffs = [abs(la[s] - lb[s]) / abs(lb[s]) for s in (5, 6)] + [abs(va - vb) / abs(vb)]
        row = {"phase": "recipe_whisper_ft", "first_run_wall_s": wall, "launches": launches,
               "train_losses_interrupted": la, "train_losses_straight": lb,
               "final_val_loss": [va, vb], "resume_rel_diffs": diffs, "checkpoints": ckpt,
               "records": len(recs)}
        emit(row)
        if max(diffs) > 1e-6:
            raise AssertionError(f"recipe: the resumed run differs from the uninterrupted one {row}")
        return row


def phase_decode_mlp(torch, decode_mlp, gen):
    """The decode-MLP kernel against its plain version at small's widths."""
    from torch.profiler import ProfilerActivity, profile

    from whisper_flamingo_tpu_torch.models.whisper import _quantize_linear, mlp_block

    d, f = D_MODEL, 4 * D_MODEL
    rows_out, timed = [], {}
    for dtype_name, int8, tol in (("bfloat16", False, 1e-2), ("float32", False, 1e-5),
                                  ("bfloat16", True, 1e-2)):
        dtype = getattr(torch, dtype_name)
        mlp = torch.nn.Sequential(torch.nn.Linear(d, f), torch.nn.GELU(),
                                  torch.nn.Linear(f, d)).cuda().requires_grad_(False)
        for lin, fan_in in ((mlp[0], d), (mlp[2], f)):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen, device="cuda")
                             * fan_in ** -0.5)
            lin.bias.copy_(torch.randn(lin.bias.shape, generator=gen, device="cuda") * 0.1)
        mlp = mlp.to(dtype)
        if int8:
            _quantize_linear(mlp[0])
            _quantize_linear(mlp[2])
        w1, w2, s1, s2 = decode_mlp._weights(mlp)
        b1, b2 = mlp[0].bias, mlp[2].bias
        for rows in (8, 32, BATCH * BEAM):
            x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
            out = decode_mlp._launch(x, w1, b1, w2, b2, s1, s2)
            again = decode_mlp._launch(x, w1, b1, w2, b2, s1, s2)
            torch.cuda.synchronize()
            ref = decode_mlp.fused_mlp_plain(x, w1, b1, w2, b2, s1, s2)
            scale = max(ref.float().abs().max().item(), 1.0)
            err = max_err(out, ref)
            same = torch.equal(out, again)
            row = {"dtype": dtype_name, "weights": "int8" if int8 else dtype_name, "rows": rows,
                   "d": d, "f": f, "max_abs_err": err, "scale": scale, "rel_tol": tol,
                   "same_bits_twice": same}
            if not (torch.isfinite(out).all().item() and err <= tol * scale and same):
                raise AssertionError(f"decode_mlp: {row}")
            row["ms"] = time_ms(lambda: decode_mlp._launch(x, w1, b1, w2, b2, s1, s2), 200, 10)
            # back to back, the wrapper's host work can set the pace: the
            # device time of the two passes, from the profiler
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    decode_mlp._launch(x, w1, b1, w2, b2, s1, s2)
                torch.cuda.synchronize()
            row["device_ms"] = _device_busy(torch, prof)[0] / 20
            row["plain_ms"] = time_ms(
                lambda: decode_mlp.fused_mlp_plain(x, w1, b1, w2, b2, s1, s2), 50, 5)
            # the unfused chain (the route with ENABLED off); not called on this route
            row["library_ms"] = time_ms(lambda: mlp_block(mlp, x), 200, 10)
            row["library_call"] = ("mlp_block: linear, GELU, linear (the int8 dequant in each "
                                   "linear); the port does not call it on the kernel's route")
            item = x.element_size()
            w_bytes = w1.numel() * w1.element_size() + w2.numel() * w2.element_size()
            nbytes = w_bytes + (f + d) * item + 2 * rows * d * item + (4 * (f + d) if int8 else 0)
            row["bound_ms"], row["bound_by"] = bound(4.0 * rows * d * f, nbytes,
                                                     "float32" if dtype_name == "float32"
                                                     else "bfloat16")
            timed[(dtype_name, int8, rows)] = row
            rows_out.append(row)
        del mlp
    emit({"phase": "decode_mlp", "cases": rows_out})
    return timed[("bfloat16", True, BATCH)]


def _counted(torch, task, mel, n_steps, want, xt=None):
    """One run with the launch counters set to 0 first; ``want`` maps each
    kernel's name to its expected launches."""
    import numpy as np

    from whisper_flamingo_tpu_torch.ops import decode_attn, decode_mlp, flash64

    counters = {"flash64": flash64.flash64_forward, "decode_attn": decode_attn.fused_step,
                "decode_mlp": decode_mlp.fused_mlp}
    for c in counters.values():
        c.launches = 0
    results = task.run(mel, xt=xt)
    torch.cuda.synchronize()
    got = {k: c.launches for k, c in counters.items()}
    if got != want:
        raise AssertionError(f"kernel launches {got}, expected {want}")
    for r in results:
        if len(r.tokens) != n_steps + 1 or not np.isfinite(r.avg_logprob):
            raise AssertionError(f"bad result: {len(r.tokens)} tokens, {r.avg_logprob}")
    return results, got


def _timed(torch, task, mel, iters, xt=None):
    t0 = time.perf_counter()
    for _ in range(iters):
        results = task.run(mel, xt=xt)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    assert all(len(r.tokens) == SAMPLE_LEN for r in results)
    return {"rtf": iters * BATCH * 30.0 / elapsed, "tok_s": iters * BATCH * SAMPLE_LEN / elapsed,
            "s_per_batch": elapsed / iters, "iters": iters}


def _plain_kernels(decode_attn, decode_mlp, flash64):
    """Swap every kernel of the decode path for its plain version; returns
    the function that swaps them back."""
    saved = flash64.flash64_attention, decode_attn.fused_step, decode_mlp._launch

    def plain_step(q, k_raw, v_raw, k_cache, v_cache, offset, n_head):
        return decode_attn.fused_step_plain(q, k_raw, v_raw, k_cache, v_cache, offset,
                                            n_head), k_cache, v_cache

    flash64.flash64_attention = flash64.flash64_attention_plain
    decode_attn.fused_step = plain_step
    decode_mlp._launch = decode_mlp.fused_mlp_plain

    def restore():
        flash64.flash64_attention, decode_attn.fused_step, decode_mlp._launch = saved

    return restore


def phase_serving_int8(torch, wt, mel, options, rng):
    """small b8 in the int8 modes: greedy int8 with the decode-MLP kernel
    off and on, beam 15 int8kv, the Flamingo beam 15 int8kv; fp32 int8
    greedy through the kernels vs the plain versions; bf16 int8 vs bf16."""
    import numpy as np

    from whisper_flamingo_tpu_torch.ops import decode_attn, decode_mlp, flash64

    n_steps = SAMPLE_LEN - 1
    model = wt.load_model("small", device="cuda", seed=0)
    L, La = model.dims.n_text_layer, model.dims.n_audio_layer
    runs = {}
    try:
        for name, quantize, beam, enabled, iters in (
                ("greedy_int8", "int8", None, False, 3), ("greedy_int8_mlp", "int8", None, True, 3),
                ("beam15_int8kv", "int8kv", BEAM, False, 2)):
            decode_mlp.ENABLED = enabled
            task = wt.DecodingTask(model, options(True, beam, quantize=quantize))
            want = {"flash64": La, "decode_attn": 0 if quantize == "int8kv" else L * n_steps,
                    "decode_mlp": L * (n_steps + 1) if enabled else 0}
            _, got = _counted(torch, task, mel, n_steps, want)
            runs[name] = dict(_timed(torch, task, mel, iters), launches=got)
            emit({"phase": f"serving_{name}_small_b{BATCH}", **runs[name]})
        # fp32 int8 greedy with the decode-MLP kernel on: kernels vs plain
        decode_mlp.ENABLED = True
        kernel_res = wt.DecodingTask(model, options(False, None, quantize="int8")).run(mel)
        restore = _plain_kernels(decode_attn, decode_mlp, flash64)
        try:
            plain_res = wt.DecodingTask(model, options(False, None, quantize="int8")).run(mel)
        finally:
            restore()
    finally:
        decode_mlp.ENABLED = False
    same = [k.tokens == p.tokens for k, p in zip(kernel_res, plain_res)]
    lp_diff = max(abs(k.avg_logprob - p.avg_logprob) for k, p in zip(kernel_res, plain_res))
    # bf16 int8 against bf16 unquantized greedy: the share of equal positions
    int8_tok = [r.tokens for r in wt.DecodingTask(model, options(True, None, quantize="int8"))
                .run(mel)]
    bf16_tok = [r.tokens for r in wt.DecodingTask(model, options(True, None)).run(mel)]
    agree = float(np.mean([a == b for x, y in zip(int8_tok, bf16_tok) for a, b in zip(x, y)]))
    emit({"phase": "serving_fp32_int8_kernel_vs_plain", "tokens_equal": same,
          "avg_logprob_max_diff": lp_diff, "bf16_int8_vs_bf16_position_agreement": agree})
    if not all(same):
        raise AssertionError("fp32 int8 greedy: kernel tokens differ from plain tokens")
    del model, task
    torch.cuda.empty_cache()

    fmodel = wt.load_model("small", device="cuda", seed=0, add_gated_x_attn=1, num_langs=1,
                           bert_dim=768)
    with torch.no_grad():
        for blk in fmodel.decoder.blocks:
            blk.ff_gate.fill_(1.0)
            for sub in blk.gated_x_attn_layers:
                sub.attn_gate.fill_(1.0)
    xt = torch.from_numpy(rng.standard_normal((1, BATCH, 64, 768)).astype(np.float32)).cuda()
    task = wt.DecodingTask(fmodel, options(True, BEAM, quantize="int8kv"))
    _, got = _counted(torch, task, mel, n_steps,
                      {"flash64": La, "decode_attn": 0, "decode_mlp": 0}, xt)
    runs["flamingo_beam15_int8kv"] = dict(_timed(torch, task, mel, 2, xt), launches=got)
    emit({"phase": f"serving_flamingo_beam15_int8kv_small_b{BATCH}",
          **runs["flamingo_beam15_int8kv"]})
    del fmodel, task
    torch.cuda.empty_cache()
    return runs


def _device_busy(torch, prof):
    """The sum of the kernels' device times in a profile, ms."""
    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    return sum(dev_us(e) for e in events) / 1e3, sum(e.count for e in events)


def phase_continuous_batching(torch, wt, eot):
    """ContinuousBatcher on small, int8, 8 slots, chunk 16: 32 requests of
    the synthetic audio with budgets drawn from 16-96 tokens."""
    import numpy as np

    from torch.profiler import ProfilerActivity, profile

    from whisper_flamingo_tpu_torch.serving import ContinuousBatcher

    n_req, slots = CB_REQUESTS, 8
    waves = list(np.random.default_rng(0).standard_normal((n_req, 480_000))
                 .astype(np.float32) * 0.05)
    caps = [int(c) for c in np.random.default_rng(0).integers(16, 97, n_req)]
    model = wt.load_model("small", device="cuda", seed=0)

    def opts(fp16):
        return wt.DecodingOptions(language="en", without_timestamps=True, sample_len=max(caps),
                                  fp16=fp16, quantize="int8", suppress_tokens=f"-1,{eot}")

    cb = ContinuousBatcher(model, opts(True), slots=slots, chunk=16)
    cb.warmup()
    out = {"requests": n_req, "slots": slots, "chunk": 16, "tokens": sum(caps)}
    for name, pooled in (("poll", False), ("run_queued_lpt", True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cb.transcribe_segments(waves, max_tokens=caps, pooled=pooled)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if [len(r.tokens) for r in res] != caps:
            raise AssertionError(f"continuous batching {name}: lengths differ from the budgets")
        out[name] = {"wall_s": wall, "tok_s": sum(caps) / wall,
                     "audio_s_per_wall_s": n_req * 30.0 / wall}
    # device activity only, no trace file: the run makes ~180,000 launches
    for rid, w in enumerate(waves):
        cb.submit(w, caps[rid])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cb.run_queued(sort_admission=True)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, launches = _device_busy(torch, prof)
    unprofiled_ms = out["run_queued_lpt"]["wall_s"] * 1e3
    out["profile_run_queued"] = {
        "wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms, "kernel_launches": launches,
        "idle_share_vs_unprofiled_run": 1.0 - busy_ms / unprofiled_ms,
        "idle_share_profiled": 1.0 - busy_ms / wall_ms,
    }
    emit({"phase": f"continuous_batching_int8_small_{n_req}req", **out})

    # fp32 gate: every request equals its own per-utterance fp32 decode
    t_gate = time.perf_counter()
    cb32 = ContinuousBatcher(model, opts(False), slots=slots, chunk=16)
    got = cb32.transcribe_segments(waves, max_tokens=caps, pooled=True)
    task = wt.DecodingTask(model, opts(False))
    diffs = []
    for i, w in enumerate(waves):
        mel = wt.log_mel_spectrogram(w, device="cuda")[None]
        ref = task.run(mel)[0].tokens[:caps[i]]
        if got[i].tokens != ref:
            pos = next(p for p, (a, b) in enumerate(zip(got[i].tokens, ref)) if a != b)
            diffs.append({"request": i, "position": pos, "cb": got[i].tokens[pos],
                          "decode": ref[pos], "logit_margin": _logit_margin(
                              torch, task, mel, ref[:pos], ref[pos], got[i].tokens[pos])})
    emit({"phase": "continuous_batching_fp32_vs_decode", "requests": n_req,
          "requests_equal": n_req - len(diffs), "first_differences": diffs,
          "gate_s": time.perf_counter() - t_gate})
    if diffs:
        raise AssertionError(f"continuous batching fp32: {len(diffs)} requests differ from "
                             f"their per-utterance decode: {diffs}")
    del model, cb, cb32
    torch.cuda.empty_cache()
    return out


def _logit_margin(torch, task, mel, prefix, tok_a, tok_b):
    """The fp32 logit gap between two candidate tokens after ``prefix``,
    teacher-forced through the task's (int8) decode weights."""
    from whisper_flamingo_tpu_torch.models.whisper import decoder_apply, encoder_apply

    model = task.model
    toks = torch.tensor([list(task.initial_tokens) + list(prefix)], device="cuda")
    feats = encoder_apply(model, model.dims, mel)
    with torch.no_grad():
        logits, _ = decoder_apply(task.params, model.dims, toks, feats)
    last = logits[0, -1]
    return abs(last[tok_a].item() - last[tok_b].item())


def phase_speculative(torch, wt, mel, options):
    """small verifier, tiny draft (seeds 0 and 1), greedy b8, draft_len 4."""
    from whisper_flamingo_tpu_torch.speculative import SpeculativeDecodingTask

    K = 4
    model = wt.load_model("small", device="cuda", seed=0)
    draft = wt.load_model("tiny", device="cuda", seed=1)
    task = SpeculativeDecodingTask(model, draft, options(True, None), draft_len=K)
    task.run(mel)  # warm-up
    out = _timed(torch, task, mel, 2)
    st = task.last_stats
    out.update(draft_len=K, stats=st,
               acceptance_rate=(st["accepted_tokens"] - st["row_rounds"]) / (K * st["row_rounds"]),
               verifier_passes_per_token=(st["rounds"] + 1) / SAMPLE_LEN)
    spec32 = [r.tokens for r in SpeculativeDecodingTask(model, draft, options(False, None),
                                                        draft_len=K).run(mel)]
    greedy32 = [r.tokens for r in wt.DecodingTask(model, options(False, None)).run(mel)]
    same = [a == b for a, b in zip(spec32, greedy32)]
    out["fp32_tokens_equal_greedy"] = same
    emit({"phase": f"speculative_small_tiny_b{BATCH}", **out})
    if not all(same):
        raise AssertionError("speculative fp32: tokens differ from plain greedy")
    del model, draft, task
    torch.cuda.empty_cache()
    return out


def phase_flash64_variants(torch, flash64):
    """The forward variants through the probe's entry point, then each
    kernel against its plain version and the shipped kernel."""
    import torch.nn.functional as F

    from whisper_flamingo_tpu_torch.ops import flash64_variants as fv
    from whisper_flamingo_tpu_torch.tools import flash64_fwd_probe as probe

    t = 1500
    q, k, v = probe.make_inputs(BATCH, N_HEAD, t, "cuda")
    kernels = {"augv": (fv.flash64_fwd_augv, fv.flash64_fwd_augv_plain),
               "csbound+augv": (fv.flash64_fwd_csbound, fv.flash64_fwd_csbound_plain)}
    for fn, _ in kernels.values():
        fn.launches = 0
    flash64.flash64_forward.launches = 0
    rows = {r["name"]: r for r in probe.run(q, k, v, iters=20)}
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, (fn, _) in kernels.items()}
    launches["shipped"] = flash64.flash64_forward.launches
    bh = BATCH * N_HEAD
    bound_ms, bound_by = bound(4.0 * bh * t * t * 64, 4.0 * bh * t * 64 * q.element_size(),
                               "bfloat16")
    sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0), 20)
    out = {"phase": "flash64_fwd_probe", "shape": [BATCH, N_HEAD, t, 64],
           "shipped_ms": rows["shipped"]["ms"], "shipped_ms_turns": rows["shipped"]["ms_turns"],
           "library_ms": sdpa_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "launches": launches, "variants": {}}
    for name, (fn, plain) in kernels.items():
        got = rows[name]["out"]
        again = fn(q, k, v)
        ref = plain(q, k, v)
        scale = max(ref.float().abs().max().item(), 1.0)
        row = {"max_abs_err": max_err(got, ref), "scale": scale, "rel_tol": 1e-2,
               "max_abs_delta_vs_shipped": rows[name]["max_abs_delta_vs_shipped"],
               "same_bits_twice": torch.equal(got, again), "ms": rows[name]["ms"],
               "ms_turns": rows[name]["ms_turns"],
               "plain_ms": time_ms(lambda: plain(q, k, v), 3, 1), "library_ms": sdpa_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "launches": launches[name]}
        out["variants"][name] = row
        if not (torch.isfinite(got).all().item() and row["same_bits_twice"]
                and row["max_abs_err"] <= 1e-2 * scale
                and row["max_abs_delta_vs_shipped"] <= 1e-2 * scale and launches[name] > 0):
            raise AssertionError(f"flash64_fwd_probe {name}: {row}")
    emit(out)
    return out["variants"]


def _addmm_chain(torch, w, v, u, iters):
    """The pair as cuBLAS computes it: per product one ``torch.addmm`` with
    alpha 0.01 and beta 0 (the scale in the fp32 epilogue, then bf16)."""
    zo = torch.zeros(w.shape[0], v.shape[1], dtype=w.dtype, device=w.device)
    zw = torch.zeros_like(w)
    for _ in range(iters):
        o = torch.addmm(zo, w, v, beta=0, alpha=0.01)
        w = torch.addmm(zw, o, u, beta=0, alpha=0.01)
    return w


def phase_mma_pair(torch):
    """The pair kernel against its plain version, the operands' decay, and
    the probe's rates at 512 rows and at a row count that fills the card."""
    from whisper_flamingo_tpu_torch.ops import mma_pair
    from whisper_flamingo_tpu_torch.tools import packed_probe2 as probe

    rel = 2.0 ** -7  # one bf16 ulp of the output scale: fp32 sums in another order
    checks = []
    for d in mma_pair.HEAD_WIDTHS:
        w, v, u = probe.make_operands(512, probe.TK, d, "cuda", seed=d)
        for iters in (1, 2, 3):
            got = mma_pair.pair_chain(w, v, u, iters)
            again = mma_pair.pair_chain(w, v, u, iters)
            ref = mma_pair.pair_chain_plain(w, v, u, iters)
            scale = ref.float().abs().max().item()
            row = {"d": d, "iters": iters, "max_abs_err": max_err(got, ref), "scale": scale,
                   "rel_tol": rel, "same_bits_twice": torch.equal(got, again)}
            checks.append(row)
            if not (scale > 0 and row["same_bits_twice"] and row["max_abs_err"] <= rel * scale):
                raise AssertionError(f"mma_pair: {row}")
    w, v, u = probe.make_operands(512, probe.TK, 64, "cuda", seed=0)
    zero = {"kernel": mma_pair.first_zero_iteration(w, v, u, 64, chain=mma_pair.pair_chain),
            "plain": mma_pair.first_zero_iteration(w, v, u, 64)}

    fill = 2 * 132 * mma_pair.ROW_TILE
    mma_pair.pair_chain.launches = 0
    rates = {}
    for rows in (512, fill):
        points, ratios = probe.run(rows, "cuda")
        for p in points:
            p["raw_share_of_989"] = p["raw_tflops"] / (PEAK_FLOPS["bfloat16"] / 1e12)
        rates[rows] = {"points": points, **ratios}
    torch.cuda.synchronize()
    launches = mma_pair.pair_chain.launches

    p64 = rates[512]["points"][0]
    iters, n = p64["iters"], p64["n"]
    w, v, u = probe.make_operands(512, n, 64, "cuda", seed=0)
    entry = {"max_abs_err": max(c["max_abs_err"] for c in checks if c["d"] == 64),
             "ms": p64["ms"], "rows": 512, "iters": iters,
             "plain_ms": time_ms(lambda: mma_pair.pair_chain_plain(w, v, u, iters), 1, 1),
             "library_ms": time_ms(lambda: _addmm_chain(torch, w, v, u, iters), 1, 1),
             "library_call": "2 x iters torch.addmm (alpha 0.01, beta 0): no single call",
             "launches": launches}
    entry["bound_ms"], entry["bound_by"] = bound(
        mma_pair.pair_flops(512, n, 64, iters), 2.0 * (2 * 512 * n + 2 * n * 64), "bfloat16")
    emit({"phase": "mma_pair", "checks": checks, "first_all_zero_iteration": zero,
          "note": "past the first all-zero iteration every operand is zero: the rates are "
                  "readings on zero operands", "rates": {str(r): x for r, x in rates.items()},
          "d64_rows512": entry})
    if zero["kernel"] is None or zero["plain"] is None:
        raise AssertionError(f"mma_pair: the operands did not decay to zero: {zero}")
    return entry


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    import whisper_flamingo_tpu_torch as wt
    from whisper_flamingo_tpu_torch.ops import cuda_build, decode_attn, decode_mlp, dtw, flash64
    from whisper_flamingo_tpu_torch.tokenizer import get_tokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- 1. device and build ---------------------------------------------------
    smi = smi_line()
    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    emit({"phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": time.perf_counter() - t0,
          "libraries": [os.path.relpath(p, ROOT) for p in libs],
          "ptxas": {n: ptxas_report(cuda_build.build_log(n))
                    for n in ("flash64_fwd", "flash64_bwd")}})
    gen = torch.Generator(device="cuda").manual_seed(0)

    # -- 2, 3. kernels against their plain versions ---------------------------
    fl = phase_flash64(torch, flash64, gen)
    da8, da120 = phase_decode_attn(torch, decode_attn, gen)

    # -- 4. end to end ----------------------------------------------------------
    eot = get_tokenizer(True, language="en", task="transcribe").eot
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((BATCH, 480_000)).astype(np.float32) * 0.05
    mel = wt.log_mel_spectrogram(audio, device="cuda")
    mel_cpu = wt.log_mel_spectrogram(audio, device="cpu")
    mel_err = max_err(mel.cpu(), mel_cpu)
    if tuple(mel.shape) != (BATCH, 80, 3000) or mel_err > 1e-4:
        raise AssertionError(f"log-mel on the card: shape {tuple(mel.shape)}, |err| {mel_err}")

    n_steps = SAMPLE_LEN - 1  # incremental steps after the prefill

    def options(fp16, beam, quantize=None):
        return wt.DecodingOptions(
            language="en", without_timestamps=True, sample_len=SAMPLE_LEN, fp16=fp16,
            beam_size=beam, suppress_tokens=f"-1,{eot}", quantize=quantize,
        )

    model = wt.load_model("small", device="cuda", seed=0)
    want = {"flash64": model.dims.n_audio_layer, "decode_attn": model.dims.n_text_layer * n_steps,
            "decode_mlp": 0}

    # fp32 greedy: through the kernels, then through the plain versions
    task = wt.DecodingTask(model, options(False, None))
    kernel_res, _ = _counted(torch, task, mel, n_steps, want)
    restore = _plain_kernels(decode_attn, decode_mlp, flash64)
    try:
        plain_res = wt.DecodingTask(model, options(False, None)).run(mel)
    finally:
        restore()
    same = [k.tokens == p.tokens for k, p in zip(kernel_res, plain_res)]
    lp_diff = max(abs(k.avg_logprob - p.avg_logprob) for k, p in zip(kernel_res, plain_res))
    emit({"phase": "fp32_greedy_kernel_vs_plain", "tokens_equal": same,
          "avg_logprob_max_diff": lp_diff, "mel_max_abs_err_vs_cpu": mel_err})
    if not all(same):
        raise AssertionError("fp32 greedy: kernel tokens differ from plain tokens")

    # bf16 greedy and beam 15
    runs = {}
    for name, beam, iters in (("greedy", None, 3), ("beam15", BEAM, 2)):
        task = wt.DecodingTask(model, options(True, beam))
        _, got = _counted(torch, task, mel, n_steps, want)
        runs[name] = dict(_timed(torch, task, mel, iters), launches=got)
        emit({"phase": f"bf16_{name}_small_b{BATCH}", **runs[name]})
    del model, task
    torch.cuda.empty_cache()

    # the small Whisper-Flamingo: one conditioning stream, gates opened to 1
    fmodel = wt.load_model("small", device="cuda", seed=0, add_gated_x_attn=1,
                           num_langs=1, bert_dim=768)
    with torch.no_grad():
        for blk in fmodel.decoder.blocks:
            blk.ff_gate.fill_(1.0)
            for sub in blk.gated_x_attn_layers:
                sub.attn_gate.fill_(1.0)
    xt = torch.from_numpy(rng.standard_normal((1, BATCH, 64, 768)).astype(np.float32)).cuda()
    task = wt.DecodingTask(fmodel, options(True, BEAM))
    _, got = _counted(torch, task, mel, n_steps, want, xt)
    runs["flamingo_beam15"] = dict(_timed(torch, task, mel, 2, xt), launches=got)
    emit({"phase": f"bf16_flamingo_beam15_small_b{BATCH}", **runs["flamingo_beam15"]})
    del fmodel, task
    torch.cuda.empty_cache()

    seconds = {"1-4": time.perf_counter() - t_start}

    def mark(name):
        seconds[name] = time.perf_counter() - t_start - sum(seconds.values())

    # -- 5. the DTW kernel; 6. long-form transcribe with word timestamps -------
    dw = phase_dtw(torch, dtw)
    longform = phase_longform(torch, wt, eot)
    mark("5-6")

    # -- 7.-10. training: the backward kernels, the train step, the recipe ----
    fb = phase_flash64_bwd(torch, flash64, gen)
    phase_train_small(torch, wt, flash64)
    phase_train_fp32_kernel_vs_plain(torch, wt, flash64)
    recipe = phase_recipe(torch, flash64)
    mark("7-10")

    # -- 11.-14. serving: the decode-MLP kernel, the int8 modes, continuous
    # batching, speculative decoding ---------------------------------------
    dm = phase_decode_mlp(torch, decode_mlp, gen)
    serving = phase_serving_int8(torch, wt, mel, options, rng)
    mark("11-12")
    phase_continuous_batching(torch, wt, eot)
    mark("13")
    phase_speculative(torch, wt, mel, options)
    mark("14")

    # -- 15., 16. the probes: the flash64 forward variants, the matmul pair ----
    fv = phase_flash64_variants(torch, flash64)
    mp = phase_mma_pair(torch)
    mark("15-16")

    def entry(name, source, replaces, launches, row):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    kernels = [
        entry("flash64_fwd", "whisper_flamingo_tpu_torch/csrc/flash64_fwd.cu",
              "whisper_flamingo_tpu/ops/flash64.py:75", runs["greedy"]["launches"]["flash64"], fl),
        entry("decode_attn", "whisper_flamingo_tpu_torch/csrc/decode_attn.cu",
              "whisper_flamingo_tpu/ops/decode_attn.py:153",
              runs["greedy"]["launches"]["decode_attn"], da8),
        entry("decode_attn_rows120", "whisper_flamingo_tpu_torch/csrc/decode_attn.cu",
              "whisper_flamingo_tpu/ops/decode_attn.py:211",
              runs["beam15"]["launches"]["decode_attn"], da120),
        entry("dtw", "whisper_flamingo_tpu_torch/csrc/dtw.cu",
              "whisper_flamingo_tpu/ops/dtw_pallas.py:48", longform["launches"]["dtw"], dw),
        entry("flash64_fwd_lse", "whisper_flamingo_tpu_torch/csrc/flash64_fwd.cu",
              "whisper_flamingo_tpu/ops/flash64.py:75", recipe["launches"]["fwd_lse"],
              {"max_abs_err": fb["lse_max_abs_err"], "ms": fb["fwd_lse_ms"],
               "plain_ms": fb["fwd_lse_plain_ms"], "bound_ms": fb["fwd_lse_bound_ms"],
               "bound_by": fb["fwd_lse_bound_by"], "library_ms": fb["sdpa_fwd_ms"]}),
        entry("flash64_bwd", "whisper_flamingo_tpu_torch/csrc/flash64_bwd.cu",
              "whisper_flamingo_tpu/ops/flash64.py:100", recipe["launches"]["bwd"],
              {"max_abs_err": max(fb["max_abs_err"].values()), "ms": fb["bwd_ms"],
               "plain_ms": fb["bwd_plain_ms"], "bound_ms": fb["bwd_bound_ms"],
               "bound_by": fb["bwd_bound_by"], "library_ms": fb["sdpa_bwd_ms"]}),
        entry("decode_mlp", "whisper_flamingo_tpu_torch/csrc/decode_mlp.cu",
              "whisper_flamingo_tpu/ops/decode_mlp.py:70",
              serving["greedy_int8_mlp"]["launches"]["decode_mlp"], dm),
        entry("flash64_fwd_augv", "whisper_flamingo_tpu_torch/csrc/flash64_fwd_probe.cu",
              "tools/flash64_fwd_probe.py:102", fv["augv"]["launches"], fv["augv"]),
        entry("flash64_fwd_csbound", "whisper_flamingo_tpu_torch/csrc/flash64_fwd_probe.cu",
              "tools/flash64_fwd_probe.py:102", fv["csbound+augv"]["launches"],
              fv["csbound+augv"]),
        entry("mma_pair", "whisper_flamingo_tpu_torch/csrc/mma_pair.cu",
              "tools/packed_probe2.py:53", mp["launches"], mp),
    ]
    emit({"phase": "summary", "total_s": time.perf_counter() - t_start, "phase_s": seconds})
    print(smi_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
