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
   T_max 448, D 768, 12 heads: 8 rows with a scalar offset (a Python int,
   as the decode loop passes it) and with per-row offsets (a device
   tensor), 120 rows (beam 15 x batch 8) with a scalar offset; output and
   both updated caches. Beside the bound, at offset 66: the kernel's and
   SDPA's device time per call from the profiler, with L2 flushed by a 64
   MB read before each call (the decode loop's case; the kernels line's
   ``ms`` and ``library_ms``) and warm; their back-to-back event times and
   host time per call; the plain version's time. Then the kernel read
   through a beam row table (``decode_attn.beam_rows``) at beam15's shape
   (120 rows, D 768, 12 heads, T_max 132) and the AV cell's (120 rows, D
   1280, 20 heads, T_max 68), and at 8 rows of each (the latency mode), bf16
   and fp32, offsets from 3 to T_max - 1, random ancestry tables: equal bit
   for bit to the kernel over the cache gathered by the table, within the
   tolerance of the plain version through the table; the identity table
   gives the kernel's bits without one; the table ignored (a planted fault)
   must fail that tolerance. At 120 rows in bf16 and the offset of a
   decode's mean position, the table's launch time beside the kernel's
   without one (profiler, L2 flushed and warm; line ``decode_attn_rows``).
3b. xattn_step: the cached cross-attention kernel (``csrc/xattn_step.cu``)
   against its plain version in bf16 at the AV beam step's audio slab (8
   slab rows x 20 heads x 15 beams over 1,500 keys) and gated slab (448
   keys, masked past 86-375), the small model's beam step (12 heads over
   1,500 audio and 128 text keys) and serving's step (16 rows of one query
   over 1,500 keys), held to ``XATTN_MAX_ERR`` and ``XATTN_RMS_REL``; two
   launches give the same bits; two planted faults (the 28-key last tile
   dropped, the gated mask ignored) must fail those limits. Its device
   time per
   call from the profiler with L2 flushed (the kernels line's ``ms``) and
   warm, the host time per call, beside the byte bound (K and V of the
   open keys read once), the plain version's device time and SDPA's over
   the same head-split operands (``library_ms``, a yardstick the port
   never calls).
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
   integer (33, 70), (1, 1500), (448, 1500) and the edges of a warp's 32
   rows and of the ring between warps, N in 31, 32, 33, 63, 64, 447; the
   path equals the host DP (``dtw_np``) at (65, 1500). Its time beside the
   byte bound and beside the chain floor: a one-warp microkernel's ns per
   dependent step (the shuffle, the cascade, the add) times the N+M
   diagonals; ns per diagonal, host time per call, the plain version's
   time (no PyTorch call computes this DP).
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
11. decode_mlp: the decode-MLP kernel (``csrc/decode_mlp.cu``) against
    its plain version at d 768, f 3072 and 8, 32 and 120 rows, in bf16,
    fp32 and int8 weights with bf16 x; two launches give the same bits.
    Device time per call between CUDA events, the host ahead of the device
    (``profiling.device_span_ms``), with L2 flushed by a 64 MB read before
    each call (the kernels line's ``ms``) and warm; beside it the byte
    bound, the host time per call, the plain version's time, and the
    unfused ``mlp_block`` chain's device time by the same measure (its
    kernels and the gaps between them, the int8 casts included), flushed
    and warm, and host time: the route with
    ``ENABLED`` off, never called on the kernel's route. No single PyTorch
    call computes the function, so ``library_ms`` is null; the host-paced
    back-to-back times of both are kept as ``back_to_back_ms``.
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
    kernel (``csrc/flash64_fwd_probe.cu``, on the shipped forward's frame)
    against its plain version and against the shipped kernel (1e-2 of the
    output scale); two launches give the same bits. Times beside the
    bound, the plain versions' and SDPA's; then each kernel alone in turns
    (csbound with its kmax computed beforehand; the kernels line takes
    these) and the kmax reduction's own time.
16. mma_pair: the pair kernel (``csrc/mma_pair.cu``: u and v resident in
    a cluster's shared memory, ``wgmma``, o reduced across the cluster in
    rank order) against ``pair_chain_plain`` at iters 1, 2, 3 for each of
    the probe's four (d, n) points at 512 and at 33,792 rows, each in the
    launch its wrapper plans (one bf16 ulp of the output scale; bit-equal
    reruns); the first iteration after which the probe's
    operands are all zero; then the probe entry point
    (``tools.packed_probe2.run``) at its four points at 512 rows and at
    33,792 (two 128-row blocks per SM): ms, µs per iteration, raw and
    useful TF/s, the two ratios, each point's plan (cluster size, rows per
    CTA, shared bytes, ``cudaOccupancyMaxActiveClusters``); at d 64 and
    512 rows the bound, the plain version, the chain of ``torch.addmm``
    calls and the same chain replayed from a CUDA graph beside it; at d 64
    on the filled card the rate on steady operands that do not decay,
    beside the rate on the probe's (zero) operands.

17. text_conditioner: the BERT conditioner at ``bert-base-multilingual-cased``'s
    published widths (vocab 119,547, hidden 768, 12 layers, 12 heads,
    intermediate 3,072, 512 positions; random weights from seed 0, fp32,
    the byte tokenizer in place of the WordPiece one, which is not in the
    repository) over 16 strings (b8 x 2 languages of the synthetic
    translations): its last hidden state on the card against the same
    module on the CPU within 1e-4 of the largest magnitude; ms per
    ``encode_multi`` and its host share (1 - device busy / wall). Then
    ``recipes.trans_asr`` in-process on ``configs/smoke/trans_asr.yaml``
    at the shape of ``configs/audio-text/at_en-cmn_small_bert.yaml``
    (``small``, one stream, bert_dim 768, b8 of 16 synthetic 30 s
    utterances, bf16, 4 steps, validation every 2) with that conditioner
    swapped in for ``build_conditioner``: every parameter outside the gated
    group bit-equal before and after, the gated ones changed, finite
    losses, 12 flash64 forward launches and no backward per step; ms per
    step (median after the first, the profiled fourth left out), tokens/s,
    the device idle share of the fourth step (its device-busy time from the
    profiler against that median), the conditioner's share of steps 2 and 3
    (its time in ``prepare_batch`` over that plus the step's) and peak
    memory. Its model, gates opened to 1, is the checkpoint of
    ``recipes.transkd_asr`` (2 steps, ``freeze_encoder``: the teacher
    bit-equal after, the student without gated weights, finite losses, ms
    per step) and of ``recipes.evaluate`` in decode mode: beam 15 and greedy
    in bf16, then greedy in fp32 through the kernels and through the plain
    versions with the same tokens; 12 decode-attention launches per
    incremental step and 12 flash64 launches per batch; in the bf16 beam
    run, 24 cross-attention kernel launches per decoder call (the audio and
    text slabs of 12 layers, counted on the profiler: the step graphs
    replay them); RTF and tokens/s.

18. av: the audio-visual path at the full width of
    ``configs/audio-visual/av_en-x_small.yaml`` (Whisper ``small`` with one
    gated stream, ``bert_dim`` 1024; the AV-HuBERT ``large`` trunk, 24
    layers of 1024, and its ``large-avsr`` variant; random weights from
    seeds, the BatchNorm statistics randomized) on 16 s clips, 400 frames
    of 88x88 lip crops (the stream takes the decoder's 448 positions, so a
    30 s clip of 750 frames raises in both packages). (a) The ``large``
    trunk in fp32 on the card against the same module on the CPU (b1, 50
    frames, within 1e-4 of the largest magnitude); the bf16 ``large-avsr``
    trunk's ms at b8 x 400 frames and its plain attention's alone (24 x
    ``qkv_attention`` at (8, 400, 1024)). (b) ``AVWhisper.decode`` in bf16
    on the bench protocol (b8, 64 tokens, EOT suppressed, gates at 1):
    beam 15 under avsr, vsr and asr, greedy under avsr; RTF over the 16 s
    clips, tokens/s, the device idle share of a profiled batch, the
    trunk's share of the avsr beam-15 batch; launches: 12 flash64 per
    batch (0 under vsr, which decodes zero encoder features), 12
    decode-attention per incremental step. (c) fp32 greedy avsr through
    the kernels and through the plain versions: the same tokens. (d)
    ``recipes.av_train`` in-process on that config (synthetic 16 s
    utterances, b8, 3 steps, bf16, the Whisper and the trunk frozen): ms
    per step (median of steps 2 and 3), the device idle share of the third
    step rerun on a copy under the profiler, peak memory, 12 flash64
    forward launches and none backward per step, finite losses, the gated
    weights changed and every other Whisper weight bit-equal. (e)
    ``recipes.decode_av`` in-process over a manifest of 8 WAVs and
    400-frame ``.npy`` clips, avsr, beam 15: ``hypo.txt`` and ``ref.txt``
    written. (f) ``adakws_apply`` and ``reprogramming_apply`` at their
    default widths (d 768), card against CPU within 1e-4.

19. parallel: data and tensor parallelism on the one card. (a) Four
    gloo ranks share it on a 2 x 2 mesh (``parallel.distributed.spawn``;
    the kernels are built once, in phase 1, before the ranks start), with
    the Whisper-Flamingo at ``small``'s full width (one gated stream,
    ``bert_dim`` 768, gates at 0.5, random weights from seed 0, fp32, TF32
    off) on the bench batch (b8 of 30 s, 128 tokens; 4 rows a data rank,
    6 heads a model rank): a CE step and a TransKD step whose losses are
    within 1e-4 relative of one rank's on the whole batch and whose
    gathered gradients are within 1e-4 of each one-rank gradient's largest
    magnitude; greedy, beam 15, int8 greedy, and int8 greedy with the
    decode-MLP kernel on the split MLP (``ENABLED``), on the bench
    protocol, with the tokens of one rank. (b) Each rank's launches and
    shapes: 12 flash64 forwards and 12 backwards at (4·6, 1500, 64) a CE
    step, 12 forwards an encode, 12 decode-attention steps on (4 rows, D
    384, 6 heads) an incremental step, 12 decode-MLP launches a decoder
    pass with the switch on. (c) The same in bf16: finite losses, ms a
    step and a greedy batch per rank, labelled as four ranks sharing one
    card (gloo through the host: not a scaling figure). (d) One NCCL rank:
    an ``all_reduce``, and a 1 x 1 mesh's Flamingo CE step bit-equal to the
    no-mesh step. (e) ``parallel.dryrun.dryrun_multichip(4)`` on the card.
    (f) First, in the parent, each kernel the ranks run against its plain
    version at a model rank's shard shapes, with the tolerances of phases
    3, 7 and 11: the decode-attention step on (4, 448, 384) and (60, 448,
    384) caches with 6 heads, bf16 and fp32; the decode MLP at D 768 and
    F 1536 (model index 0's slice of a whole MLP) with a zero fc2 bias, at
    4 and 60 rows, bf16, int8 with bf16 x and int8 with fp32 x; flash64's
    forward, lse forward and backward at (4·6, 1500, 64), bf16 and fp32.
    Any failed rank or mismatch fails the phase.

20. the last modules (``phase_outer``). (a) The native host helpers
    (``whisper_flamingo_tpu_torch/native``, built with ``cc``): built, one
    ``add_noise`` mix equal to the helper's own, one edit distance equal
    to the Python path's. Then the kernels at this phase's own shapes
    against their plain versions, with phases 1 and 3's tolerances:
    flash64's forward and lse forward at (2·20, 1500, 64), and the
    decode-attention step at ``small``'s D 768 with 12 heads on demo's 2
    rows with per-row offsets and 30 with a shared one, bf16 and fp32,
    the caches equal. (b) The flagship TransKD rung
    (``tools.transkd_flagship_probe``: the gated ``large-v2`` teacher,
    bf16 and frozen; the ``large-v2`` student with a frozen bf16 encoder
    and shared features; b2 x 128 tokens, remat full) with Adafactor and
    with AdamW, each in a subprocess, 1 warm-up step and 3 timed: ms a
    step, the optimizer's span a step (CUDA events around ``tx.step()``),
    resident and peak GB, the optimizer's state bytes, 32 flash64
    forward launches a step at (2·20, 1500, 64), finite losses, the teacher
    and the student's encoder bit-equal after the steps. (c) The remat
    policies ``none``, ``full``, ``dots`` on phase 8's protocol (``small``
    b8, AdamW, bf16): median ms a step, peak GB (beside the memory held
    before the model was built), flash64 launches (lse forward and
    backward) a step; then one fp32 step each through the
    kernels, with deterministic algorithms: equal losses and gradients
    (``torch.equal``). (d) One fp32 Adafactor step of ``small`` through the
    kernels and through the plain flash64, on seeds 0 and 1: loss within
    1e-5 relative, every gradient within 1e-4 of its largest magnitude
    (phase 9's gates), every update within 1e-3 of its largest (Adafactor's
    row and column normalisation magnifies a gradient error in a row of
    small gradients: the worst element's row and column statistics and
    their change between the runs are reported with the first-order error
    they give), and the plain run's gradients through the kernel run's
    optimizer give the plain run's update within 1e-6.
    (e) SpecAugment ``ls-double`` on a b8 x 3000 x 80 batch on the card
    equal to the CPU's from the same draws, bit for bit; the card's ms a
    batch (draws and mask) beside ``spec_augment_np``'s host ms for the
    same 8 rows. (f) ``examples.eval_table.main`` at ``small``, beam 15, 8
    synthetic utterances, 64 tokens, clean and 0 dB, En and Ru: the table,
    wall s, 12 flash64 launches a batch and 12 decode-attention launches an
    incremental step; ``examples.demo.main`` at ``small``, greedy and beam
    15, likewise, its decode steps at the shapes held above.

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
FILL_ROWS = 2 * 132 * 128  # the pair probe's rows that fill the card


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


def _profiled_ms(torch, fn, calls: int, name: str = "", flush=None) -> float:
    """Device time per call from the profiler: the kernels whose names hold
    ``name`` (every kernel for ""), over ``calls`` calls. With ``flush`` (a
    tensor larger than the 50 MB L2) the tensor is read (summed) before
    each call, so each call finds its inputs in device memory and L2 full
    of clean lines, as after the decoder's weight reads; what the sum runs
    on the device is left out."""
    from torch.profiler import ProfilerActivity, profile

    skip = set()
    if flush is not None:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flush.sum()
            torch.cuda.synchronize()
        skip = {e.key for e in prof.key_averages()}
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            if flush is not None:
                flush.sum()
            fn()
        torch.cuda.synchronize()
    busy_ms, launches = _device_busy(torch, prof, name, skip)
    # per launch over the launches seen, times the launches per call: a
    # profile that drops a few records then still gives the time per call
    return busy_ms / max(launches, 1) * max(1, round(launches / calls))


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
    flush = torch.zeros(32 << 20, dtype=torch.bfloat16, device="cuda")  # 64 MB > the L2
    for dtype_name, tol in (("bfloat16", 2e-2), ("float32", 1e-5)):
        dtype = getattr(torch, dtype_name)
        for b, mode in ((8, "scalar"), (8, "per_row"), (BATCH * BEAM, "scalar")):
            q, kn, vn = (torch.randn(b, 1, D_MODEL, generator=gen, device="cuda").to(dtype)
                         for _ in range(3))
            kc = (torch.randn(b, T_MAX, D_MODEL, generator=gen, device="cuda") * 0.5).to(dtype)
            vc = (torch.randn(b, T_MAX, D_MODEL, generator=gen, device="cuda") * 0.5).to(dtype)
            if mode == "scalar":  # by value, as the decode loop passes it
                offset = off
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
                qh = q.view(b, 1, N_HEAD, dh).transpose(1, 2)
                kh = kc[:, : off + 1].view(b, off + 1, N_HEAD, dh).transpose(1, 2)
                vh = vc[:, : off + 1].view(b, off + 1, N_HEAD, dh).transpose(1, 2)
                step = lambda: decode_attn.fused_step(q, kn, vn, kc, vc, offset, N_HEAD)
                # SDPA over the same cached prefix (the attention only: it
                # does not write the cache); a yardstick the port never calls
                sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=dh ** -0.25)
                # back to back the host's enqueue can set the pace, so the
                # device time per call comes from the profiler: with L2
                # flushed before each call (the decode loop's case: a
                # layer's cache was last read a whole step earlier) as
                # ``ms``, and warm
                row["ms"] = _profiled_ms(torch, step, 100, "decode_attn", flush)
                row["warm_ms"] = _profiled_ms(torch, step, 200, "decode_attn")
                row["back_to_back_ms"] = time_ms(step, 200, 10)
                row["host_ms"] = host_ms(torch, step, 200)
                row["plain_ms"] = time_ms(
                    lambda: decode_attn.fused_step_plain(q, kn, vn, kc2, vc2, offset, N_HEAD), 20
                )
                row["library_ms"] = _profiled_ms(torch, sdpa, 100, "", flush)
                row["library_warm_ms"] = _profiled_ms(torch, sdpa, 200)
                row["library_back_to_back_ms"] = time_ms(sdpa, 200, 10)
                row["library_host_ms"] = host_ms(torch, sdpa, 200)
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


# beam15's self cache and the AV cell's: (rows, D, heads, T_max, the mean
# written position of a decode: the offset of the timed launch)
ROW_TABLE_SHAPES = {"beam15": (BATCH * BEAM, 768, 12, 132, 66),
                    "av": (BATCH * BEAM, 1280, 20, 68, 36)}


def phase_decode_attn_rows(torch, decode_attn, gen):
    """The decode-attention kernel read through a beam row table."""
    rows_out = []
    flush = torch.zeros(32 << 20, dtype=torch.bfloat16, device="cuda")
    for name, (b_full, d, n_head, t_max, t_off) in ROW_TABLE_SHAPES.items():
        for b in (b_full, 8):
            for dtype_name, tol in (("bfloat16", 2e-2), ("float32", 1e-5)):
                dtype = getattr(torch, dtype_name)
                worst = fault = 0.0
                own = torch.arange(b, device="cuda", dtype=torch.int32)[:, None]
                pos = torch.arange(t_max, device="cuda")[None]
                offsets = sorted({3, 4, 31, 32, 33, t_off, t_max // 2, t_max - 2, t_max - 1})
                for off in offsets:
                    q, kn, vn = (torch.randn(b, 1, d, generator=gen, device="cuda").to(dtype)
                                 for _ in range(3))
                    kc = (torch.randn(b, t_max, d, generator=gen, device="cuda") * 0.5).to(dtype)
                    vc = (torch.randn(b, t_max, d, generator=gen, device="cuda") * 0.5).to(dtype)
                    table = torch.randint(0, b, (b, t_max), generator=gen, device="cuda",
                                          dtype=torch.int32)
                    src = torch.where(pos < off, table.long(), own.long())
                    kg, vg = kc[src, pos], vc[src, pos]  # the cache moved by the table
                    kp, vp = kc.clone(), vc.clone()
                    direct, _, _ = decode_attn.fused_step(q, kn, vn, kg, vg, off, n_head)
                    with decode_attn.beam_rows(table):
                        got, _, _ = decode_attn.fused_step(q, kn, vn, kc, vc, off, n_head)
                        plain = decode_attn.fused_step_plain(q, kn, vn, kp, vp, off, n_head)
                    ignored, _, _ = decode_attn.fused_step(q, kn, vn, kp.clone(), vp.clone(),
                                                           off, n_head)
                    ident = decode_attn.fused_step(q, kn, vn, kp.clone(), vp.clone(), off,
                                                   n_head)[0]
                    with decode_attn.beam_rows(own.expand(b, t_max).contiguous()):
                        ident_rows = decode_attn.fused_step(q, kn, vn, kp.clone(), vp.clone(),
                                                            off, n_head)[0]
                    err, fault_err = max_err(got, plain), max_err(ignored, plain)
                    worst, fault = max(worst, err), max(fault, fault_err)
                    if not (torch.equal(got, direct) and torch.equal(ident, ident_rows)
                            and torch.equal(kc, kp) and torch.equal(vc, vp) and err <= tol
                            and fault_err > tol):
                        raise AssertionError(
                            f"decode_attn rows {name} b={b} {dtype_name} offset {off}: "
                            f"equal to the gathered cache {torch.equal(got, direct)}, identity "
                            f"{torch.equal(ident, ident_rows)}, caches "
                            f"{torch.equal(kc, kp) and torch.equal(vc, vp)}, max |err| {err} "
                            f"(tol {tol}), table ignored {fault_err} (must exceed tol)")
                row = {"shape": name, "rows": b, "d": d, "heads": n_head, "t_max": t_max,
                       "dtype": dtype_name, "latency_mode": b == 8, "offsets": offsets,
                       "max_abs_err": worst, "table_ignored_max_abs_err": fault, "tol": tol}
                if b == b_full and dtype_name == "bfloat16":
                    table = torch.randint(0, b, (b, t_max), generator=gen, device="cuda",
                                          dtype=torch.int32)

                    def step(rows=None):
                        with decode_attn.beam_rows(rows):
                            decode_attn.fused_step(q, kn, vn, kc, vc, t_off, n_head)

                    row["offset"] = t_off
                    row["direct_ms"] = _profiled_ms(torch, step, 100, "decode_attn", flush)
                    row["indirect_ms"] = _profiled_ms(torch, lambda: step(table), 100,
                                                      "decode_attn", flush)
                    row["direct_warm_ms"] = _profiled_ms(torch, step, 200, "decode_attn")
                    row["indirect_warm_ms"] = _profiled_ms(torch, lambda: step(table), 200,
                                                           "decode_attn")
                    row["direct_host_ms"] = host_ms(torch, step, 200)
                    row["indirect_host_ms"] = host_ms(torch, lambda: step(table), 200)
                rows_out.append(row)
    emit({"phase": "decode_attn_rows", "cases": rows_out})


# The kernel against its plain version (``attention.xa_qkv_plain``): the
# largest |err| and the rms error over the plain output's rms. Over eight
# seeds at the cells' shapes the sound kernel read at most 3.9e-3 and
# 2.0e-4 (PERF.md row 9); one that drops the 28-key last tile of 1,500
# keys read at least 0.043 and 0.13, one that ignores the gated slab's
# mask 0.19 and 0.26.
XATTN_MAX_ERR = 8e-3
XATTN_RMS_REL = 5e-3


def xattn_errs(out, ref):
    """(max |err|, rms error / rms of ``ref``) of a cross-attention output."""
    diff = out.float() - ref.float()
    return diff.abs().max().item(), (diff.norm() / ref.float().norm()).item()


def phase_xattn_step(torch, xattn_step, gen):
    import torch.nn.functional as F

    from whisper_flamingo_tpu_torch.ops.attention import head_split_kv, xa_qkv_plain

    flush = torch.zeros(32 << 20, dtype=torch.bfloat16, device="cuda")  # 64 MB > the L2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, results = [], {}
    cases = {"av_audio": (8, 20, 15, 1500, None), "av_gated": (8, 20, 15, 448, (86, 375)),
             "small_audio": (8, 12, 15, 1500, None), "small_text": (8, 12, 15, 128, None),
             "serve": (16, 20, 1, 1500, None)}
    for name, (slabs, heads, m, keys, valid) in cases.items():
        d = heads * 64
        q = torch.randn(slabs, m, d, generator=gen, device="cuda").bfloat16()
        k = (head_split_kv(torch.randn(slabs, keys, d, generator=gen, device="cuda"), heads)
             * 64 ** -0.25).bfloat16()
        v = head_split_kv(torch.randn(slabs, keys, d, generator=gen, device="cuda"),
                          heads).bfloat16()
        mask, open_keys = None, slabs * keys
        if valid is not None:  # a capacity slab: zero past each row's keys, masked there
            lengths = torch.randint(valid[0], valid[1] + 1, (slabs,), generator=gen,
                                    device="cuda")
            past = torch.arange(keys, device="cuda")[None] >= lengths[:, None]
            k.masked_fill_(past[:, None, :, None], 0)
            v.masked_fill_(past[:, None, :, None], 0)
            mask = torch.zeros(slabs, 1, 1, keys, device="cuda").masked_fill_(
                past[:, None, None], float("-inf"))
            open_keys = int(lengths.sum())
        out = xattn_step.xattn_step(q, k, v, heads, mask)
        again = xattn_step.xattn_step(q, k, v, heads, mask)
        torch.cuda.synchronize()
        ref = xa_qkv_plain(q, k, v, heads, mask)
        err, rms = xattn_errs(out, ref)
        if not (torch.isfinite(out).all().item() and err <= XATTN_MAX_ERR
                and rms <= XATTN_RMS_REL and torch.equal(out, again)):
            raise AssertionError(f"xattn_step {name}: max |err| {err} (limit {XATTN_MAX_ERR}), "
                                 f"rms {rms} (limit {XATTN_RMS_REL}), or reruns differ")
        # planted faults the limits must refuse: the keys' 28-key last tile
        # dropped, the gated slab's mask ignored
        faults = {}
        if keys % 64:
            cut = keys // 64 * 64
            faults["tile_dropped"] = xattn_errs(xattn_step.xattn_step(
                q, k[:, :, :cut].contiguous(), v[:, :, :cut].contiguous(), heads), ref)
        if mask is not None:
            faults["mask_ignored"] = xattn_errs(xattn_step.xattn_step(q, k, v, heads), ref)
        for fault, (f_err, f_rms) in faults.items():
            if f_err <= XATTN_MAX_ERR and f_rms <= XATTN_RMS_REL:
                raise AssertionError(f"xattn_step {name}: the planted fault {fault} passes "
                                     f"the limits ({f_err}, {f_rms})")
        qh = (q.view(slabs, m, heads, 64).transpose(1, 2) * 64 ** -0.25).contiguous()
        step = lambda: xattn_step.xattn_step(q, k, v, heads, mask)
        sdpa = lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask, scale=1.0)
        cluster, tpc = xattn_step.plan(slabs, m, keys, heads, sms,
                                       xattn_step.occupancy(0, torch.bfloat16))
        row = {"case": name, "slabs": slabs, "heads": heads, "rows": m, "keys": keys,
               "open_keys": open_keys, "cluster": cluster, "tiles_per_block": tpc,
               "blocks_per_sm": xattn_step.occupancy(0, torch.bfloat16)(tpc),
               "max_abs_err": err, "rms_rel_err": rms, "rerun_equal": True,
               "faults": {f: {"max_abs_err": e, "rms_rel_err": r} for f, (e, r) in faults.items()},
               "ms": _profiled_ms(torch, step, 100, "xattn", flush),
               "warm_ms": _profiled_ms(torch, step, 200, "xattn"),
               "host_ms": host_ms(torch, step, 200),
               "plain_ms": _profiled_ms(torch, lambda: xa_qkv_plain(q, k, v, heads, mask),
                                        50, "", flush),
               "library_ms": _profiled_ms(torch, sdpa, 100, "", flush),
               "library_warm_ms": _profiled_ms(torch, sdpa, 200)}
        # K and V of the open keys read once, q read and the output written
        nbytes = 2 * (2 * open_keys * d + 2 * slabs * m * d)
        row["bound_ms"], row["bound_by"] = bound(4.0 * open_keys * m * d, nbytes, "bfloat16")
        row["bound_share"] = row["bound_ms"] / row["ms"]
        results[name] = row
        rows.append(row)
    emit({"phase": "xattn_step", "cases": rows})
    return results["av_audio"]


def phase_dtw(torch, dtw):
    import numpy as np

    rng = np.random.default_rng(0)
    rows, timed = [], {}
    floor_ns = dtw.chain_floor_ns()  # one dependent step of the wavefront alone
    # the bench shapes, tie-rich integers, one row, and the edges of a warp's
    # 32 rows and of the ring between warps
    cases = [((65, 1500), False), ((224, 1500), False), ((33, 70), True), ((1, 1500), False),
             ((448, 1500), False)] + [((n, 1500), False) for n in (31, 32, 33, 63, 64, 447)]
    for shape, ints in cases:
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
        if shape in ((65, 1500), (224, 1500)) and not ints:
            n, m = shape
            row["ms"] = time_ms(lambda: dtw.dtw_trace(x), 50)
            row["plain_ms"] = time_ms(lambda: dtw.dtw_trace_plain(x), 2, 1)
            row["bound_ms"], row["bound_by"] = bound(0.0, 4.0 * n * m + (n + 1) * (m + 1),
                                                     "float32")
            # the chain of N + M dependent diagonals at the measured step
            row["chain_steps"] = n + m
            row["chain_floor_ns_per_step"] = floor_ns
            row["chain_floor_ms"] = (n + m) * floor_ns * 1e-6
            row["ns_per_step"] = row["ms"] * 1e6 / (n + m)
            row["host_ms"] = host_ms(torch, lambda: dtw.dtw_trace(x), 50)
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


def _train_batch(np, b, seed=0):
    """The bench protocol's batch: numpy seed 0, (b, 80, 3000) mel, (b, 128)
    tokens and labels in [0, 1000)."""
    rng = np.random.default_rng(seed)
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
    from whisper_flamingo_tpu_torch.models.whisper import _quantize_linear, mlp_block
    from whisper_flamingo_tpu_torch.profiling import device_span_ms

    d, f = D_MODEL, 4 * D_MODEL
    rows_out, timed = [], {}
    flush = torch.zeros(32 << 20, dtype=torch.bfloat16, device="cuda")  # 64 MB > the L2
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
            call = lambda: decode_mlp._launch(x, w1, b1, w2, b2, s1, s2)  # noqa: E731
            chain = lambda: mlp_block(mlp, x)  # noqa: E731
            # device time between events, with L2 flushed by a 64 MB read
            # before each call (the decode loop's case: 12 layers' weights
            # are far more than L2 holds; the kernels line's ``ms``) and warm:
            # the kernel, and the unfused mlp_block chain (the int8 casts
            # included; the route with ENABLED off, which the kernel's route
            # never calls)
            row["ms"] = device_span_ms(call, 100, flush)
            row["warm_ms"] = device_span_ms(call, 200)
            row["chain_device_ms"] = device_span_ms(chain, 100, flush)
            row["chain_warm_device_ms"] = device_span_ms(chain, 100)
            row["host_ms"] = host_ms(torch, call, 200)
            row["chain_host_ms"] = host_ms(torch, chain, 200)
            # back to back the host's enqueue sets the pace: not device times
            row["back_to_back_ms"] = time_ms(call, 200, 10)
            row["chain_back_to_back_ms"] = time_ms(chain, 200, 10)
            row["plain_ms"] = time_ms(
                lambda: decode_mlp.fused_mlp_plain(x, w1, b1, w2, b2, s1, s2), 50, 5)
            row["library_ms"] = None  # no single PyTorch call computes fc1, GELU and fc2
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
    from whisper_flamingo_tpu_torch.ops import attention, xattn_step

    saved = (flash64.flash64_attention, decode_attn.fused_step, decode_mlp._launch,
             xattn_step.xattn_step)

    def plain_step(q, k_raw, v_raw, k_cache, v_cache, offset, n_head):
        return decode_attn.fused_step_plain(q, k_raw, v_raw, k_cache, v_cache, offset,
                                            n_head), k_cache, v_cache

    flash64.flash64_attention = flash64.flash64_attention_plain
    decode_attn.fused_step = plain_step
    decode_mlp._launch = decode_mlp.fused_mlp_plain
    xattn_step.xattn_step = attention.xa_qkv_plain

    def restore():
        (flash64.flash64_attention, decode_attn.fused_step, decode_mlp._launch,
         xattn_step.xattn_step) = saved

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


def _device_busy(torch, prof, name: str = "", skip=()):
    """The sum of the device times of the kernels in a profile whose names
    hold ``name`` (all of them for "") and are not in ``skip``, ms, and
    their launches."""
    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0
              and name in e.key and e.key not in skip]
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
    # each kernel alone, in turns (csbound's call with kmax computed
    # beforehand: the probe's call above also runs the reduction), and kmax
    kmax_t = fv.key_norm_max(k)
    alone = {"shipped": lambda: flash64.flash64_forward(q, k, v),
             "augv": lambda: fv.flash64_fwd_augv(q, k, v),
             "csbound+augv": lambda: fv.flash64_fwd_csbound(q, k, v, kmax_t)}
    alone_turns = {name: [] for name in probe.VARIANTS}
    for name in probe.VARIANTS + probe.VARIANTS[::-1]:
        alone_turns[name].append(time_ms(alone[name], 20))
    alone_ms = {name: sum(x) / len(x) for name, x in alone_turns.items()}
    kmax_ms = time_ms(lambda: fv.key_norm_max(k), 20)
    out = {"phase": "flash64_fwd_probe", "shape": [BATCH, N_HEAD, t, 64],
           "shipped_ms": rows["shipped"]["ms"], "shipped_ms_turns": rows["shipped"]["ms_turns"],
           "shipped_alone_ms": alone_ms["shipped"],
           "shipped_alone_ms_turns": alone_turns["shipped"], "kmax_ms": kmax_ms,
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
               "ms_turns": rows[name]["ms_turns"], "alone_ms": alone_ms[name],
               "alone_ms_turns": alone_turns[name],
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


def _graph_chain_ms(torch, w, v, u, iters):
    """The addmm chain captured once in a CUDA graph and replayed: the
    library's device time without the host's launch rate. Returns the ms
    per replay and the chain's output."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # cuBLAS's handle and workspace before the capture
        _addmm_chain(torch, w, v, u, 2)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _addmm_chain(torch, w, v, u, iters)
    return time_ms(graph.replay, 3, 1), out


def phase_mma_pair(torch):
    """The pair kernel against its plain version at 512 and 33,792 rows, in
    the launch its wrapper plans for each; the operands' decay; the probe's
    rates at 512 rows and at the row count that fills the card; and the
    rate on operands that do not decay."""
    from whisper_flamingo_tpu_torch.ops import mma_pair
    from whisper_flamingo_tpu_torch.tools import packed_probe2 as probe

    rel = 2.0 ** -7  # one bf16 ulp of the output scale: fp32 sums in another order
    checks = []
    for rows in (512, FILL_ROWS):
        for _, d, n, _, _ in probe.POINTS:
            w, v, u = probe.make_operands(rows, n, d, "cuda", seed=d)
            p = mma_pair.plan(rows, n, d)
            for iters in (1, 2, 3):
                got = mma_pair.pair_chain(w, v, u, iters)
                again = mma_pair.pair_chain(w, v, u, iters)
                ref = mma_pair.pair_chain_plain(w, v, u, iters)
                scale = ref.float().abs().max().item()
                row = {"d": d, "n": n, "rows": rows, "cluster": p.cluster,
                       "rows_per_cta": p.rows_per_cta, "iters": iters,
                       "max_abs_err": max_err(got, ref), "scale": scale, "rel_tol": rel,
                       "same_bits_twice": torch.equal(got, again)}
                checks.append(row)
                if not (scale > 0 and row["same_bits_twice"] and row["max_abs_err"] <= rel * scale):
                    raise AssertionError(f"mma_pair: {row}")
            del w, v, u, got, again, ref
    w, v, u = probe.make_operands(512, probe.TK, 64, "cuda", seed=0)
    zero = {"kernel": mma_pair.first_zero_iteration(w, v, u, 64, chain=mma_pair.pair_chain),
            "plain": mma_pair.first_zero_iteration(w, v, u, 64)}

    mma_pair.pair_chain.launches = 0
    rates = {}
    for rows in (512, FILL_ROWS):
        points, ratios = probe.run(rows, "cuda")
        for p in points:
            p["raw_share_of_989"] = p["raw_tflops"] / (PEAK_FLOPS["bfloat16"] / 1e12)
        rates[rows] = {"points": points, **ratios}
    torch.cuda.synchronize()
    launches = mma_pair.pair_chain.launches

    # the rate at d 64 on the filled card on operands that keep their scale
    steady = probe.bench("pair d=64 (steady operands)", 64, probe.TK, FILL_ROWS, "cuda", None,
                         steady=True)
    ws, vs, us = probe.make_operands(FILL_ROWS, probe.TK, 64, "cuda", steady=True)
    w_end = mma_pair.pair_chain(ws, vs, us, steady["iters"])
    steady.update(raw_share_of_989=steady["raw_tflops"] / (PEAK_FLOPS["bfloat16"] / 1e12),
                  zero_operand_raw_tflops=rates[FILL_ROWS]["points"][0]["raw_tflops"],
                  input_scale=ws.float().abs().max().item(),
                  output_scale=w_end.float().abs().max().item(),
                  output_finite=bool(torch.isfinite(w_end.float()).all().item()))

    p64 = rates[512]["points"][0]
    iters, n = p64["iters"], p64["n"]
    w, v, u = probe.make_operands(512, n, 64, "cuda", seed=0)
    graph_ms, graph_out = _graph_chain_ms(torch, w, v, u, iters)
    entry = {"max_abs_err": max(c["max_abs_err"] for c in checks if c["d"] == 64),
             "ms": p64["ms"], "us_per_iter": p64["us_per_iter"], "rows": 512, "iters": iters,
             "plan": p64["plan"],
             "plain_ms": time_ms(lambda: mma_pair.pair_chain_plain(w, v, u, iters), 1, 1),
             "library_ms": time_ms(lambda: _addmm_chain(torch, w, v, u, iters), 1, 1),
             "library_call": "2 x iters torch.addmm (alpha 0.01, beta 0): no single call",
             "library_graph_ms": graph_ms,
             "library_graph_equals_eager": torch.equal(graph_out,
                                                       _addmm_chain(torch, w, v, u, iters)),
             "launches": launches}
    entry["bound_ms"], entry["bound_by"] = bound(
        mma_pair.pair_flops(512, n, 64, iters), 2.0 * (2 * 512 * n + 2 * n * 64), "bfloat16")
    emit({"phase": "mma_pair", "checks": checks, "first_all_zero_iteration": zero,
          "note": "past the first all-zero iteration every operand is zero: the rates are "
                  "readings on zero operands", "rates": {str(r): x for r, x in rates.items()},
          "steady_d64_filled": steady, "d64_rows512": entry})
    if zero["kernel"] is None or zero["plain"] is None:
        raise AssertionError(f"mma_pair: the operands did not decay to zero: {zero}")
    if not (steady["output_finite"] and steady["output_scale"] > 0):
        raise AssertionError(f"mma_pair: the steady operands did not keep their scale: {steady}")
    return entry


# bert-base-multilingual-cased's published widths (its config.json)
MBERT = dict(vocab_size=119547, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
             intermediate_size=3072, max_position_embeddings=512, type_vocab_size=2,
             layer_norm_eps=1e-12)
TEXT_OVERRIDES = ("model_name=small", "num_langs=1", "bert_dim=768", "batch_size=8",
                  "synthetic_n=16", "synthetic_sec=30", "precision=16-mixed",
                  "validate_every_n_batches=2", "log_every=1")


def _text_conditioner(dims, device):
    """The offline conditioner (byte tokenizer, max_length 512, buckets of
    16) over a BERT of ``dims`` with random weights from seed 0."""
    from whisper_flamingo_tpu_torch.models import bert

    cond = bert.HFBertConditioner(pretrained=False, device=device)
    cond.model = bert.BertModel(dims).init_weights(0).to(device).eval()
    cond.tokenizer = bert._ByteTokenizer(dims.vocab_size)
    cond.dim = dims.hidden_size
    return cond


def phase_text_conditioner(torch, device="cuda", mbert=MBERT, overrides=TEXT_OVERRIDES):
    """17: the BERT conditioner at mBERT's widths, card vs CPU; the Trans-ASR
    and TransKD recipes and the evaluate recipe with its ``xt``."""
    from unittest.mock import patch

    import numpy as np

    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from whisper_flamingo_tpu_torch import decoding
    from whisper_flamingo_tpu_torch.data.dataset import SyntheticAsrSource
    from whisper_flamingo_tpu_torch.models import bert
    from whisper_flamingo_tpu_torch.ops import decode_attn, decode_mlp, flash64
    from whisper_flamingo_tpu_torch.profiling import trace
    from whisper_flamingo_tpu_torch.recipes import common, evaluate, trans_asr, transkd_asr
    from whisper_flamingo_tpu_torch.training.checkpoints import save_torch_checkpoint
    from whisper_flamingo_tpu_torch.training.optim import flamingo_trainable_mask

    dims = bert.BertDims(**mbert)
    out = {}

    # (a) the conditioner users run: card against the same module on the CPU
    cond = _text_conditioner(dims, device)
    n_params = sum(p.numel() for p in cond.model.parameters())
    src = SyntheticAsrSource(n=BATCH, seed=0, n_translations=2, min_sec=30, max_sec=30)
    streams = [[src[i].translations[k] for i in range(BATCH)] for k in range(2)]
    texts = streams[0] + streams[1]
    ids, mask = cond.tokenize(texts)
    cpu_model = bert.BertModel(dims).init_weights(0).eval()
    with torch.no_grad():
        ref = cpu_model(torch.from_numpy(ids), torch.from_numpy(mask))
        got = cond.model(torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device))
    del cpu_model
    scale = ref.abs().max().item()
    err = max_err(got.cpu(), ref)
    encode_ms = []
    for _ in range(11):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xt = cond.encode_multi(streams)
        torch.cuda.synchronize()
        encode_ms.append((time.perf_counter() - t0) * 1e3)
    with tempfile.TemporaryDirectory() as log_dir:
        with trace(log_dir) as prof:
            cond.encode_multi(streams)
            torch.cuda.synchronize()
    busy_ms, kernel_launches = _device_busy(torch, prof)
    ms = float(np.median(encode_ms[1:]))
    out["conditioner"] = {
        "widths": mbert, "params": n_params, "texts": len(texts), "tokens": list(ids.shape),
        "xt": list(xt.shape), "max_abs_err_vs_cpu": err, "scale": scale, "rel_tol": 1e-4,
        "ms_per_encode_multi": ms, "encode_multi_ms_all": encode_ms,
        "device_busy_ms": busy_ms, "kernel_launches": kernel_launches,
        "host_share": 1.0 - busy_ms / ms}
    emit({"phase": "text_conditioner_mbert", **out["conditioner"]})
    if not (err <= 1e-4 * scale and torch.isfinite(got).all().item()
            and tuple(xt.shape[:2]) == (2, BATCH) and xt.shape[3] == dims.hidden_size):
        raise AssertionError(f"conditioner on the card vs the CPU: {out['conditioner']}")

    # time the conditioner inside the recipes' prepare_batch hook
    cond_calls = []
    encode_multi = cond.encode_multi

    def timed_encode_multi(all_texts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = encode_multi(all_texts)
        torch.cuda.synchronize()
        cond_calls.append((time.perf_counter() - t0) * 1e3)
        return res

    cond.encode_multi = timed_encode_multi
    built = []

    def capture_build_model(cfg, **kw):
        model = build_model(cfg, **kw)
        built.append((model, {n: p.detach().clone() for n, p in model.named_parameters()}))
        return model

    build_model = common.build_model

    def counted(make_step, steps, profile_at=None):
        """A step factory whose steps time themselves, count the flash64
        launches they make and (at ``profile_at``) run under the profiler."""
        def factory(*a, **kw):
            step = make_step(*a, **kw)

            def run(state, *args):
                counters = (flash64.flash64_forward, flash64.flash64_backward)
                before = [c.launches for c in counters] + [flash64.flash64_forward.lse_launches]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if len(steps) + 1 == profile_at:
                    with tempfile.TemporaryDirectory() as log_dir:
                        with trace(log_dir) as prof:
                            res = step(state, *args)
                            torch.cuda.synchronize()
                    busy, _ = _device_busy(torch, prof)
                else:
                    res, busy = step(state, *args), None
                torch.cuda.synchronize()
                after = [c.launches for c in counters] + [flash64.flash64_forward.lse_launches]
                steps.append({"ms": (time.perf_counter() - t0) * 1e3, "device_busy_ms": busy,
                              "conditioner_ms": cond_calls[-1] if cond_calls else None,
                              "tokens": int(np.prod(args[-1]["dec_input_ids"].shape)),
                              "flash64": dict(zip(("fwd", "bwd", "fwd_lse"),
                                                  (b - a for a, b in zip(before, after))))})
                return res

            return run

        return factory

    with tempfile.TemporaryDirectory() as tmp:
        def args(name, *extra):
            return [os.path.join(ROOT, "configs", "smoke", "trans_asr.yaml"), *overrides,
                    f"train_id={name}", f"log_output_dir={tmp}/logs",
                    f"check_output_dir={tmp}/ckpt", *extra]

        def losses(name):
            with open(os.path.join(tmp, "logs", f"{name}.metrics.jsonl")) as f:
                return [r["loss"] for r in map(json.loads, f) if "loss" in r]

        # (b) Trans-ASR: 4 gated steps on small with the mBERT conditioner
        steps = []
        torch.cuda.reset_peak_memory_stats()
        with (patch.object(common, "build_conditioner", lambda cfg: cond),
              patch.object(common, "build_model", capture_build_model),
              patch.object(trans_asr, "make_ce_train_step",
                           counted(trans_asr.make_ce_train_step, steps, profile_at=4))):
            state = trans_asr.main(args("trans_asr", "num_train_steps=4"))
        peak = torch.cuda.max_memory_allocated()
        model, before = built.pop()
        trainable = flamingo_trainable_mask(model)
        frozen_changed = [n for n, p in model.named_parameters()
                          if not trainable[n] and not torch.equal(p, before[n].to(p.dtype))]
        gated_unchanged = [n for n, p in model.named_parameters()
                           if trainable[n] and torch.equal(p, before[n])]
        loss = losses("trans_asr")
        n_layer, text_layers = model.dims.n_audio_layer, model.dims.n_text_layer
        timed = [s["ms"] for s in steps[1:] if s["device_busy_ms"] is None]
        step_ms = float(np.median(timed))
        prof_step = steps[3]
        out["trans_asr"] = {
            "steps": len(steps), "losses": loss, "ms_per_step": step_ms,
            "step_ms_all": [s["ms"] for s in steps],
            "tokens_per_s": steps[1]["tokens"] / (step_ms / 1e3),
            # the profiler slows the step it traces: busy over the median
            "profiled_step": {"ms": prof_step["ms"], "device_busy_ms": prof_step["device_busy_ms"],
                              "idle_share_vs_unprofiled_step":
                                  1.0 - prof_step["device_busy_ms"] / step_ms},
            "conditioner_ms_per_step": [s["conditioner_ms"] for s in steps],
            "conditioner_share": [s["conditioner_ms"] / (s["conditioner_ms"] + s["ms"])
                                  for s in steps[1:3]],
            "flash64_per_step": [s["flash64"] for s in steps], "peak_mem_gb": peak / 1e9,
            "frozen_params_changed": frozen_changed, "gated_params_unchanged": gated_unchanged}
        emit({"phase": "text_trans_asr_small_b8", **out["trans_asr"]})
        want = {"fwd": n_layer, "bwd": 0, "fwd_lse": 0}
        if (frozen_changed or gated_unchanged or len(loss) != 4 or not np.all(np.isfinite(loss))
                or any(s["flash64"] != want for s in steps) or state.step != 4):
            raise AssertionError(f"trans_asr: {out['trans_asr']}")
        # the trained model with its gates opened to 1, for the decode below
        with torch.no_grad():
            for blk in state.model.decoder.blocks:
                blk.ff_gate.fill_(1.0)
                for sub in blk.gated_x_attn_layers:
                    sub.attn_gate.fill_(1.0)
        ckpt = os.path.join(tmp, "flamingo_small.pt")
        save_torch_checkpoint(state.model, ckpt)
        del state, model, before
        torch.cuda.empty_cache()

        # (c) TransKD: the frozen teacher, the student without gated weights
        steps = []
        with (patch.object(common, "build_conditioner", lambda cfg: cond),
              patch.object(common, "build_model", capture_build_model),
              patch.object(transkd_asr, "make_kd_train_step",
                           counted(transkd_asr.make_kd_train_step, steps))):
            state = transkd_asr.main(args("transkd", "num_train_steps=2", "freeze_encoder=1",
                                          f"pt_ckpt={ckpt}"))
        teacher, before = built.pop()
        teacher_changed = [n for n, p in teacher.named_parameters()
                           if not torch.equal(p, before[n].to(p.dtype))]
        student_gated = [n for n, v in flamingo_trainable_mask(state.model, True).items() if v]
        loss = losses("transkd")
        out["transkd_asr"] = {"steps": len(steps), "losses": loss,
                              "ms_per_step": float(np.median([s["ms"] for s in steps[1:]])),
                              "step_ms_all": [s["ms"] for s in steps],
                              "teacher_params_changed": teacher_changed,
                              "student_gated_params": student_gated}
        emit({"phase": "text_transkd_small_b8", **out["transkd_asr"]})
        if teacher_changed or student_gated or len(loss) != 2 or not np.all(np.isfinite(loss)):
            raise AssertionError(f"transkd_asr: {out['transkd_asr']}")
        del state, teacher, before
        torch.cuda.empty_cache()

        # (d) evaluate, decode mode, with xt from the conditioner
        decoded = []
        steps_inc, calls = [0], [0]
        decoder_apply = decoding.decoder_apply

        def counting_decoder_apply(*a, **kw):
            steps_inc[0] += kw.get("offset", 0) > 0
            calls[0] += 1
            return decoder_apply(*a, **kw)

        class RecordingTask(decoding.DecodingTask):
            def run(self, mel, xt=None):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = super().run(mel, xt=xt)
                torch.cuda.synchronize()
                decoded.append({"s": time.perf_counter() - t0, "rows": len(res),
                                "tokens": [list(r.tokens) for r in res]})
                return res

        def run_eval(*extra, traced=False):
            """One evaluate run; its tokens land in ``tokens[extra]``. With
            ``traced`` the profiler counts the cross-attention kernel's
            device launches (the step graphs replay it, so the wrapper's
            count would see only the captures)."""
            decoded.clear()
            steps_inc[0] = calls[0] = 0
            decode_attn.fused_step.launches = flash64.flash64_forward.launches = 0
            with (patch.object(common, "build_conditioner", lambda cfg: cond),
                  patch.object(evaluate, "DecodingTask", RecordingTask),
                  patch.object(decoding, "decoder_apply", counting_decoder_apply),
                  profile(activities=[ProfilerActivity.CUDA]) if traced
                  else contextlib.nullcontext() as prof):
                res = evaluate.main(args("eval", "mode=decode", f"pt_ckpt={ckpt}", *extra))
                torch.cuda.synchronize()
            xattn = _device_busy(torch, prof, "xattn_kernel")[1] if traced else None
            n_tok = sum(len(t) for d in decoded for t in d["tokens"])
            decode_s = sum(d["s"] for d in decoded)
            tokens[extra] = [t for d in decoded for t in d["tokens"]]
            return {**res, "batches": len(decoded), "rows": sum(d["rows"] for d in decoded),
                    "decoded_tokens": n_tok,
                    "decode_s": decode_s, "tokens_per_s": n_tok / decode_s,
                    "incremental_steps": steps_inc[0], "decoder_calls": calls[0],
                    "launches": {"flash64": flash64.flash64_forward.launches,
                                 "decode_attn": decode_attn.fused_step.launches,
                                 "xattn_step": xattn}}

        runs, tokens = {}, {}
        for name, extra in (("beam15_bf16", ("beam_size=15",)), ("greedy_bf16", ()),
                            ("greedy_fp32", ("precision=32",))):
            r = runs[name] = run_eval(*extra, traced=name == "beam15_bf16")
            # bf16: every decoder call (the prefill and each step) runs the
            # kernel once a layer over the audio slab and once over the text
            # stream's
            if (r["launches"]["decode_attn"] != text_layers * r["incremental_steps"]
                    or r["launches"]["flash64"] != n_layer * r["batches"]
                    or name == "beam15_bf16"
                    and r["launches"]["xattn_step"] != 2 * text_layers * r["decoder_calls"]
                    or not r["incremental_steps"] or not 0 < r["n_utts"] == r["rows"]):
                raise AssertionError(f"evaluate {name}: {r}")
        fp32_tokens = tokens[("precision=32",)]
        restore = _plain_kernels(decode_attn, decode_mlp, flash64)
        try:
            runs["greedy_fp32_plain"] = run_eval("precision=32")
        finally:
            restore()
        same = fp32_tokens == tokens[("precision=32",)]
        out["evaluate"] = {**runs, "fp32_greedy_tokens_equal_plain": same}
        emit({"phase": "text_evaluate_small", **out["evaluate"]})
        if not same:
            raise AssertionError("evaluate: fp32 greedy tokens through the kernels differ from "
                                 "the plain versions'")
    del cond
    torch.cuda.empty_cache()
    return out


# 18: configs/audio-visual/av_en-x_small.yaml at full width (small + the
# AV-HuBERT large trunk) on 16 s clips: 400 frames of 88x88 lip crops
AV_SECONDS = 16
AV_SIZES = dict(model="small", trunk="large", trunk_avsr="large-avsr", frames=400, hw=88,
                check_frames=50,
                config=os.path.join("configs", "audio-visual", "av_en-x_small.yaml"))
AV_OVERRIDES = ("dataset=synthetic", "synthetic_n=16", f"synthetic_sec={AV_SECONDS}",
                "pt_ckpt=", "video_model_ckpt=", "num_devices=1", "num_train_steps=3",
                "warmup_steps=1", "validate_every_n_batches=2", "log_every=1")


def _random_bn_stats(torch, module, gen):
    """Non-trivial BatchNorm running statistics (a fresh init's are 0 and 1)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.normal_(0.0, 0.5, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)


def phase_av(torch, device="cuda", sizes=AV_SIZES, overrides=AV_OVERRIDES):
    """18: the audio-visual path and the legacy modules (see the module
    docstring); ``device`` and ``sizes`` let the phase run at debug sizes
    on the CPU, where no kernel launches."""
    import copy
    import wave
    from unittest.mock import patch

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    import whisper_flamingo_tpu_torch as wt
    from whisper_flamingo_tpu_torch.audio import pad_or_trim
    from whisper_flamingo_tpu_torch.models import avhubert, legacy
    from whisper_flamingo_tpu_torch.ops import decode_attn, decode_mlp, flash64
    from whisper_flamingo_tpu_torch.ops.attention import qkv_attention
    from whisper_flamingo_tpu_torch.recipes import av_train, common, decode_av
    from whisper_flamingo_tpu_torch.tokenizer import get_tokenizer
    from whisper_flamingo_tpu_torch.training.optim import flamingo_trainable_mask

    cuda = torch.device(device).type == "cuda"
    per_launch = 1 if cuda else 0  # the CPU runs the plain versions: no launches

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def busy_ms(fn):
        if not cuda:
            return float("nan")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        return _device_busy(torch, prof)[0]

    def counters():
        return {"flash64": flash64.flash64_forward.launches,
                "flash64_bwd": flash64.flash64_backward.launches,
                "decode_attn": decode_attn.fused_step.launches,
                "decode_mlp": decode_mlp.fused_mlp.launches}

    def zero_counters():
        for c in (flash64.flash64_forward, flash64.flash64_backward, decode_attn.fused_step,
                  decode_mlp.fused_mlp):
            c.launches = 0

    out = {}
    rng = np.random.default_rng(18)
    b, t, hw = BATCH, sizes["frames"], sizes["hw"]
    eot = get_tokenizer(True, language="en", task="transcribe").eot

    # (a) the large trunk in fp32, the card against the CPU, one seeded init
    vcfg = avhubert.VIDEO_ENCODER_CONFIGS[sizes["trunk"]]
    gen = torch.Generator().manual_seed(0)
    cpu_trunk = avhubert.init_video_encoder(gen, vcfg, device="cpu")
    _random_bn_stats(torch, cpu_trunk, gen)
    trunk = copy.deepcopy(cpu_trunk).to(device)
    clip = torch.from_numpy(rng.standard_normal((1, sizes["check_frames"], hw, hw))
                            .astype(np.float32))
    ref = avhubert.video_encoder_apply(cpu_trunk, vcfg, clip)
    got = avhubert.video_encoder_apply(trunk, vcfg, clip.to(device))
    del cpu_trunk
    scale, err = ref.abs().max().item(), max_err(got.cpu(), ref)
    row = {"trunk": sizes["trunk"], "params": sum(p.numel() for p in trunk.parameters()),
           "clip": list(clip.shape), "max_abs_err_vs_cpu": err, "scale": scale, "rel_tol": 1e-4}

    # the avsr trunk in bf16 at b8 x 400 frames: the trunk and its attention alone
    acfg = avhubert.VIDEO_ENCODER_CONFIGS[sizes["trunk_avsr"]]
    avsr_trunk = avhubert.init_video_encoder(torch.Generator().manual_seed(1), acfg, device="cpu")
    _random_bn_stats(torch, avsr_trunk, gen)
    avsr_trunk = avsr_trunk.to(device)
    waves = (rng.standard_normal((b, AV_SECONDS * 16000)) * 0.05).astype(np.float32)
    mel = wt.log_mel_spectrogram(pad_or_trim(waves), device=device)
    video = torch.from_numpy(rng.standard_normal((b, t, hw, hw)).astype(np.float32)).to(device)
    fbank = torch.from_numpy(np.stack([avhubert.stacked_fbank_features(w)[:t] for w in waves])
                             ).to(device)

    def timed_ms(fn, iters=5):
        fn()
        sync()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    row["bf16_trunk_ms"] = timed_ms(lambda: avhubert.avhubert_encoder_apply(
        avsr_trunk, acfg, video=video, audio=fbank, dtype=torch.bfloat16))
    q = torch.randn((b, t, acfg.embed_dim), device=device, dtype=torch.bfloat16)
    row["bf16_trunk_attention_ms"] = acfg.n_layers * timed_ms(
        lambda: qkv_attention(q, q, q, acfg.n_heads), iters=10)
    row["bf16_trunk_shape"] = [b, t, hw, hw]
    out["trunk"] = row
    emit({"phase": "av_trunk_large", **row})
    if not (err <= 1e-4 * scale and torch.isfinite(got).all().item()):
        raise AssertionError(f"AV trunk on the card vs the CPU: {row}")

    # (b) AV decode on the bench protocol: small, one stream from the trunk
    model = wt.load_model(sizes["model"], device=device, seed=0, add_gated_x_attn=1,
                          num_langs=1, bert_dim=vcfg.embed_dim)
    with torch.no_grad():
        for blk in model.decoder.blocks:
            blk.ff_gate.fill_(1.0)
            for sub in blk.gated_x_attn_layers:
                sub.attn_gate.fill_(1.0)
    model.dtype = torch.bfloat16  # the trunk computes in the model's dtype
    avs = {"avsr": avhubert.AVWhisper(model, avsr_trunk), "vsr": avhubert.AVWhisper(model, trunk),
           "asr": avhubert.AVWhisper(model, trunk)}
    inputs = {"avsr": dict(video=video, audio=fbank), "vsr": dict(video=video, test_v=True),
              "asr": dict(test_a=True)}
    n_enc, n_dec, n_steps = model.dims.n_audio_layer, model.dims.n_text_layer, SAMPLE_LEN - 1

    def options(fp16, beam):
        return wt.DecodingOptions(language="en", without_timestamps=True, sample_len=SAMPLE_LEN,
                                  fp16=fp16, beam_size=beam, suppress_tokens=f"-1,{eot}")

    runs = {}
    for name, modality, beam in (("avsr_beam15", "avsr", BEAM), ("vsr_beam15", "vsr", BEAM),
                                 ("asr_beam15", "asr", BEAM), ("avsr_greedy", "avsr", None)):
        av, kw, opts = avs[modality], inputs[modality], options(True, beam)
        zero_counters()
        res = av.decode(mel, opts, **kw)
        sync()
        launches = counters()
        want = {"flash64": 0 if modality == "vsr" else n_enc * per_launch, "flash64_bwd": 0,
                "decode_attn": n_dec * n_steps * per_launch, "decode_mlp": 0}
        t0 = time.perf_counter()  # the counted run was the warm-up
        av.decode(mel, opts, **kw)
        sync()
        wall = time.perf_counter() - t0
        busy = busy_ms(lambda: av.decode(mel, opts, **kw))
        r = runs[name] = {
            "launches": launches,
            "decode_attn_per_incremental_step": launches["decode_attn"] / n_steps,
            "s_per_batch": wall, "rtf": b * AV_SECONDS / wall, "tok_s": b * SAMPLE_LEN / wall,
            "device_busy_ms": busy, "idle_share": 1.0 - busy / (wall * 1e3),
            "tokens_ok": all(len(x.tokens) == SAMPLE_LEN and np.isfinite(x.avg_logprob)
                             for x in res)}
        emit({"phase": f"av_decode_{name}_small_b{b}", **r})
        if launches != want or not r["tokens_ok"] or len(res) != b:
            raise AssertionError(f"AV decode {name}: launches {launches}, expected {want}; {r}")
    batch_ms = runs["avsr_beam15"]["s_per_batch"] * 1e3
    shares = {"trunk_share_of_avsr_beam15_batch": row["bf16_trunk_ms"] / batch_ms,
              "trunk_attention_share_of_avsr_beam15_batch":
                  row["bf16_trunk_attention_ms"] / batch_ms}
    out["decode"] = dict(runs, **shares)
    emit({"phase": "av_decode_shares", **shares})

    # (c) fp32 greedy avsr: through the kernels, then through the plain versions
    model.dtype = torch.float32
    opts = options(False, None)
    kernel_res = avs["avsr"].decode(mel, opts, **inputs["avsr"])
    restore = _plain_kernels(decode_attn, decode_mlp, flash64)
    try:
        plain_res = avs["avsr"].decode(mel, opts, **inputs["avsr"])
    finally:
        restore()
    same = [k.tokens == p.tokens for k, p in zip(kernel_res, plain_res)]
    out["fp32"] = {"tokens_equal": same, "avg_logprob_max_diff": max(
        abs(k.avg_logprob - p.avg_logprob) for k, p in zip(kernel_res, plain_res))}
    emit({"phase": "av_fp32_greedy_kernel_vs_plain", **out["fp32"]})
    if not all(same):
        raise AssertionError("AV fp32 greedy: kernel tokens differ from plain tokens")
    del model, avs, trunk, avsr_trunk, video, fbank, q
    if cuda:
        torch.cuda.empty_cache()

    # (d) av_train: 3 steps of the gated layers on a frozen Whisper and trunk
    built, steps = [], []
    build_model = common.build_model

    def capture_build_model(cfg, **kw):
        m = build_model(cfg, **kw)
        built.append((m, {n: p.detach().clone() for n, p in m.named_parameters()}))
        return m

    def counted_av_step(*a, **kw):
        step = make_av_train_step(*a, **kw)

        def run(state, video_, batch, generator):
            before = counters()
            sync()
            t0 = time.perf_counter()
            res = step(state, video_, batch, generator)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            after = counters()
            steps.append({"ms": ms, "flash64": {k: after[k] - before[k]
                                                for k in ("flash64", "flash64_bwd")},
                          "tokens": int(np.prod(batch["dec_input_ids"].shape))})
            if len(steps) == 3:  # the last step again under the profiler, on a copy
                steps[-1]["device_busy_ms"] = busy_ms(
                    lambda: step(copy.deepcopy(state), video_, batch, generator))
            return res

        return run

    make_av_train_step = av_train.make_av_train_step
    with tempfile.TemporaryDirectory() as tmp:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        zero_counters()
        flash64.flash64_forward.lse_launches = 0
        with (patch.object(common, "build_model", capture_build_model),
              patch.object(av_train, "make_av_train_step", counted_av_step)):
            state = av_train.main([os.path.join(ROOT, sizes["config"]), *overrides,
                                   f"device={device}", "train_id=av", f"log_output_dir={tmp}/logs",
                                   f"check_output_dir={tmp}/ckpt"])
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
        with open(os.path.join(tmp, "logs", "av.metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
    model, before = built.pop()
    trainable = flamingo_trainable_mask(model)
    frozen_changed = [n for n, p in model.named_parameters()
                      if not trainable[n] and not torch.equal(p, before[n].to(p.dtype))]
    gated_unchanged = [n for n, p in model.named_parameters()
                       if trainable[n] and torch.equal(p, before[n])]
    losses = [r["loss"] for r in records if "loss" in r]
    step_ms = float(np.median([s["ms"] for s in steps[1:]]))
    prof_busy = steps[-1].get("device_busy_ms", float("nan"))
    out["train"] = {"steps": len(steps), "losses": losses, "val_loss": [
        r["val/loss"] for r in records if "val/loss" in r], "ms_per_step": step_ms,
        "step_ms_all": [s["ms"] for s in steps], "tokens_per_s": steps[1]["tokens"] / step_ms * 1e3,
        "device_busy_ms_step3": prof_busy, "idle_share": 1.0 - prof_busy / step_ms,
        "peak_mem_gb": peak, "flash64_per_step": [s["flash64"] for s in steps],
        "lse_launches": flash64.flash64_forward.lse_launches,
        "frozen_params_changed": frozen_changed, "gated_params_unchanged": gated_unchanged}
    emit({"phase": f"av_train_small_large_b{b}", **out["train"]})
    want = {"flash64": n_enc * per_launch, "flash64_bwd": 0}
    if (frozen_changed or gated_unchanged or len(losses) != 3 or not np.all(np.isfinite(losses))
            or state.step != 3 or any(s["flash64"] != want for s in steps)
            or flash64.flash64_forward.lse_launches):
        raise AssertionError(f"av_train: {out['train']}")
    del state, model, before
    if cuda:
        torch.cuda.empty_cache()

    # (e) decode_av in-process: 8 WAVs and 400-frame clips, beam 15, avsr
    with tempfile.TemporaryDirectory() as tmp:
        rows = ["id\twav_path\ttext\tvideo_path"]
        for i in range(b):
            with wave.open(os.path.join(tmp, f"u{i}.wav"), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes((waves[i] * 32767).astype(np.int16).tobytes())
            np.save(os.path.join(tmp, f"u{i}.npy"),
                    rng.standard_normal((t, hw, hw)).astype(np.float32))
            rows.append(f"u{i}\t{tmp}/u{i}.wav\tutterance number {i}\t{tmp}/u{i}.npy")
        with open(os.path.join(tmp, "test.tsv"), "w") as f:
            f.write("\n".join(rows) + "\n")
        zero_counters()
        t0 = time.perf_counter()
        metrics = decode_av.main(["--model-type", sizes["model"], "--modalities", "avsr",
                                  "--video-encoder", sizes["trunk_avsr"], "--beam-size", str(BEAM),
                                  "--batch-size", str(b), "--manifest", f"{tmp}/test.tsv",
                                  "--decode-dir", f"{tmp}/out", "--device", device])
        sync()
        wall = time.perf_counter() - t0
        launches = counters()
        written = {}
        for name in ("hypo.txt", "ref.txt"):
            with open(os.path.join(tmp, "out", name)) as f:
                written[name] = f.read().split("\n")
    out["decode_av"] = {"metrics": metrics, "wall_s": wall, "launches": launches,
                        "lines": {k: len(v) for k, v in written.items()}}
    emit({"phase": "av_decode_av_recipe_beam15", **out["decode_av"]})
    if (len(written["hypo.txt"]) != b or written["ref.txt"][0] != "utterance number 0"
            or launches["flash64"] != n_enc * per_launch or launches["decode_attn"] % n_dec
            or (cuda and not launches["decode_attn"])):
        raise AssertionError(f"decode_av: {out['decode_av']}")

    # (f) the legacy modules at their default widths, card against CPU, fp32
    kws_cpu = legacy.init_adakws(gen, 64, device="cpu")
    rep_cpu = legacy.init_reprogramming(gen, 768, 12, d_llm=768, device="cpu")
    feats = torch.from_numpy(rng.standard_normal((2, 1500, 768)).astype(np.float32))
    keywords = torch.from_numpy(rng.integers(0, 64, (2, 2, 8)))
    target = torch.from_numpy(rng.standard_normal((b, 64, 768)).astype(np.float32))
    source = torch.from_numpy(rng.standard_normal((1000, 768)).astype(np.float32))
    legacy_rows = {}
    for name, fn, mod, args in (
            ("adakws", legacy.adakws_apply, kws_cpu, (feats, keywords)),
            ("reprogramming_m1", lambda m, tg, s: legacy.reprogramming_apply(m, tg, s, s, 12),
             rep_cpu, (target, source))):
        ref = fn(mod, *args)
        got = fn(copy.deepcopy(mod).to(device), *(a.to(device) for a in args))
        legacy_rows[name] = {"shape": list(got.shape),
                             "max_abs_err_vs_cpu": max_err(got.cpu(), ref),
                             "scale": ref.abs().max().item(), "rel_tol": 1e-4}
    out["legacy"] = legacy_rows
    emit({"phase": "legacy", **legacy_rows})
    if any(r["max_abs_err_vs_cpu"] > 1e-4 * r["scale"] for r in legacy_rows.values()):
        raise AssertionError(f"legacy modules on the card vs the CPU: {legacy_rows}")
    return out


# -- 19. data and tensor parallelism ------------------------------------------

PAR_MESH = (2, 2)
# (name, beam, quantize) of the fp32 decodes; the last runs the decode-MLP
# kernel (``ENABLED``) on the model row's shard of the MLP
PAR_DECODES = (("greedy", None, None), ("beam", "beam", None), ("int8_greedy", None, "int8"),
               ("int8_greedy_mlp", None, "int8"))
PAR_SIZES = dict(model="small", bert_dim=768, rows=BATCH, tokens=128, xt_len=64,
                 sample_len=SAMPLE_LEN, beam=BEAM, bf16_steps=3)


def _par_model(wt, sizes, device, gated=True, seed=0):
    """The phase's Whisper-Flamingo: one gated stream, gates at 0.5, random
    weights from ``seed`` (the same bits on every rank)."""
    kw = dict(add_gated_x_attn=1, num_langs=1, bert_dim=sizes["bert_dim"]) if gated else {}
    model = wt.load_model(sizes["model"], device=device, seed=seed, **kw)
    if gated:
        import torch

        with torch.no_grad():
            for blk in model.decoder.blocks:
                blk.ff_gate.fill_(0.5)
                for sub in blk.gated_x_attn_layers:
                    sub.attn_gate.fill_(0.5)
    return model


def _par_batch(np, sizes):
    """The bench batch (``_train_batch``) with one conditioning stream."""
    batch = _train_batch(np, sizes["rows"])
    batch["dec_input_ids"] = batch["dec_input_ids"][:, : sizes["tokens"]]
    batch["labels"] = batch["labels"][:, : sizes["tokens"]]
    rng = np.random.default_rng(1)
    batch["xt"] = rng.standard_normal(
        (1, sizes["rows"], sizes["xt_len"], sizes["bert_dim"])).astype(np.float32)
    return batch


def _par_mel(np, sizes):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((sizes["rows"], 80, 3000)) * 0.3).astype(np.float32)


def _par_options(wt, sizes, eot, fp16, beam=None, quantize=None):
    return wt.DecodingOptions(language="en", without_timestamps=True,
                              sample_len=sizes["sample_len"], fp16=fp16,
                              beam_size=sizes["beam"] if beam == "beam" else beam,
                              suppress_tokens=f"-1,{eot}", quantize=quantize)


def _par_steps(wt, sizes, device, kind, dtype, mesh=None):
    """(model, step, batch, optimizer) of one CE or TransKD step, on
    ``mesh`` (this rank's shard and rows) or whole."""
    import numpy as np

    from whisper_flamingo_tpu_torch.parallel.mesh import shard_batch, shard_params
    from whisper_flamingo_tpu_torch.recipes.transkd_asr import init_student_from_teacher
    from whisper_flamingo_tpu_torch.training.optim import whisper_optimizer
    from whisper_flamingo_tpu_torch.training.steps import make_ce_train_step, make_kd_train_step

    batch = _par_batch(np, sizes)
    teacher = None
    model = _par_model(wt, sizes, device)
    if kind == "kd":
        teacher, model = model, init_student_from_teacher(
            model, _par_model(wt, sizes, device, gated=False, seed=1))
        step = make_kd_train_step(model.dims, teacher_uses_xt=True, dtype=dtype, remat=False)
    else:
        step = make_ce_train_step(model.dims, use_xt=True, dtype=dtype, remat=False)
    tx, _ = whisper_optimizer(model, 1e-5, total_steps=1000)
    if mesh is not None:
        shard_params(model, mesh)
        tx.shard(mesh, model.tp_dims)
        if teacher is not None:
            shard_params(teacher, mesh)
        batch = shard_batch(batch, mesh)
    if teacher is not None:
        kd_step = step

        def step(state, b):
            return kd_step(state, teacher, b)
    return model, step, batch, tx


def _captured_grads(tx):
    """The gradients the optimizer applies (after the data-parallel
    average), by name, filled by the next step."""
    grads = {}
    grads_of = tx._grads

    def capture():
        out = grads_of()
        grads.update((n, g.detach().clone()) for n, g in zip(tx.names, out))
        return out

    tx._grads = capture
    return grads


class _Launches:
    """Counts and shapes of the kernel launches on this rank: flash64's
    forward (the (B*H, T, 64) it ran at) and backward, the decode-attention
    step (the cache width and heads). The wrappers carry the counters the
    kernels' own code increments."""

    def __init__(self, flash64, decode_attn):
        self.mods = flash64, decode_attn
        self.saved = flash64.flash64_forward, flash64.flash64_backward, decode_attn.fused_step
        fwd, bwd, dstep = self.saved
        seen = self.seen = {"flash64_fwd": set(), "flash64_bwd": set(), "decode_attn": set()}

        def fwd_rec(qh, *a, **k):
            seen["flash64_fwd"].add((qh.shape[0] * qh.shape[1], qh.shape[2], qh.shape[3]))
            return fwd(qh, *a, **k)

        def bwd_rec(qh, *a, **k):
            seen["flash64_bwd"].add((qh.shape[0] * qh.shape[1], qh.shape[2], qh.shape[3]))
            return bwd(qh, *a, **k)

        def step_rec(q, k_raw, v_raw, k_cache, v_cache, offset, n_head):
            seen["decode_attn"].add((k_cache.shape[0], k_cache.shape[-1], n_head))
            return dstep(q, k_raw, v_raw, k_cache, v_cache, offset, n_head)

        self.wrappers = fwd_rec, bwd_rec, step_rec
        flash64.flash64_forward, flash64.flash64_backward, decode_attn.fused_step = self.wrappers
        self.reset()

    def reset(self):
        from whisper_flamingo_tpu_torch.ops import decode_mlp

        decode_mlp.fused_mlp.launches = 0
        for w in self.wrappers:
            w.launches = 0
        self.wrappers[0].lse_launches = 0
        for s in self.seen.values():
            s.clear()

    def read(self, torch):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        fwd, bwd, dstep = self.wrappers
        from whisper_flamingo_tpu_torch.ops import decode_mlp

        return {"flash64_fwd": fwd.launches, "flash64_bwd": bwd.launches,
                "decode_attn": dstep.launches, "decode_mlp": decode_mlp.fused_mlp.launches,
                "shapes": {k: sorted(v) for k, v in self.seen.items()}}

    def restore(self):
        flash64, decode_attn = self.mods
        flash64.flash64_forward, flash64.flash64_backward, decode_attn.fused_step = self.saved


def _worst_grad(got, want):
    """(name, max |got - want| / max |want|) of the worst parameter."""
    worst = ("", 0.0)
    for name, w in want.items():
        g = got[name].float()
        w = w.to(g.device).float()
        err = (g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        worst = max(worst, (name, err), key=lambda x: x[1])
    return worst


def _par_kernels_vs_plain(torch, dims, sizes):
    """Each kernel the ranks run, against its plain version on the same card
    inputs at a model rank's shard shapes, with the tolerances of phases 3,
    7 and 11: the decode-attention step on (rows, T, D/tp) caches with H/tp
    heads at greedy's and beam's rows; the decode MLP on model index 0's
    shard of a whole MLP (fc1's first F/tp outputs, fc2's first F/tp
    inputs, int8 scales of the whole weights) with a zero fc2 bias; flash64's
    forward, and its lse forward and backward, at (rows * H/tp, T, 64).
    Returns (rows, failures)."""
    from whisper_flamingo_tpu_torch.ops import decode_attn, decode_mlp, flash64
    from whisper_flamingo_tpu_torch.ops.quant import quantize_linear_params

    n_data, n_model = PAR_MESH
    rows = sizes["rows"] // n_data
    gen = torch.Generator(device="cuda").manual_seed(19)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")  # noqa: E731
    out, failures = [], []

    def check(row, ok):
        out.append(row)
        if not ok:
            failures.append(f"{row['kernel']} vs plain at the shard: {row}")

    heads, d, t_max = dims.n_text_head // n_model, dims.n_text_state // n_model, dims.n_text_ctx
    off = sizes["sample_len"] + 2  # the last step of the bench protocol
    for dtype_name, tol in (("bfloat16", 2e-2), ("float32", 1e-5)):
        dtype = getattr(torch, dtype_name)
        for b in (rows, rows * sizes["beam"]):
            q, kn, vn = (randn(b, 1, d).to(dtype) for _ in range(3))
            kc, vc = ((randn(b, t_max, d) * 0.5).to(dtype) for _ in range(2))
            kc2, vc2 = kc.clone(), vc.clone()
            got, _, _ = decode_attn.fused_step(q, kn, vn, kc, vc, off, heads)
            ref = decode_attn.fused_step_plain(q, kn, vn, kc2, vc2, off, heads)
            err, cache_err = max_err(got, ref), max(max_err(kc, kc2), max_err(vc, vc2))
            check({"kernel": "decode_attn", "dtype": dtype_name, "cache": [b, t_max, d],
                   "heads": heads, "max_abs_err": err, "cache_max_abs_err": cache_err,
                   "tol": tol},
                  torch.isfinite(got).all().item() and err <= tol and cache_err == 0.0)

    dm, f = dims.n_text_state, 4 * dims.n_text_state
    f_local = f // n_model
    for dtype_name, int8, tol in (("bfloat16", False, 1e-2), ("bfloat16", True, 1e-2),
                                  ("float32", True, 1e-5)):
        dtype = getattr(torch, dtype_name)
        w1, w2 = randn(f, dm) * dm ** -0.5, randn(dm, f) * f ** -0.5
        b1 = (randn(f) * 0.1).to(dtype)
        if int8:
            (w1, s1), (w2, s2) = quantize_linear_params(w1), quantize_linear_params(w2)
            s1 = s1[:f_local].contiguous()
        else:
            w1, w2, s1, s2 = w1.to(dtype), w2.to(dtype), None, None
        w1, b1, w2 = w1[:f_local].contiguous(), b1[:f_local].contiguous(), w2[:, :f_local].contiguous()
        b2 = torch.zeros(dm, dtype=dtype, device="cuda")
        for b in (rows, rows * sizes["beam"]):
            x = randn(b, dm).to(dtype)
            got = decode_mlp._launch(x, w1, b1, w2, b2, s1, s2)
            again = decode_mlp._launch(x, w1, b1, w2, b2, s1, s2)
            ref = decode_mlp.fused_mlp_plain(x, w1, b1, w2, b2, s1, s2)
            scale = max(ref.float().abs().max().item(), 1.0)
            err = max_err(got, ref)
            check({"kernel": "decode_mlp", "dtype": dtype_name,
                   "weights": "int8" if int8 else dtype_name, "rows": b, "d": dm, "f": f_local,
                   "max_abs_err": err, "scale": scale, "rel_tol": tol,
                   "same_bits_twice": torch.equal(got, again)},
                  torch.isfinite(got).all().item() and err <= tol * scale
                  and torch.equal(got, again))

    h, t = dims.n_audio_head // n_model, dims.n_audio_ctx
    for dtype_name, fwd_tol, lse_fwd_tol, rel in (("bfloat16", 1e-2, 2e-2, 1e-2),
                                                  ("float32", 1e-5, 1e-5, 1e-4)):
        dtype = getattr(torch, dtype_name)
        q, k = ((randn(rows, h, t, 64) * 64 ** -0.25).to(dtype) for _ in range(2))
        v, do = (randn(rows, h, t, 64).to(dtype) for _ in range(2))
        o = flash64.flash64_forward(q, k, v)
        o_lse, lse = flash64.flash64_forward(q, k, v, with_lse=True)
        grads = flash64.flash64_backward(q, k, v, o_lse, lse, do)
        o_ref, lse_ref = flash64.flash64_forward_plain(q, k, v, with_lse=True)
        g_ref = flash64.flash64_backward_plain(q, k, v, o_lse, lse, do)
        errs = {n: max_err(a, r) for n, a, r in zip(("dq", "dk", "dv"), grads, g_ref)}
        scales = {n: max(r.float().abs().max().item(), 1.0)
                  for n, r in zip(("dq", "dk", "dv"), g_ref)}
        row = {"kernel": "flash64", "dtype": dtype_name, "shape": [rows * h, t, 64],
               "o_max_abs_err": max_err(o, o_ref), "o_tol": fwd_tol,
               "lse_o_max_abs_err": max_err(o_lse, o_ref), "lse_o_tol": lse_fwd_tol,
               "lse_max_abs_err": max_err(lse, lse_ref), "lse_tol": 1e-4,
               "bwd_max_abs_err": errs, "bwd_scale": scales, "bwd_rel_tol": rel}
        check(row, torch.isfinite(o).all().item() and row["o_max_abs_err"] <= fwd_tol
              and row["lse_o_max_abs_err"] <= lse_fwd_tol and row["lse_max_abs_err"] <= 1e-4
              and all(errs[n] <= rel * scales[n] for n in errs))
    torch.cuda.synchronize()
    return out, failures


def _parallel_rank(rank, device, sizes, ref_path, eot):
    """One rank of the 2 x 2 mesh (gloo; the ranks share the card): the fp32
    CE and TransKD steps, greedy, beam and int8 greedy decode, then the bf16
    step and decode timed. Rank 0 holds the gathered gradients against the
    one-rank reference."""
    import statistics

    import numpy as np
    import torch

    import whisper_flamingo_tpu_torch as wt
    from whisper_flamingo_tpu_torch.ops import decode_attn, decode_mlp, flash64
    from whisper_flamingo_tpu_torch.parallel.mesh import gather_named, make_mesh, shard_params
    from whisper_flamingo_tpu_torch.training.steps import TrainState

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(*PAR_MESH)
    ref = torch.load(ref_path, map_location="cpu", weights_only=True) if rank == 0 else None
    launches = _Launches(flash64, decode_attn)
    out = {"rank": rank, "data_index": mesh.data_index, "model_index": mesh.model_index}
    try:
        for kind in ("ce", "kd"):
            model, step, batch, tx = _par_steps(wt, sizes, device, kind, torch.float32, mesh)
            grads = _captured_grads(tx)
            launches.reset()
            _, metrics = step(TrainState.create(model, tx), batch)
            row = {"loss": float(metrics["loss"]), "launches": launches.read(torch)}
            full = gather_named(grads, model.tp_dims, mesh)
            if ref is not None:
                row["worst_grad"] = _worst_grad(full, ref[kind])
            out[kind] = row
            del model, step, batch, tx, grads, full
            torch.cuda.empty_cache() if torch.cuda.is_available() else None

        mel = _par_mel(np, sizes)
        xt = _par_batch(np, sizes)["xt"]
        model = shard_params(_par_model(wt, sizes, device), mesh)
        for name, beam, quantize in PAR_DECODES:
            task = wt.DecodingTask(model, _par_options(wt, sizes, eot, False, beam, quantize))
            decode_mlp.ENABLED = name == "int8_greedy_mlp"
            launches.reset()
            try:
                res = task.run(mel, xt=xt)
            finally:
                decode_mlp.ENABLED = False
            out[name] = {"tokens": [r.tokens for r in res],
                         "avg_logprob": [r.avg_logprob for r in res],
                         "launches": launches.read(torch)}
        del model, task

        # bf16: the step and a decode batch timed (every rank on the one card)
        model, step, batch, tx = _par_steps(wt, sizes, device, "ce", torch.bfloat16, mesh)
        state, losses, ms = TrainState.create(model, tx), [], []
        for _ in range(sizes["bf16_steps"]):
            sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
            sync()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        del model, step, batch, tx, state
        model = shard_params(_par_model(wt, sizes, device), mesh)
        task = wt.DecodingTask(model, _par_options(wt, sizes, eot, True))
        decode_ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            res = task.run(mel, xt=xt)
            decode_ms.append((time.perf_counter() - t0) * 1e3)
        out["bf16"] = {"losses": losses, "step_ms": ms,
                       "ms_per_step": statistics.median(ms[1:]) if len(ms) > 1 else ms[0],
                       "ms_per_batch": decode_ms[-1], "decode_ms": decode_ms,
                       "tokens_finite": all(np.isfinite(r.avg_logprob) for r in res)}
    finally:
        launches.restore()
    return out


def _nccl_rank(rank, device, sizes):
    """One NCCL rank: a 1 x 1 mesh's Flamingo CE step (the gated group
    trains) against the no-mesh step from the same weights, bit for bit,
    and one all_reduce through NCCL."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import whisper_flamingo_tpu_torch as wt
    from whisper_flamingo_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_params
    from whisper_flamingo_tpu_torch.training.optim import whisper_flamingo_optimizer
    from whisper_flamingo_tpu_torch.training.steps import TrainState, make_ce_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    probe = torch.full((4,), 2.0, device=device)
    dist.all_reduce(probe)
    runs = []
    for mesh in (None, make_mesh(1, 1)):
        model = _par_model(wt, sizes, device)
        tx, _ = whisper_flamingo_optimizer(model, 1e-5, total_steps=1000)
        grads = _captured_grads(tx)
        batch = _par_batch(np, sizes)
        if mesh is not None:
            shard_params(model, mesh)
            tx.shard(mesh, model.tp_dims)
            batch = shard_batch(batch, mesh)
        step = make_ce_train_step(model.dims, use_xt=True, dtype=torch.float32, remat=False)
        _, metrics = step(TrainState.create(model, tx), batch)
        runs.append((metrics["loss"].item(), {n: g.cpu() for n, g in grads.items()}))
        del model, tx, step
    (loss0, g0), (loss1, g1) = runs
    return {"backend": dist.get_backend(), "all_reduce": probe.tolist(),
            "loss_no_mesh": loss0, "loss_1x1": loss1, "n_grads": len(g0),
            "bit_equal": loss0 == loss1 and all(torch.equal(g0[n], g1[n]) for n in g0)}


def phase_parallel(torch, device="cuda", sizes=PAR_SIZES):
    """19: data and tensor parallelism (see the module docstring); with
    ``device="cpu"`` and debug ``sizes`` it rehearses on the CPU (gloo
    ranks, the plain kernels, no launches to count)."""
    import numpy as np

    import whisper_flamingo_tpu_torch as wt
    from whisper_flamingo_tpu_torch.ops import decode_mlp
    from whisper_flamingo_tpu_torch.parallel.distributed import spawn
    from whisper_flamingo_tpu_torch.parallel.dryrun import dryrun_multichip
    from whisper_flamingo_tpu_torch.tokenizer import get_tokenizer
    from whisper_flamingo_tpu_torch.training.steps import TrainState

    t_phase = time.perf_counter()
    on_card = device != "cpu"
    eot = get_tokenizer(True, language="en", task="transcribe").eot
    dims = wt.MODEL_DIMS[sizes["model"]]
    n_data, n_model = PAR_MESH
    failures, at_shard = [], []
    if on_card:  # on the CPU the wrappers are their plain versions
        at_shard, failures = _par_kernels_vs_plain(torch, dims, sizes)
    # the one-rank reference: the whole batch, no mesh
    ref, one = {}, {}
    for kind in ("ce", "kd"):
        model, step, batch, tx = _par_steps(wt, sizes, device, kind, torch.float32)
        grads = _captured_grads(tx)
        _, metrics = step(TrainState.create(model, tx), batch)
        one[kind] = float(metrics["loss"])
        ref[kind] = {n: g.cpu() for n, g in grads.items()}
        del model, step, batch, tx, grads
    mel, xt = _par_mel(np, sizes), _par_batch(np, sizes)["xt"]
    model = _par_model(wt, sizes, device)
    for name, beam, quantize in PAR_DECODES:
        task = wt.DecodingTask(model, _par_options(wt, sizes, eot, False, beam, quantize))
        decode_mlp.ENABLED = name == "int8_greedy_mlp"
        try:
            one[name] = [r.tokens for r in task.run(mel, xt=xt)]
        finally:
            decode_mlp.ENABLED = False
    del model, task
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_phase

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "grads.pt")
        torch.save(ref, path)
        del ref
        t0 = time.perf_counter()
        ranks = spawn(_parallel_rank, n_data * n_model, (sizes, path, eot), device=device,
                      threads=0 if on_card else 1)
        t_ranks = time.perf_counter() - t0

    rank0 = ranks[0]
    for kind in ("ce", "kd"):
        for r in ranks:
            rel = abs(r[kind]["loss"] - one[kind]) / abs(one[kind])
            if rel > 1e-4:
                failures.append(f"{kind} loss rank {r['rank']}: {r[kind]['loss']} vs {one[kind]}")
        if rank0[kind]["worst_grad"][1] > 1e-4:
            failures.append(f"{kind} gradient {rank0[kind]['worst_grad']}")
    for name, _, _ in PAR_DECODES:
        for r in ranks:
            if r[name]["tokens"] != one[name]:
                failures.append(f"{name} tokens differ on rank {r['rank']}")
    for r in ranks:
        if not (all(np.isfinite(r["bf16"]["losses"])) and r["bf16"]["tokens_finite"]):
            failures.append(f"bf16 not finite on rank {r['rank']}: {r['bf16']['losses']}")
    rows_local, heads_local = sizes["rows"] // n_data, dims.n_audio_head // n_model
    n_steps = sizes["sample_len"] - 1
    if on_card:
        want_fwd = [(rows_local * heads_local, dims.n_audio_ctx, 64)]
        want_step = [(rows_local, dims.n_text_state // n_model, dims.n_text_head // n_model)]
        for r in ranks:
            ce = r["ce"]["launches"]
            if (ce["flash64_fwd"], ce["flash64_bwd"]) != (dims.n_audio_layer,) * 2 \
                    or ce["shapes"]["flash64_fwd"] != want_fwd \
                    or ce["shapes"]["flash64_bwd"] != want_fwd:
                failures.append(f"CE launches rank {r['rank']}: {ce}")
            for name in ("greedy", "int8_greedy", "int8_greedy_mlp"):
                got = r[name]["launches"]
                mlp = dims.n_text_layer * (n_steps + 1) if name.endswith("mlp") else 0
                if got["flash64_fwd"] != dims.n_audio_layer \
                        or got["decode_attn"] != dims.n_text_layer * n_steps \
                        or got["decode_mlp"] != mlp \
                        or got["shapes"]["decode_attn"] != want_step:
                    failures.append(f"{name} launches rank {r['rank']}: {got}")
            if r["beam"]["launches"]["decode_attn"] != dims.n_text_layer * n_steps:
                failures.append(f"beam launches rank {r['rank']}: {r['beam']['launches']}")

    # one NCCL rank (gloo on the CPU rehearsal): the backend of real multi-card runs
    t0 = time.perf_counter()
    (one_by_one,) = spawn(_nccl_rank, 1, (sizes,), device=device, threads=0 if on_card else 1)
    t_nccl = time.perf_counter() - t0
    if not one_by_one["bit_equal"] or one_by_one["all_reduce"] != [2.0] * 4 \
            or (on_card and one_by_one["backend"] != "nccl"):
        failures.append(f"1x1 mesh: {one_by_one}")

    t0 = time.perf_counter()
    dry = dryrun_multichip(4, device=device)
    t_dry = time.perf_counter() - t0

    smi = smi_line() if on_card else "cpu"
    row = {
        "phase": "parallel", "mesh": f"{n_data}x{n_model}", "device": smi,
        "backend": "gloo, four ranks sharing one card" if on_card else "gloo, CPU",
        "model": sizes["model"], "rows": sizes["rows"], "tokens": sizes["tokens"],
        "ce_loss": {"one_rank": one["ce"], "ranks": [r["ce"]["loss"] for r in ranks]},
        "ce_worst_grad": rank0["ce"]["worst_grad"],
        "kd_loss": {"one_rank": one["kd"], "ranks": [r["kd"]["loss"] for r in ranks]},
        "kd_worst_grad": rank0["kd"]["worst_grad"],
        "kernels_vs_plain_at_shard": at_shard,
        "tokens_equal": {n: all(r[n]["tokens"] == one[n] for r in ranks)
                         for n, _, _ in PAR_DECODES},
        "launches_per_rank": {n: rank0[n]["launches"]
                              for n in ("ce", "kd", *(d[0] for d in PAR_DECODES))},
        "bf16_shared_card": {
            "label": "four ranks sharing one card over gloo: not a scaling figure",
            "ms_per_step": [r["bf16"]["ms_per_step"] for r in ranks],
            "ms_per_decode_batch": [r["bf16"]["ms_per_batch"] for r in ranks],
            "losses": rank0["bf16"]["losses"]},
        "nccl_1x1": one_by_one, "dryrun": dry,
        "seconds": {"reference": t_ref, "ranks": t_ranks, "nccl": t_nccl, "dryrun": t_dry,
                    "total": time.perf_counter() - t_phase},
    }
    emit(row)
    if failures:
        raise AssertionError("parallel: " + "; ".join(failures))
    return row


# -- 20. the last modules: native helpers, Adafactor, remat policies,
# SpecAugment on the device, the examples ---------------------------------------

# the flagship TransKD rung (the probe's third) and the small-model sizes;
# ``phase_outer(torch, device="cpu", sizes=OUTER_DEBUG)`` rehearses on the CPU
OUTER_SIZES = dict(teacher="large-v2", student="large-v2", kd_batch=2, kd_steps=3,
                   model="small", batch=BATCH, fp32_batch=2, timed_steps=5,
                   adafactor_seeds=(0, 1), spec_frames=3000, examples_model="small",
                   synthetic=8, demo_rows=2)
OUTER_DEBUG = dict(teacher="debug", student="debug", kd_batch=1, kd_steps=1,
                   model="debug", batch=2, fp32_batch=1, timed_steps=1,
                   adafactor_seeds=(0,), spec_frames=300, examples_model="debug",
                   synthetic=2, demo_rows=2)


def _count_decoder_calls(decoding):
    """Count ``decoding.decoder_apply`` calls (a prefill or an incremental
    step each); returns (counter dict, restore)."""
    calls = {"n": 0}
    original = decoding.decoder_apply

    def counted(*args, **kwargs):
        calls["n"] += 1
        return original(*args, **kwargs)

    decoding.decoder_apply = counted

    def restore():
        decoding.decoder_apply = original

    return calls, restore


def _outer_kernels_vs_plain(torch, device, sizes):
    """Each kernel phase 20's paths run, against its plain version on the
    same inputs at those paths' shapes, with the tolerances of phases 1 and
    3: flash64's forward (and its lse forward) at the flagship teacher's
    (batch * H, 1500, 64); the decode-attention step on the examples'
    model at demo's rows, greedy's two with per-row offsets and beam's
    with one shared offset, the caches equal. Returns (rows, failures)."""
    import whisper_flamingo_tpu_torch as wt
    from whisper_flamingo_tpu_torch.ops import decode_attn, flash64

    gen = torch.Generator(device=device).manual_seed(20)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=device)  # noqa: E731
    out, failures = [], []

    def check(row, ok):
        out.append(row)
        if not ok:
            failures.append(f"{row['kernel']} vs plain on phase 20's path: {row}")

    tdims = wt.MODEL_DIMS[sizes["teacher"]]
    b, h, t = sizes["kd_batch"], tdims.n_audio_head, tdims.n_audio_ctx
    for dtype_name, tol, lse_tol in (("bfloat16", 1e-2, 2e-2), ("float32", 1e-5, 1e-5)):
        dtype = getattr(torch, dtype_name)
        q, k = ((randn(b, h, t, 64) * 64 ** -0.25).to(dtype) for _ in range(2))
        v = randn(b, h, t, 64).to(dtype)
        o = flash64.flash64_forward(q, k, v)
        o_lse, lse = flash64.flash64_forward(q, k, v, with_lse=True)
        o_ref, lse_ref = flash64.flash64_forward_plain(q, k, v, with_lse=True)
        row = {"kernel": "flash64", "dtype": dtype_name, "shape": [b * h, t, 64],
               "o_max_abs_err": max_err(o, o_ref), "o_tol": tol,
               "lse_o_max_abs_err": max_err(o_lse, o_ref), "lse_o_tol": lse_tol,
               "lse_max_abs_err": max_err(lse, lse_ref), "lse_tol": 1e-4}
        check(row, torch.isfinite(o).all().item() and row["o_max_abs_err"] <= tol
              and row["lse_o_max_abs_err"] <= lse_tol and row["lse_max_abs_err"] <= 1e-4)

    dims = wt.MODEL_DIMS[sizes["examples_model"]]
    heads, d, t_max = dims.n_text_head, dims.n_text_state, dims.n_text_ctx
    rows = sizes["demo_rows"]
    for dtype_name, tol in (("bfloat16", 2e-2), ("float32", 1e-5)):
        dtype = getattr(torch, dtype_name)
        for n, mode in ((rows, "per_row"), (rows * BEAM, "scalar")):
            q, kn, vn = (randn(n, 1, d).to(dtype) for _ in range(3))
            kc, vc = ((randn(n, t_max, d) * 0.5).to(dtype) for _ in range(2))
            if mode == "scalar":
                offset = SAMPLE_LEN + 2
            else:
                offset = torch.randint(0, t_max, (n,), generator=gen, device=device,
                                       dtype=torch.int32)
            kc2, vc2 = kc.clone(), vc.clone()
            got, _, _ = decode_attn.fused_step(q, kn, vn, kc, vc, offset, heads)
            ref = decode_attn.fused_step_plain(q, kn, vn, kc2, vc2, offset, heads)
            err, cache_err = max_err(got, ref), max(max_err(kc, kc2), max_err(vc, vc2))
            check({"kernel": "decode_attn", "dtype": dtype_name, "cache": [n, t_max, d],
                   "heads": heads, "offset": mode, "max_abs_err": err,
                   "cache_max_abs_err": cache_err, "tol": tol},
                  torch.isfinite(got).all().item() and err <= tol and cache_err == 0.0)
    if device != "cpu":
        torch.cuda.synchronize()
    return out, failures


def phase_outer(torch, device="cuda", sizes=OUTER_SIZES):
    """20: the native helpers, the flagship TransKD rung with Adafactor and
    AdamW, the remat policies, Adafactor at fp32 through the kernels and
    the plain versions, SpecAugment on the device, and the examples (see
    the module docstring). On the CPU no kernel launches."""
    import gc

    import numpy as np

    import whisper_flamingo_tpu_torch as wt
    from whisper_flamingo_tpu_torch import decoding, metrics, native
    from whisper_flamingo_tpu_torch.data import noise
    from whisper_flamingo_tpu_torch.examples import demo, eval_table
    from whisper_flamingo_tpu_torch.models.whisper import decoder_apply, encoder_apply
    from whisper_flamingo_tpu_torch.ops import decode_attn, flash64
    from whisper_flamingo_tpu_torch.ops import spec_augment as sa
    from whisper_flamingo_tpu_torch.tools import transkd_flagship_probe as probe
    from whisper_flamingo_tpu_torch.training.optim import whisper_optimizer
    from whisper_flamingo_tpu_torch.training.steps import (
        TrainState, ce_loss, make_ce_train_step, to_device)

    cuda = torch.device(device).type == "cuda"
    per_launch = 1 if cuda else 0  # the CPU runs the plain versions: no launches
    out = {}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # (a) the native helpers: built, one mix, one edit distance
    if not native.AVAILABLE:
        raise AssertionError(f"native: the C helpers did not build ({native.lib_path()})")
    rng = np.random.default_rng(0)
    clean = rng.standard_normal(48000).astype(np.float32) * 3000
    babble = rng.standard_normal(20000).astype(np.float32) * 3000
    mixed = noise.add_noise(clean, [babble], 5.0, np.random.default_rng(1))
    helper = native.mix_noise(clean, babble, 5.0).astype(np.int16)
    hyp, ref = "the cat sat on the mat".split(), "a cat sat on the red mat today".split()
    ed_native = metrics.edit_distance(hyp, ref)
    native.AVAILABLE = False
    try:
        ed_python = metrics.edit_distance(hyp, ref)
    finally:
        native.AVAILABLE = True
    out["native"] = {"available": True, "library": os.path.relpath(native.lib_path(), ROOT),
                     "mix_equals_helper": bool(np.array_equal(mixed, helper)),
                     "edit_distance": [ed_native, ed_python]}
    emit({"phase": "outer_native", **out["native"]})
    if not out["native"]["mix_equals_helper"] or ed_native != ed_python:
        raise AssertionError(f"native: {out['native']}")

    # the kernels at the shapes of this phase's paths, against their plain versions
    rows, failures = _outer_kernels_vs_plain(torch, device, sizes)
    out["kernels_vs_plain"] = rows
    emit({"phase": "outer_kernels_vs_plain", "cases": rows})
    if failures:
        raise AssertionError("; ".join(failures))

    # (b) the flagship TransKD rung, Adafactor then AdamW, each in a subprocess
    t_name, s_name, kd_b = sizes["teacher"], sizes["student"], sizes["kd_batch"]
    tdims = wt.MODEL_DIMS[t_name]
    extra = [f"--steps={sizes['kd_steps']}", "--warmup=1"] + ([] if cuda else ["--device=cpu"])
    out["flagship"] = {}
    for opt in ("adafactor", "adamw"):
        res = probe.run_subprocess(t_name, s_name, kd_b, opt, extra, timeout=600)
        if "error" in res:
            raise AssertionError(f"flagship {opt}: {res['error']}")
        want = per_launch * tdims.n_audio_layer  # the teacher's encoder; the student shares it
        row = {k: res[k] for k in ("step_ms", "resident_gb", "peak_gb", "optimizer_state_bytes",
                                   "optimizer_ms", "optimizer_ms_all", "trainable_params",
                                   "flash64_fwd_launches_per_step", "flash64_shape",
                                   "share_feats", "losses", "teacher_unchanged",
                                   "student_encoder_unchanged", "device")}
        out["flagship"][opt] = row
        emit({"phase": f"outer_flagship_{t_name}_{s_name}_b{kd_b}_{opt}", **row})
        if not (res["losses_finite"] and res["teacher_unchanged"]
                and res["student_encoder_unchanged"]
                and res["flash64_fwd_launches_per_step"] == want):
            raise AssertionError(f"flagship {opt}: {res} (flash64 launches expected {want})")

    # (c) the remat policies on the train bench protocol
    batch = _train_batch(np, sizes["batch"])
    out["remat"] = {}
    for remat in ("none", "full", "dots"):
        gc.collect()  # earlier phases' unreachable tensors would count in the peak
        base = 0
        if cuda:
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
        model = wt.load_model(sizes["model"], device=device, seed=0)
        n_layer = model.dims.n_audio_layer
        tx, _ = whisper_optimizer(model, 1e-5, total_steps=1000)
        step = make_ce_train_step(model.dims, dtype=torch.bfloat16, remat=remat)
        state = TrainState.create(model, tx)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            state, m = step(state, batch)
        flash64.flash64_forward.lse_launches = flash64.flash64_backward.launches = 0
        state, m = step(state, batch)
        sync()
        launches = {"fwd_lse": flash64.flash64_forward.lse_launches,
                    "bwd": flash64.flash64_backward.launches}
        times, losses = [], [m["loss"].item()]
        for _ in range(sizes["timed_steps"]):
            sync()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(m["loss"].item())
        want = {"fwd_lse": per_launch * n_layer * (1 if remat == "none" else 2),
                "bwd": per_launch * n_layer}
        row = {"ms_per_step": float(np.median(times)), "step_ms_all": times,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
               "mem_before_gb": base / 1e9,
               "flash64_launches_per_step": launches, "losses": losses}
        out["remat"][remat] = row
        emit({"phase": f"outer_remat_{remat}_{sizes['model']}_b{sizes['batch']}", **row})
        if launches != want or not np.all(np.isfinite(losses)):
            raise AssertionError(f"remat {remat}: launches {launches} (expected {want}), {losses}")
        del model, tx, state, step
        if cuda:
            torch.cuda.empty_cache()

    # one fp32 step per policy through the kernels: the same bits. The
    # token embedding's gradient is an indexed accumulate, which CUDA sums
    # with atomics in any order unless deterministic algorithms are on.
    b32 = to_device(_train_batch(np, sizes["fp32_batch"]), device)
    model = wt.load_model(sizes["model"], device=device, seed=0)
    whisper_optimizer(model, 1e-5, total_steps=1000)  # marks every parameter trainable
    names = [n for n, _ in model.named_parameters()]
    got = {}
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for remat in ("none", "full", "dots"):
            feats = encoder_apply(model, model.dims, b32["input_ids"], dtype=torch.float32,
                                  remat=remat)
            logits, _ = decoder_apply(model, model.dims, b32["dec_input_ids"], feats,
                                      dtype=torch.float32, remat=remat)
            loss = ce_loss(logits, b32["labels"])
            loss.backward()
            got[remat] = (loss.detach(), [p.grad for p in model.parameters()])
            for p in model.parameters():
                p.grad = None
    finally:
        torch.use_deterministic_algorithms(deterministic)
    differ = {r: [n for n, a, b in zip(names, got[r][1], got["none"][1]) if not torch.equal(a, b)]
              for r in ("full", "dots")}
    same = {r: bool(torch.equal(got[r][0], got["none"][0])) and not differ[r]
            for r in ("full", "dots")}
    out["remat"]["fp32_equal_to_none"] = same
    emit({"phase": "outer_remat_fp32_equal", "equal_to_none": same,
          "loss": {r: got[r][0].item() for r in got}, "grads_differ": differ,
          "n_grads": len(names)})
    if not all(same.values()):
        raise AssertionError(f"remat: fp32 losses or gradients differ across policies {same}")
    del got, model

    # (d) Adafactor at fp32: one step through the kernels and through the
    # plain versions, on each seed. Loss and gradients are held to phase
    # 9's gates, the update to 1e-3 of its largest magnitude: Adafactor
    # scales each element by its row's and column's inverse RMS, so a
    # gradient error in a row of small gradients grows by that row's
    # factor. Two readings show it: at the worst update element, the
    # first-order error from its gradient's and its row's and column's
    # statistics' change against the update error measured; and the
    # kernel run's optimizer, given the plain run's gradients, must give
    # the plain run's update to rounding.
    def adafactor_step(seed, grads_in=None):
        model = wt.load_model(sizes["model"], device=device, seed=seed)
        tx, _ = whisper_optimizer(model, 1e-3, total_steps=1000, optimizer="adafactor")
        before = [p.detach().clone() for p in tx.params]
        loss, grads = None, []
        if grads_in is None:
            grads_of = tx._grads

            def capture():
                grads.extend(g.clone() for g in grads_of())
                return grads[-len(tx.params):]

            tx._grads = capture
            step = make_ce_train_step(model.dims, dtype=torch.float32, remat="full")
            _, m = step(TrainState.create(model, tx),
                        _train_batch(np, sizes["fp32_batch"], seed=seed))
            loss = m["loss"].item()
        else:  # the optimizer alone, on the given gradients
            for p, g in zip(tx.params, grads_in):
                p.grad = g.clone()
            tx.step()
        return loss, grads, [p.detach() - b for p, b in zip(tx.params, before)], tx

    def worst(names, got, want):
        return max(((i, n, max_err(a, b) / max(b.abs().max().item(), 1e-30))
                    for i, (n, a, b) in enumerate(zip(names, got, want))), key=lambda x: x[2])

    def explain(tx_k, tx_p, i, g_k, g_p, u_k, u_p):
        """The worst update element of parameter i: its gradient and that
        gradient's error, and for a factored parameter the RMS of its row
        and column (v_row, v_col: at step 0 the mean squares of the
        gradients along the two factored dims) against the leaf's largest,
        their relative change between the runs, and the first-order update
        error from the element's gradient, row, column and row mean."""
        diff = (u_k - u_p).abs()
        idx = tuple(int(j) for j in np.unravel_index(int(diff.argmax()), tuple(u_p.shape)))
        g, dg = g_p[idx].item(), g_k[idx].item() - g_p[idx].item()
        u_max = u_p.abs().max().item()
        row = {"index": list(idx), "grad": g, "grad_err_rel": abs(dg) / g_p.abs().max().item(),
               "update_err_rel": diff[idx].item() / u_max}
        if tx_p.factored[i] is None:
            return row
        rel = dg / g  # d log u = d log g - (d log v_row - d log mean) / 2 - d log v_col / 2
        r_dim, c_dim = tx_p.factored[i]
        for key, reduce in (("v_row", (r_dim,)), ("v_col", (c_dim,)),
                            ("v_row_mean", (r_dim, c_dim))):
            at = list(idx)
            for d in reduce:
                at[d] = 0
            v_k, v_p = (getattr(tx, key.replace("_mean", ""))[i] for tx in (tx_k, tx_p))
            if key == "v_row_mean":
                v_k, v_p = v_k.mean(c_dim, keepdim=True), v_p.mean(c_dim, keepdim=True)
            else:
                row[f"{key}_rms_rel"] = (v_p[tuple(at)].item() / v_p.max().item()) ** 0.5
            change = v_k[tuple(at)].item() / v_p[tuple(at)].item() - 1
            row[f"{key}_rel_change"] = change
            rel += (0.5 if key == "v_row_mean" else -0.5) * change
        row["first_order_update_err_rel"] = abs(u_p[idx].item() * rel) / u_max
        return row

    out["adafactor_fp32"] = []
    for seed in sizes["adafactor_seeds"]:
        loss_k, grad_k, upd_k, tx_k = adafactor_step(seed)
        saved = flash64.flash64_forward, flash64.flash64_backward
        flash64.flash64_forward = flash64.flash64_forward_plain
        flash64.flash64_backward = flash64.flash64_backward_plain
        try:
            loss_p, grad_p, upd_p, tx_p = adafactor_step(seed)
        finally:
            flash64.flash64_forward, flash64.flash64_backward = saved
        _, _, upd_c, _ = adafactor_step(seed, grads_in=grad_p)
        w_grad, w_upd = worst(tx_k.names, grad_k, grad_p), worst(tx_k.names, upd_k, upd_p)
        w_ctl = worst(tx_k.names, upd_c, upd_p)
        i = w_upd[0]
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        row = {"seed": seed, "loss_kernels": loss_k, "loss_plain": loss_p,
               "loss_rel_diff": loss_rel, "worst_grad": w_grad[1], "worst_grad_rel_err": w_grad[2],
               "worst_update": w_upd[1], "worst_update_rel_err": w_upd[2],
               "worst_update_element": explain(tx_k, tx_p, i, grad_k[i], grad_p[i], upd_k[i],
                                               upd_p[i]),
               "plain_grads_update_rel_err": w_ctl[2],
               "factored_params": sum(f is not None for f in tx_k.factored),
               "params": len(tx_k.names), "state_bytes": tx_k.state_bytes()}
        out["adafactor_fp32"].append(row)
        emit({"phase": f"outer_adafactor_fp32_kernel_vs_plain_seed{seed}", **row})
        if loss_rel > 1e-5 or w_grad[2] > 1e-4 or w_upd[2] > 1e-3 or w_ctl[2] > 1e-6:
            raise AssertionError(f"adafactor fp32: kernels vs plain {row}")
        del grad_k, grad_p, upd_k, upd_p, upd_c, tx_k, tx_p
        if cuda:
            torch.cuda.empty_cache()

    # (e) SpecAugment on the device against the CPU with the same draws
    p = sa.PRESETS["ls-double"]
    nb, nt = sizes["batch"], sizes["spec_frames"]
    gen = torch.Generator(device=device).manual_seed(0)
    frames = torch.tensor([nt, nt - 100, nt * 5 // 6, nt // 2, nt // 4, nt // 10, 90, 20][:nb],
                          device=device)
    x = torch.randn((nb, nt, 80), generator=gen, device=device)
    draws = sa.spec_augment_draws(gen, frames, 80, **p)
    on_dev = sa.spec_augment_apply(x, frames, draws)
    on_cpu = sa.spec_augment_apply(x.cpu(), frames.cpu(), draws.cpu())
    spec = {"bit_equal_cpu": bool(torch.equal(on_dev.cpu(), on_cpu)),
            "masked_share": float((on_cpu == 0).float().mean())}
    if cuda:
        spec["card_ms_per_batch"] = time_ms(lambda: sa.spec_augment_torch(gen, x, frames, **p), 20)
    xs, fs = x.cpu().numpy(), frames.cpu().numpy()
    host_rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for _ in range(3):
        for i in range(nb):
            sa.spec_augment_np(xs[i], int(fs[i]), rng=host_rng, **p)
    spec["host_np_ms_per_batch"] = (time.perf_counter() - t0) / 3 * 1e3
    out["spec_augment"] = spec
    emit({"phase": f"outer_spec_augment_b{nb}x{nt}x80", **spec})
    if not spec["bit_equal_cpu"]:
        raise AssertionError("spec_augment: the card's mask differs from the CPU's")

    # (f) the examples at full width; the launches' shapes are recorded, and
    # demo's decode steps must run at the shapes held against the plain
    # version above
    platform = [] if cuda else ["--platform", "cpu"]
    n_text = wt.MODEL_DIMS[sizes["examples_model"]].n_text_layer
    n_audio = wt.MODEL_DIMS[sizes["examples_model"]].n_audio_layer
    held = {tuple(r["cache"][:1] + r["cache"][2:] + [r["heads"]])
            for r in out["kernels_vs_plain"] if r["kernel"] == "decode_attn"}
    calls, restore = _count_decoder_calls(decoding)
    seen = _Launches(flash64, decode_attn)
    try:
        t0 = time.perf_counter()
        rows = eval_table.main([*platform, "--model-type", sizes["examples_model"],
                                "--beam-size", str(BEAM), "--synthetic", str(sizes["synthetic"]),
                                "--sample-len", str(SAMPLE_LEN), "--snrs", "1000,0",
                                "--langs", "en,ru"])
        sync()
        wall = time.perf_counter() - t0
        n_batches = 8  # 2 systems x 2 languages x 2 SNRs, one batch of --synthetic each
        steps_run = calls["n"] - n_batches
        got = seen.read(torch)
        launches = {"flash64": got["flash64_fwd"], "decode_attn": got["decode_attn"]}
        want = {"flash64": per_launch * n_audio * n_batches,
                "decode_attn": per_launch * n_text * steps_run}
        out["eval_table"] = {"rows": [[r[0], r[1], {str(k): v for k, v in r[2].items()}]
                                      for r in rows],
                             "wall_s": wall, "launches": launches, "incremental_steps": steps_run,
                             "shapes": got["shapes"]}
        emit({"phase": f"outer_eval_table_{sizes['examples_model']}_beam{BEAM}",
              **out["eval_table"]})
        if launches != want or len(rows) != 4:
            raise AssertionError(f"eval_table: launches {launches}, expected {want}")
        out["demo"] = {}
        for name, beam in (("greedy", []), ("beam15", ["--beam_size", str(BEAM)])):
            calls["n"] = 0
            seen.reset()
            t0 = time.perf_counter()
            drows = demo.main([*platform, "--model", sizes["examples_model"], *beam])
            sync()
            got = seen.read(torch)
            launches = {"flash64": got["flash64_fwd"], "decode_attn": got["decode_attn"]}
            want = {"flash64": per_launch * n_audio,
                    "decode_attn": per_launch * n_text * (calls["n"] - 1)}
            out["demo"][name] = {"wall_s": time.perf_counter() - t0, "launches": launches,
                                 "incremental_steps": calls["n"] - 1, "shapes": got["shapes"],
                                 "texts": [r["text"][:80] for r in drows if "text" in r]}
            emit({"phase": f"outer_demo_{sizes['examples_model']}_{name}", **out["demo"][name]})
            unheld = [sh for sh in got["shapes"]["decode_attn"] if tuple(sh) not in held]
            if launches != want or unheld or not all(np.isfinite(r["avg_logprob"])
                                                     for r in drows if "avg_logprob" in r):
                raise AssertionError(f"demo {name}: launches {launches}, expected {want}; "
                                     f"decode shapes not held against the plain version {unheld}")
    finally:
        seen.restore()
        restore()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    import whisper_flamingo_tpu_torch as wt
    from whisper_flamingo_tpu_torch.ops import (cuda_build, decode_attn, decode_mlp, dtw, flash64,
                                                xattn_step)
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
                    for n in ("flash64_fwd", "flash64_bwd", "flash64_fwd_probe",
                              "decode_attn", "mma_pair", "xattn_step")}})
    gen = torch.Generator(device="cuda").manual_seed(0)

    # -- 2, 3. kernels against their plain versions ---------------------------
    fl = phase_flash64(torch, flash64, gen)
    da8, da120 = phase_decode_attn(torch, decode_attn, gen)
    phase_decode_attn_rows(torch, decode_attn, gen)
    xa = phase_xattn_step(torch, xattn_step, gen)

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

    # -- 17. the text conditioner and the text recipes -------------------------
    text = phase_text_conditioner(torch)
    mark("17")

    # -- 18. the audio-visual path and the legacy modules ----------------------
    phase_av(torch)
    mark("18")

    # -- 19. data and tensor parallelism ---------------------------------------
    phase_parallel(torch)
    mark("19")

    # -- 20. native helpers, Adafactor, remat policies, SpecAugment, examples --
    phase_outer(torch)
    mark("20")

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
        # the variant kernels alone (the probe's csbound call also runs kmax)
        entry("flash64_fwd_augv", "whisper_flamingo_tpu_torch/csrc/flash64_fwd_probe.cu",
              "tools/flash64_fwd_probe.py:102", fv["augv"]["launches"],
              {**fv["augv"], "ms": fv["augv"]["alone_ms"]}),
        entry("flash64_fwd_csbound", "whisper_flamingo_tpu_torch/csrc/flash64_fwd_probe.cu",
              "tools/flash64_fwd_probe.py:102", fv["csbound+augv"]["launches"],
              {**fv["csbound+augv"], "ms": fv["csbound+augv"]["alone_ms"]}),
        entry("mma_pair", "whisper_flamingo_tpu_torch/csrc/mma_pair.cu",
              "tools/packed_probe2.py:53", mp["launches"], mp),
        # no TPU kernel: the JAX package left this attention to XLA; replayed
        # by the step graphs, so its launches are the profiler's count over
        # phase 17's bf16 beam-15 evaluate
        entry("xattn_step", "whisper_flamingo_tpu_torch/csrc/xattn_step.cu", None,
              text["evaluate"]["beam15_bf16"]["launches"]["xattn_step"], xa),
    ]
    emit({"phase": "summary", "total_s": time.perf_counter() - t_start, "phase_s": seconds})
    print(smi_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
