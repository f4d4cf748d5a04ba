"""Offline audio-visual decoding: length-sorted batches of lip-video clips
through ``AVWhisper``'s decode entry (the AV-HuBERT trunk over the video,
the mel and the Whisper encoder over the audio, the gated beam decode),
back to back.

Traffic keys: ``clips`` clip lengths spread evenly over ``clip_seconds``,
sorted and cut into batches of ``batch`` (fairseq's length-ordered
evaluation batches); each clip ``audio_std`` N(0, 1) audio for its own
length, zero to 30 s for the mel, and ``fps`` x its length frames of
seeded lip crops of the configuration's ``video`` size, pixels uniform in
0..255 normalised as the dataset does, each batch's video padded with
zeros to its longest clip (as ``recipes/decode_av`` pads it); ``decoding``
(``beam_size``, ``sample_len``, ``language``, ``suppress_eot``). The seed
picks the batches' order and every value, so every seed does the same
work. A unit is one batch; the window ends at the first batch boundary at
or after ``--seconds``. ``audio_s_per_s`` counts each clip's own seconds.

Set-up decodes every batch once, so that every shape the window meets is
warm (the trunk at each batch's length, the step graphs).

After the window each distinct batch it decoded runs once more through
``AVWhisper``'s decode entry, keeping the program's trunk features and, at
every step, the filtered logits of the beam whose prefix is the row the
window returned, as ``offline_decode`` replays. The check runs the plain
reference (``reference.avhubert_ref`` for the trunk over each clip's padded
video, ``reference.whisper_ref`` for the rest) and compares:

- ``logit_rel_err_rms``: per token of every returned row, as in
  ``offline_decode``;
- ``trunk_rel_err``: per batch, the norm of the program's trunk features
  less the reference's over the norm of the reference's, every frame of
  the batch's padded video; the largest over the batches;
- ``rows_unlike_first``: rows of a batch's later decodes that differ from
  its first.

In traced runs this generator opens its own ranges ``mel``, ``trunk`` (around
``avhubert_encoder_apply``, looked up at call time by ``AVWhisper``) and
``decode``, and installs the program's span sink over the window: the
window's ``decode.graph_captures`` and frame counters go to the stats.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import av_flops
from .. import flops as F
from .. import weights
from ..reference import avhubert_ref, mel_ref, whisper_ref
from . import common
from .offline_decode import relative_error

SAMPLE_RATE = 16000
TRUNK_SALT = 2


def trunk_state(cfg: dict, seed: int, device):
    return weights.make_state(avhubert_ref.trunk_spec(cfg["trunk"]), seed, device, TRUNK_SALT)


def build_av(cfg: dict, seed: int, device):
    """The port's ``AVWhisper`` over the benchmark's weights: the gated
    Whisper (fp32 masters, the configuration's compute dtype) and the
    trunk of the configuration's shape."""
    from whisper_flamingo_tpu_torch.models.avhubert import (
        AVWhisper,
        VideoEncoder,
        VideoEncoderConfig,
    )

    whisper = common.build_whisper(cfg, seed, device)
    whisper.dtype = common.DTYPES[cfg["dtype"]]
    with torch.device(device):
        trunk = VideoEncoder(VideoEncoderConfig(**cfg["trunk"])).to(device)
    state = trunk_state(cfg, seed, device)
    missing, unexpected = trunk.load_state_dict(state, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
        raise KeyError(f"trunk weights do not match: {missing[:4]} {unexpected[:4]}")
    del state
    return AVWhisper(whisper=whisper, video=trunk.eval())


class Driver:
    def __init__(self, cfg, traffic, seed, rec, device, control=False, seconds=0.0, units=0):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.seconds, self.units = seconds, units
        self.rec, self.device, self.control = rec, torch.device(device), control
        self.dec = traffic["decoding"]
        self.batch = int(traffic["batch"])

    # -- set-up ---------------------------------------------------------------

    def _pool(self):
        """The batches: clip lengths (s) spread evenly, sorted, cut into
        batches; audio and video drawn on the device from the seed."""
        t, v = self.traffic, self.cfg["video"]
        lo, hi = t["clip_seconds"]
        secs = sorted(lo + (hi - lo) * i / (t["clips"] - 1) for i in range(t["clips"]))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        pool = []
        for start in range(0, len(secs), self.batch):
            clip_s = secs[start: start + self.batch]
            samples = [int(round(s * SAMPLE_RATE)) for s in clip_s]
            frames = [int(round(s * t["fps"])) for s in clip_s]
            audio = common.audio_batch(gen, len(clip_s), 30 * SAMPLE_RATE, t["audio_std"],
                                       self.device)
            keep = torch.arange(audio.shape[1], device=self.device)[None] < torch.tensor(
                samples, device=self.device)[:, None]
            pixels = torch.randint(0, 256, (len(clip_s), max(frames), v["height"], v["width"]),
                                   generator=gen, device=self.device)
            video = (pixels.float() / 255.0 - v["pixel_mean"]) / v["pixel_std"]
            real = torch.arange(max(frames), device=self.device)[None] < torch.tensor(
                frames, device=self.device)[:, None]
            pool.append({"audio": audio * keep, "video": video * real[:, :, None, None],
                         "frames": frames, "seconds": float(sum(clip_s))})
        order = np.random.default_rng(self.seed).permutation(len(pool))
        return [pool[i] for i in order]

    def setup(self) -> None:
        from whisper_flamingo_tpu_torch.decoding import DecodingOptions

        cfg, dec = self.cfg, self.dec
        self.av = build_av(cfg, self.seed, self.device)
        self.pool = self._pool()
        self.options = DecodingOptions(
            language=dec["language"], without_timestamps=True,
            beam_size=dec.get("beam_size"), sample_len=dec["sample_len"],
            suppress_tokens=self._suppressed(), fp16=cfg["dtype"] == "bfloat16",
        )
        for i in range(len(self.pool)):  # every shape of the cell
            self._unit(i)
        common.sync(self.device)

    def _suppressed(self) -> list:
        tok = self.cfg["tokens"]
        keep_eot = not self.dec.get("suppress_eot")
        return [t for t in tok["always_suppressed"] if not (keep_eot and t == tok["eot"])]

    # -- the window ------------------------------------------------------------

    def _unit(self, i: int):
        from whisper_flamingo_tpu_torch.audio import log_mel_spectrogram

        item = self.pool[i % len(self.pool)]
        with self.rec.range("mel"):
            mel = log_mel_spectrogram(item["audio"], device=self.device)
        with self.rec.range("decode"):
            return self.av.decode(mel, self.options, video=item["video"],
                                  video_lengths=item["frames"])

    @contextlib.contextmanager
    def _trunk_range(self):
        """``trunk`` around the program's trunk, in traced runs."""
        if not self.rec.traced:
            yield
            return
        from whisper_flamingo_tpu_torch.models import avhubert

        orig = avhubert.avhubert_encoder_apply

        def wrapped(*args, **kwargs):
            with self.rec.range("trunk"):
                return orig(*args, **kwargs)

        avhubert.avhubert_encoder_apply = wrapped
        try:
            yield
        finally:
            avhubert.avhubert_encoder_apply = orig

    def run_window(self) -> dict:
        from whisper_flamingo_tpu_torch import profiling

        from ..instrument import instrument

        rec, seconds, units = self.rec, self.seconds, self.units
        self.done = []
        sink = profiling.collect() if rec.traced else contextlib.nullcontext()
        audio_s = 0.0
        with instrument(rec), self._trunk_range(), sink as spans, rec.profiling():
            t0 = time.perf_counter()
            with rec.range("window"):
                while True:
                    res = self._unit(len(self.done))
                    audio_s += self.pool[len(self.done) % len(self.pool)]["seconds"]
                    self.done.append([(list(r.tokens), float(r.avg_logprob)) for r in res])
                    elapsed = time.perf_counter() - t0
                    if (units and len(self.done) >= units) or (not units and elapsed >= seconds):
                        break
            window_s = time.perf_counter() - t0  # the results are on the host: synchronised
        n = len(self.done)
        want = self.dec["sample_len"] if self.dec.get("suppress_eot") else None
        failed = sum(1 for rows in self.done for toks, _ in rows
                     if not toks or (want is not None and len(toks) != want))
        stats = {"window_s": window_s, "units": n, "attempted": n * self.batch, "failed": failed,
                 "flops": sum(self.unit_flops(i) for i in range(n)),
                 "e2e": {"audio_s_per_s": audio_s / window_s}}
        if spans is not None:
            c = spans.counters
            stats["graph_captures"] = c.get("decode.graph_captures", 0)
            stats["notes"] = {k: c[k] for k in ("decode.graph_captures", "decode.graph_steps",
                                                "decode.eager_steps", "av.frames",
                                                "av.pad_frames") if k in c}
        return stats

    def unit_flops(self, i: int) -> float:
        """Operations of batch ``i``: the trunk over the padded video, the
        encoder, the static K/V (the video stream projected), the prefill
        and every incremental step of every beam row."""
        cfg, dims = self.cfg, self.cfg["dims"]
        item = self.pool[i % len(self.pool)]
        b, g = len(item["frames"]), int(self.dec.get("beam_size") or 1)
        s = max(item["frames"])
        init_len = len(cfg["tokens"]["sot_sequence_notimestamps"])
        max_len = init_len + self.dec["sample_len"]
        v = cfg["video"]
        total = b * av_flops.trunk_flops(cfg["trunk"], s, v["height"], v["width"])
        total += b * F.encoder_flops(dims)
        total += b * F.static_kv_flops(dims, 1, s, cfg["extras"]["bert_dim"])
        total += b * F.decode_flops(dims, range(init_len), 1, s)
        total += b * g * F.decode_flops(dims, range(init_len, max_len - 1), 1, s)
        return total

    def release(self) -> None:
        """Replay what the check needs from the program (the control
        replaces the program and needs nothing), then free it."""
        if not self.control:
            self.replays = self._replay()
        del self.av
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def _replay(self) -> dict:
        """Each distinct batch the window decoded, once more through the
        decode entry. By pool index: the program's trunk features, and its
        filtered logits (rows, steps, V) along the beam that holds each
        returned row, with the (rows, steps) mask of the steps where one
        did."""
        from unittest import mock

        from whisper_flamingo_tpu_torch import decoding
        from whisper_flamingo_tpu_torch.audio import log_mel_spectrogram
        from whisper_flamingo_tpu_torch.models import avhubert

        g = int(self.dec.get("beam_size") or 1)
        init = list(self.cfg["tokens"]["sot_sequence_notimestamps"])
        apply_filters = decoding._apply_filters
        trunk_apply = avhubert.avhubert_encoder_apply
        out = {}
        for p, item in enumerate(self.pool):
            if p >= len(self.done):
                break
            b = len(item["frames"])
            rows_ix = torch.arange(b, device=self.device)
            seqs = [init + toks for toks, _ in self.done[p]]
            target = torch.full((b, max(map(len, seqs))), -1, dtype=torch.long)
            for r, seq in enumerate(seqs):
                target[r, : len(seq)] = torch.tensor(seq)
            target = target.to(self.device)
            kept, feats = [], []

            def recording(cfg, logits, tokens, cur_len):
                filtered = apply_filters(cfg, logits, tokens, cur_len)
                n = min(cur_len, target.shape[1])
                hit = (tokens[:, :n].reshape(b, g, n) == target[:, None, :n]).all(-1)
                beam = hit.int().argmax(1)  # the first beam that holds the prefix
                kept.append((filtered.view(b, g, -1)[rows_ix, beam], hit.any(1)))
                return filtered

            def trunk(*args, **kwargs):
                feats.append(trunk_apply(*args, **kwargs))
                return feats[-1]

            mel = log_mel_spectrogram(item["audio"], device=self.device)
            with mock.patch.object(decoding, "_apply_filters", recording), \
                    mock.patch.object(avhubert, "avhubert_encoder_apply", trunk):
                self.av.decode(mel, self.options, video=item["video"],
                               video_lengths=item["frames"])
            out[p] = (torch.stack([k[0] for k in kept], 1), torch.stack([k[1] for k in kept], 1),
                      feats[0].float())
        return out

    # -- the check ---------------------------------------------------------------

    @torch.no_grad()
    def check(self, limits: dict) -> list:
        """The numbers of the module's docstring. Under ``control="fp8"``
        the reference computed in fp8 stands in the program's place over
        the same inputs and tokens."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = self.cfg
        sd = common.whisper_state(cfg, self.seed, self.device)
        tsd = trunk_state(cfg, self.seed, self.device)
        rel, tok_gaps, trunk_errs, unlike, rows = [], [], [], 0, 0
        lowp = "fp8" if self.control else None
        for p, item in enumerate(self.pool):
            units = [u for u in range(len(self.done)) if u % len(self.pool) == p]
            if not units:
                continue
            first = self.done[units[0]]
            unlike += sum(self.done[u][r][0] != first[r][0]
                          for u in units[1:] for r in range(len(first)))
            mel = mel_ref.log_mel(item["audio"], cfg["dims"]["n_mels"])
            ref_feats = torch.cat([avhubert_ref.trunk(tsd, cfg["trunk"], item["video"][r: r + 1])
                                   for r in range(len(first))])
            if self.control:
                got_feats = torch.cat([
                    avhubert_ref.trunk(tsd, cfg["trunk"], item["video"][r: r + 1], lowp)
                    for r in range(len(first))])
            else:
                got_feats = self.replays[p][2]
            trunk_errs.append(float((got_feats - ref_feats).double().norm()
                                    / ref_feats.double().norm()))
            for r, (toks, _) in enumerate(first):
                n, rows = len(toks), rows + 1
                ref = self._logprobs(sd, mel[r: r + 1], ref_feats[r: r + 1], toks, None)
                if self.control:
                    got = self._logprobs(sd, mel[r: r + 1], got_feats[r: r + 1], toks, lowp)
                    found = torch.ones(n, dtype=torch.bool)
                else:
                    logits, hit = self.replays[p][0], self.replays[p][1]
                    got = torch.log_softmax(logits[r, :n], dim=-1)
                    found = hit[r, :n].cpu()
                served = torch.tensor(toks, device=self.device)[:, None]
                gap = got.gather(1, served)[:, 0].double() - ref.gather(1, served)[:, 0].double()
                err = relative_error(got, ref).cpu()
                rel.append(torch.where(found, err, torch.full_like(err, float("inf"))))
                tok_gaps.append(gap.abs().cpu())
        del sd, tsd
        self.replays = None
        rel, tok_gaps = torch.cat(rel).double(), torch.cat(tok_gaps)
        self.numbers = {
            "logit_rel_err_rms": float(rel.square().mean().sqrt()),
            "trunk_rel_err": max(trunk_errs),
            "rows_unlike_first": float(unlike),
            "token_logprob_gap_rms": float(tok_gaps.square().mean().sqrt()),
            "logit_rel_err_max": float(rel.max()),
            "rows_checked": rows,
        }
        return [(name, self.numbers[name], limit) for name, limit in limits.items()]

    def notes(self) -> dict:
        return self.numbers

    def _logprobs(self, sd, mel, feats, toks, lowp) -> torch.Tensor:
        """The reference's filtered log-probabilities (tokens, V) at each
        position of ``toks`` after the initial tokens, the trunk's
        ``feats`` (1, T, D) the gated stream."""
        dims, tok = self.cfg["dims"], self.cfg["tokens"]
        init = list(tok["sot_sequence_notimestamps"])
        audio = whisper_ref.encoder(sd, dims, mel, lowp)
        xt = whisper_ref.prepare_streams(sd, feats[None], lowp)
        seq = torch.tensor([init + toks[:-1]], dtype=torch.long, device=self.device)
        logits = whisper_ref.decoder_logits(sd, dims, seq, audio, xt, lowp)[:, len(init) - 1:]
        return whisper_ref.filtered_logprobs(logits, self._suppressed(), tok["blank"], 0)[0]
