"""Offline batch decoding: fixed batches of 30 s clips (with their text
streams for a gated model) through the conditioner, the mel front end and
``DecodingTask.run``, back to back.

Traffic keys: ``batch`` clips of ``audio_seconds`` of ``audio_std`` N(0, 1)
audio; ``pool`` distinct batches made from the seed and used in turn;
``decoding`` (``beam_size`` or greedy, ``sample_len``, ``language``,
``suppress_eot``: EOT suppressed so that random weights decode the whole
budget); ``conditioner`` (``streams`` text streams of ``batch`` texts whose
token lengths spread evenly over [``min_tokens``, ``max_tokens``], shuffled
by the seed: every batch pads to the same length, so every seed does the
same work). A unit is one batch; the window ends at the first batch
boundary at or after ``--seconds``.

After the window each distinct batch it decoded runs once more through the
same ``DecodingTask``, keeping at every step the program's filtered logits
of the beam whose prefix is the row the window returned (a prefix on no
beam marks the step). The check runs the plain reference over each of those
rows, teacher-forced, and compares per token:

- ``logit_rel_err_rms``: at each position, the norm of the program's
  log-probabilities less the reference's over the allowed vocabulary, less
  its mean (the constant that softmax ignores), over the norm of the
  reference's about its mean; the root mean square over every position of
  every row checked. A step whose prefix was on no beam, or whose allowed
  vocabulary differs, reads infinite;
- ``rows_unlike_first``: the rows of the window's later decodes of a batch
  that differ from its first (an exact comparison).

Notes: the token's own log-probability gap (root mean square over the
positions), and the row score's gap per token as the decode returns it
(``avg_logprob`` x (tokens + 1)).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import flops as F
from ..reference import bert_ref, mel_ref, whisper_ref
from . import common

SAMPLE_RATE = 16000


class Driver:
    def __init__(self, cfg, traffic, seed, rec, device, control=False, seconds=0.0, units=0):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.seconds, self.units = seconds, units
        self.rec, self.device, self.control = rec, torch.device(device), control
        self.dec = traffic["decoding"]
        self.streams = int(traffic.get("conditioner", {}).get("streams", 0))
        self.batch = int(traffic["batch"])

    # -- set-up ---------------------------------------------------------------

    def _inputs(self):
        t = self.traffic
        rng = np.random.default_rng(self.seed)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        samples = int(t["audio_seconds"] * SAMPLE_RATE)
        pool = []
        for _ in range(int(t["pool"])):
            item = {"audio": common.audio_batch(gen, self.batch, samples, t["audio_std"],
                                                self.device)}
            if self.streams:
                c = t["conditioner"]
                lengths = common.stratified(c["min_tokens"], c["max_tokens"], self.batch)
                item["texts"] = [common.texts_of_lengths(rng, rng.permutation(lengths))
                                 for _ in range(self.streams)]
            pool.append(item)
        return pool

    def setup(self) -> None:
        from whisper_flamingo_tpu_torch.decoding import DecodingOptions, DecodingTask

        cfg, dec = self.cfg, self.dec
        self.model = common.build_whisper(cfg, self.seed, self.device)
        self.cond = common.build_conditioner(cfg, self.seed, self.device) if self.streams else None
        self.pool = self._inputs()
        self.options = DecodingOptions(
            language=dec["language"], without_timestamps=True,
            beam_size=dec.get("beam_size"), sample_len=dec["sample_len"],
            suppress_tokens=self._suppressed(),
            fp16=cfg["dtype"] == "bfloat16",
        )
        self.task = DecodingTask(self.model, self.options)
        self._unit(0)  # the cell's only shapes: kernels built, weights prepared
        common.sync(self.device)

    def _suppressed(self) -> list:
        """The ids suppressed at every step, listed so that the reference
        can remove the same ones: the special tokens, and EOT under
        ``suppress_eot``."""
        tok = self.cfg["tokens"]
        keep_eot = not self.dec.get("suppress_eot")
        return [t for t in tok["always_suppressed"] if not (keep_eot and t == tok["eot"])]

    # -- the window ------------------------------------------------------------

    def _unit(self, i: int):
        from whisper_flamingo_tpu_torch.audio import log_mel_spectrogram

        item = self.pool[i % len(self.pool)]
        rec = self.rec
        xt = None
        if self.cond is not None:
            with rec.host_span("conditioner"):
                xt = self.cond.encode_multi(item["texts"])
        with rec.range("mel"):
            mel = log_mel_spectrogram(item["audio"], device=self.device)
        with rec.range("decode"):
            return self.task.run(mel, xt=xt)

    def run_window(self) -> dict:
        from ..instrument import instrument

        rec, seconds, units = self.rec, self.seconds, self.units
        self.done = []
        with instrument(rec), rec.profiling():
            t0 = time.perf_counter()
            with rec.range("window"):
                while True:
                    res = self._unit(len(self.done))
                    self.done.append([(list(r.tokens), float(r.avg_logprob)) for r in res])
                    elapsed = time.perf_counter() - t0
                    if (units and len(self.done) >= units) or (not units and elapsed >= seconds):
                        break
            window_s = time.perf_counter() - t0  # the results are on the host: synchronised
        n = len(self.done)
        want = self.dec["sample_len"] if self.dec.get("suppress_eot") else None
        failed = sum(1 for rows in self.done for toks, _ in rows
                     if not toks or (want is not None and len(toks) != want))
        audio_s = n * self.batch * self.traffic["audio_seconds"]
        return {"window_s": window_s, "units": n, "attempted": n * self.batch, "failed": failed,
                "flops": n * self.unit_flops(),
                "e2e": {"audio_s_per_s": audio_s / window_s}}

    def unit_flops(self) -> float:
        """Operations of one batch: conditioner, encoder, static K/V, the
        prefill and every incremental step of every beam row."""
        cfg, dims = self.cfg, self.cfg["dims"]
        b, g = self.batch, int(self.dec.get("beam_size") or 1)
        init_len = len(cfg["tokens"]["sot_sequence_notimestamps"])
        s = 0
        total = 0.0
        if self.streams:
            s = max(len(bert_ref.tokenize(t, int(cfg["bert"]["vocab_size"]),
                                          cfg["bert_max_length"], cfg["bert_pad_multiple"])[0][0])
                    for t in self.pool[0]["texts"])
            total += self.streams * F.bert_flops(cfg["bert"], b, s)
        total += b * F.encoder_flops(dims)
        total += b * F.static_kv_flops(dims, self.streams, s, cfg["extras"].get("bert_dim", 0))
        total += b * F.decode_flops(dims, range(init_len), self.streams, s)
        max_len = init_len + self.dec["sample_len"]
        total += b * g * F.decode_flops(dims, range(init_len, max_len - 1), self.streams, s)
        return total

    def release(self) -> None:
        """Replay what the check needs from the program (the control
        replaces the program and needs nothing), then free it."""
        if not self.control:
            self.replays = self._replay()
        del self.task, self.model, self.cond
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def _replay(self) -> dict:
        """Each distinct batch the window decoded, run once more through the
        same ``DecodingTask``. By pool index: the program's filtered fp32
        logits (rows, steps, V) along the beam whose prefix is the row the
        window first returned, and a (rows, steps) mask of the steps at
        which such a beam was there."""
        from unittest import mock

        from whisper_flamingo_tpu_torch import decoding
        from whisper_flamingo_tpu_torch.audio import log_mel_spectrogram

        b, g = self.batch, int(self.dec.get("beam_size") or 1)
        init = list(self.cfg["tokens"]["sot_sequence_notimestamps"])
        apply_filters = decoding._apply_filters
        rows_ix = torch.arange(b, device=self.device)
        out = {}
        for p, item in enumerate(self.pool):
            if p >= len(self.done):
                break
            seqs = [init + toks for toks, _ in self.done[p]]
            target = torch.full((b, max(map(len, seqs))), -1, dtype=torch.long)
            for r, seq in enumerate(seqs):
                target[r, : len(seq)] = torch.tensor(seq)
            target = target.to(self.device)
            kept = []

            def recording(cfg, logits, tokens, cur_len):
                filtered = apply_filters(cfg, logits, tokens, cur_len)
                n = min(cur_len, target.shape[1])
                hit = (tokens[:, :n].reshape(b, g, n) == target[:, None, :n]).all(-1)
                beam = hit.int().argmax(1)  # the first beam that holds the prefix
                kept.append((filtered.view(b, g, -1)[rows_ix, beam], hit.any(1)))
                return filtered

            xt = self.cond.encode_multi(item["texts"]) if self.cond is not None else None
            mel = log_mel_spectrogram(item["audio"], device=self.device)
            with mock.patch.object(decoding, "_apply_filters", recording):
                self.task.run(mel, xt=xt)
            out[p] = (torch.stack([k[0] for k in kept], 1), torch.stack([k[1] for k in kept], 1))
        return out

    # -- the check ---------------------------------------------------------------

    @torch.no_grad()
    def check(self, limits: dict) -> list:
        """The per-token numbers of the module's docstring, over every row
        of every distinct batch the window decoded. Under
        ``control="fp8"`` the reference computed in fp8 stands in the
        program's place over the same tokens."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg, dims = self.cfg, self.cfg["dims"]
        sd = common.whisper_state(cfg, self.seed, self.device)
        bsd = common.bert_state(cfg, self.seed, self.device) if self.streams else None
        rel, tok_gaps, row_gaps, unlike = [], [], [], 0
        for p, item in enumerate(self.pool):
            units = [u for u in range(len(self.done)) if u % len(self.pool) == p]
            if not units:
                continue
            first = self.done[units[0]]
            unlike += sum(self.done[u][r][0] != first[r][0]
                          for u in units[1:] for r in range(self.batch))
            mel = mel_ref.log_mel(item["audio"], dims["n_mels"])
            xt = None
            if self.streams:
                xt = bert_ref.encode_streams(bsd, cfg["bert"], item["texts"],
                                             cfg["bert_max_length"], cfg["bert_pad_multiple"],
                                             self.device)
            for r, (toks, avg_lp) in enumerate(first):
                n = len(toks)
                args = (sd, mel[r: r + 1], None if xt is None else xt[:, r: r + 1], toks)
                ref = self._logprobs(*args, None)
                if self.control:
                    got, found = self._logprobs(*args, "fp8"), torch.ones(n, dtype=torch.bool)
                    score = None
                else:
                    logits, hit = self.replays[p]
                    got = torch.log_softmax(logits[r, :n], dim=-1)
                    found, score = hit[r, :n].cpu(), avg_lp * (n + 1)
                served = torch.tensor(toks, device=self.device)[:, None]
                ref_tok = ref.gather(1, served)[:, 0].double()
                got_tok = got.gather(1, served)[:, 0].double()
                err = relative_error(got, ref).cpu()
                rel.append(torch.where(found, err, torch.full_like(err, float("inf"))))
                tok_gaps.append((got_tok - ref_tok).abs().cpu())
                score = float(got_tok.sum()) if score is None else score
                row_gaps.append(abs(score - float(ref_tok.sum())) / max(n, 1))
        del sd, bsd
        self.replays = None
        rel, tok_gaps = torch.cat(rel).double(), torch.cat(tok_gaps)
        self.numbers = {
            "logit_rel_err_rms": float(rel.square().mean().sqrt()),
            "rows_unlike_first": float(unlike),
            "token_logprob_gap_rms": float(tok_gaps.square().mean().sqrt()),
            "row_logprob_gap_rms": float(np.sqrt(np.mean(np.square(row_gaps)))),
            "logit_rel_err_max": float(rel.max()),
            "rows_checked": len(row_gaps),
        }
        return [(name, self.numbers[name], limit) for name, limit in limits.items()]

    def notes(self) -> dict:
        return self.numbers

    def _logprobs(self, sd, mel, xt, toks, lowp) -> torch.Tensor:
        """The reference's filtered log-probabilities (tokens, V) at each
        position of ``toks`` after the initial tokens."""
        dims, tok = self.cfg["dims"], self.cfg["tokens"]
        init = list(tok["sot_sequence_notimestamps"])
        feats = whisper_ref.encoder(sd, dims, mel, lowp)
        if xt is not None:
            xt = whisper_ref.prepare_streams(sd, xt, lowp)
        seq = torch.tensor([init + toks[:-1]], dtype=torch.long, device=self.device)
        logits = whisper_ref.decoder_logits(sd, dims, seq, feats, xt, lowp)[:, len(init) - 1:]
        return whisper_ref.filtered_logprobs(logits, self._suppressed(), tok["blank"], 0)[0]


def relative_error(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per position of (tokens, V) log-probabilities: the norm of ``got`` -
    ``ref`` about its mean over the allowed (finite) vocabulary, over the
    norm of ``ref`` about its mean; infinite where the allowed sets differ."""
    keep = torch.isfinite(ref)
    n = keep.sum(-1, keepdim=True)

    def centred(x):
        x = torch.where(keep, x.double(), 0.0)
        return torch.where(keep, x - x.sum(-1, keepdim=True) / n, 0.0)

    err = centred(got - ref).norm(dim=-1) / centred(ref).norm(dim=-1)
    return torch.where((keep == torch.isfinite(got)).all(-1), err, torch.full_like(err, float("inf")))
