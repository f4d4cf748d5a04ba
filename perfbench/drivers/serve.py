"""Open-loop serving: independent requests arrive on a schedule and go
through ``ContinuousBatcher.submit`` / ``poll``, one server thread.

Traffic keys: ``rate_per_s`` (fixed in the cell), ``clip_seconds`` [lo, hi],
``audio_std``, ``tokens`` (a lognormal token budget: ``median``, ``sigma``,
clipped to [``min``, ``max``]), ``slots``, ``chunk``, ``language``,
``suppress_eot`` (random weights then decode the whole budget), ``drain_s``
(how long past the close a request due in the window is waited for) and
``check_requests``.

Every seed gets the same set of sizes and arrivals in another order: the
window holds round(rate x seconds) requests, their gaps the exponential
distribution's quantiles at (i + 1/2) / n, their clip lengths and budgets
the quantiles of theirs, each list shuffled by the seed. Each request is
timed from its due time to the ``poll`` that returns it, so a stall counts
against every request it delays; the generator's lateness (submission after
the due time) is reported beside it. A request not returned ``drain_s``
after the close has failed, and counts at that cap in the tail.

The check takes a sample of the finished requests drawn from the seed, with
the longest budget in it, runs the plain reference over each clip and its
served tokens, and compares the program's score of each request with the
reference's log-probability of its tokens, per token.
"""

from __future__ import annotations

import math
import time
from statistics import NormalDist

import numpy as np
import torch

from .. import flops as F
from ..reference import mel_ref, whisper_ref
from . import common

SAMPLE_RATE = 16000
N_SAMPLES = 30 * SAMPLE_RATE


def quantiles(n: int, inv_cdf) -> np.ndarray:
    return np.array([inv_cdf((i + 0.5) / n) for i in range(n)])


class Driver:
    def __init__(self, cfg, traffic, seed, rec, device, control=False, seconds=0.0, units=0):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.rec, self.device, self.control = rec, torch.device(device), control
        self.seconds, self.units = seconds, units

    # -- the schedule -------------------------------------------------------------

    def schedule(self, rate: float, seconds: float):
        """(due times, clip lengths in samples, token budgets) of the window's
        requests, and their waveforms."""
        t = self.traffic
        n = max(1, int(round(rate * seconds)))
        rng = np.random.default_rng(self.seed)
        gaps = rng.permutation(quantiles(n, lambda p: -math.log1p(-p) / rate))
        lo, hi = t["clip_seconds"]
        lengths = rng.permutation(quantiles(n, lambda p: lo + (hi - lo) * p))
        tk = t["tokens"]
        norm = NormalDist(math.log(tk["median"]), tk["sigma"])
        budgets = rng.permutation(np.clip(np.round(np.exp(quantiles(n, norm.inv_cdf))),
                                          tk["min"], tk["max"]).astype(int))
        due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        samples = (lengths * SAMPLE_RATE).astype(int)
        waves = [(rng.standard_normal(s, dtype=np.float32) * t["audio_std"]) for s in samples]
        return due, samples, budgets, waves

    # -- set-up -------------------------------------------------------------------

    def _batcher(self):
        from whisper_flamingo_tpu_torch.decoding import DecodingOptions
        from whisper_flamingo_tpu_torch.serving import ContinuousBatcher

        t, tok = self.traffic, self.cfg["tokens"]
        keep_eot = not t.get("suppress_eot")
        self.suppressed = [x for x in tok["always_suppressed"] if not (keep_eot and x == tok["eot"])]
        options = DecodingOptions(
            language=t["language"], without_timestamps=True, sample_len=t["tokens"]["max"],
            suppress_tokens=self.suppressed, fp16=self.cfg["dtype"] == "bfloat16")
        return ContinuousBatcher(self.model, options, slots=t["slots"], chunk=t["chunk"])

    def setup(self) -> None:
        self.model = common.build_whisper(self.cfg, self.seed, self.device)
        self.batcher = self._batcher()
        self.batcher.warmup()
        # every prefill size and the slot refill: a burst of one request per
        # slot and one more, then drained
        slots = self.traffic["slots"]
        for i in range(slots + 1):
            self.batcher.submit(np.zeros(SAMPLE_RATE * (2 + i % 13), np.float32), max_tokens=8)
        while self.batcher.pending:
            self.batcher.poll()
        self.plan = self.schedule(self.traffic["rate_per_s"], self.seconds)
        common.sync(self.device)

    # -- the window -----------------------------------------------------------------

    def run_window(self) -> dict:
        from ..instrument import instrument

        rec, b = self.rec, self.batcher
        due, _, budgets, waves = self.plan
        n = len(due)
        close = self.seconds
        cap = close + self.traffic["drain_s"]
        ids, lateness = {}, []
        self.results = {}
        latency = np.full(n, np.nan)
        done_at = np.full(n, np.nan)
        j = 0
        with instrument(rec), rec.profiling():
            t0 = time.perf_counter()
            with rec.range("window"):
                while True:
                    now = time.perf_counter() - t0
                    while j < n and due[j] <= now:
                        with rec.range("submit"):
                            ids[b.submit(waves[j], max_tokens=int(budgets[j]))] = j
                        lateness.append(now - due[j])
                        j += 1
                    if now > cap:
                        break
                    if not b.pending:
                        if j == n:
                            break
                        time.sleep(max(0.0, due[j] - now))
                        continue
                    with rec.range("poll"):
                        finished = b.poll()
                    t = time.perf_counter() - t0
                    for rid, res in finished:
                        k = ids[rid]
                        latency[k] = t - due[k]
                        done_at[k] = t
                        self.results[k] = (list(res.tokens), float(res.avg_logprob))
            end = time.perf_counter() - t0
        # EOT is suppressed: a request that does not fill its budget is wrong
        for k, (toks, _) in list(self.results.items()):
            if len(toks) != int(budgets[k]):
                latency[k] = np.nan
        ok = ~np.isnan(latency)
        failed = int(n - ok.sum())
        capped = np.where(ok, latency, cap - due)
        p95 = float(np.sort(capped)[max(0, math.ceil(0.95 * n) - 1)])
        served = sum(len(t) for t, _ in self.results.values())
        order = np.argsort(due)
        thirds = [capped[order[i * n // 3: (i + 1) * n // 3]] for i in range(3)]
        last = float(np.nanmax(done_at)) if ok.any() else end
        return {
            "window_s": last, "units": int(ok.sum()), "attempted": n, "failed": failed,
            "flops": self.served_flops(),
            "e2e": {"request_p95_ms": 1e3 * p95},
            "notes": {"requests": n, "served_tokens": served,
                      "tokens_per_s": served / last,
                      "p50_ms": 1e3 * float(np.median(capped)),
                      "lateness_max_ms": 1e3 * max(lateness or [0.0]),
                      "lateness_mean_ms": 1e3 * float(np.mean(lateness or [0.0])),
                      "p95_first_third_ms": 1e3 * float(np.quantile(thirds[0], 0.95)),
                      "p95_last_third_ms": 1e3 * float(np.quantile(thirds[2], 0.95)),
                      "backlog_at_close": int(np.sum((due < close) & ~(done_at <= close))),
                      "last_done_s": last, "close_s": close},
        }

    def served_flops(self) -> float:
        dims = self.cfg["dims"]
        init_len = len(self.cfg["tokens"]["sot_sequence_notimestamps"])
        per_req = F.encoder_flops(dims) + F.static_kv_flops(dims)
        total = 0.0
        for toks, _ in self.results.values():
            total += per_req + F.decode_flops(dims, range(init_len + len(toks) - 1))
        return total

    def release(self) -> None:
        del self.batcher, self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------------------

    def sample(self) -> list:
        """Up to ``check_requests`` finished requests drawn from the seed,
        the largest budget among them."""
        done = sorted(self.results)
        if not done:
            return []
        budgets = self.plan[2]
        longest = max(done, key=lambda k: (len(self.results[k][0]), budgets[k]))
        rng = np.random.default_rng(self.seed + 1)
        rest = [k for k in done if k != longest]
        m = min(len(rest), int(self.traffic["check_requests"]) - 1)
        return [longest] + [rest[i] for i in rng.choice(len(rest), size=m, replace=False)]

    def notes(self) -> dict:
        return {"requests_checked": self.checked[0], "tokens_checked": self.checked[1],
                "served_logit_gap_widest": self.widest}

    def _allowed(self, logits: torch.Tensor, init_len: int) -> torch.Tensor:
        """The logits that chose each served token, the filtered ids at -inf."""
        logits = logits[0, init_len - 1:].clone()
        logits[:, self.suppressed] = float("-inf")
        logits[0, self.cfg["tokens"]["blank"]] = float("-inf")
        return logits

    @torch.no_grad()
    def check(self, limits: dict) -> list:
        """The root mean square, over the sampled requests, of the per-token
        gap between the program's score of the request (its summed
        log-probability, ``avg_logprob`` x (tokens + 1)) and the reference's
        log-probability of the same tokens. Under ``control="fp8"`` the
        reference computed in fp8 scores them in the program's place. The
        widest gap by which a served token's logit lies below the
        reference's best is a note: a tail of a few near-ties in a thousand
        tokens, it does not separate bf16 from the control (PERF.md)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg, dims, tok = self.cfg, self.cfg["dims"], self.cfg["tokens"]
        sd = common.whisper_state(cfg, self.seed, self.device)
        init = list(tok["sot_sequence_notimestamps"])
        gaps, widest = [], 0.0
        self.checked = [0, 0]
        for k in self.sample():
            toks, avg_lp = self.results[k]
            wave = torch.from_numpy(self.plan[3][k]).to(self.device)
            audio = torch.nn.functional.pad(wave, (0, N_SAMPLES - wave.shape[0]))[None]
            mel = mel_ref.log_mel(audio, dims["n_mels"])
            seq = torch.tensor([init + toks[:-1]], dtype=torch.long, device=self.device)
            served = torch.tensor(toks, dtype=torch.long, device=self.device)
            logits = self._allowed(
                whisper_ref.decoder_logits(sd, dims, seq, whisper_ref.encoder(sd, dims, mel)),
                len(init))
            widest = max(widest, float((logits.max(dim=-1).values
                                        - logits.gather(1, served[:, None])[:, 0]).max()))
            ref = self._score(logits, served)
            if self.control == "fp8":
                low = whisper_ref.decoder_logits(
                    sd, dims, seq, whisper_ref.encoder(sd, dims, mel, "fp8"), lowp="fp8")
                got = self._score(self._allowed(low, len(init)), served)
            else:
                got = avg_lp * (len(toks) + 1)
            gaps.append(abs(got - ref) / len(toks))
            self.checked[0] += 1
            self.checked[1] += len(toks)
        del sd
        self.widest = widest
        rms = float(np.sqrt(np.mean(np.square(gaps)))) if gaps else float("inf")
        return [("logprob_gap_rms", rms, limits["logprob_gap_rms"])]

    @staticmethod
    def _score(logits: torch.Tensor, served: torch.Tensor) -> float:
        lp = torch.log_softmax(logits, dim=-1)
        return float(lp.gather(1, served[:, None])[:, 0].double().sum())
