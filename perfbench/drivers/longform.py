"""Long-form transcription with word timestamps: seeded recordings through
``transcribe(..., word_timestamps=True)`` at batch 1, one after another.

Traffic keys: ``pool`` recordings of ``recording_seconds`` of
``audio_std`` N(0, 1) audio, drawn on the device from the seed and used in
turn (with random weights a recording's windows vary with the seed, 6 to 10
on the H100, so a window averages over as many distinct recordings as it
reaches); ``check_recordings``, how many of them the check replays; ``decoding`` (``sample_len`` tokens a window, ``language``,
``suppress_eot``: EOT suppressed so that random weights fill each window's
budget; ``suppress_special``: every id from EOT up, the timestamps
included, suppressed, so that each window's tokens are text);
``condition_on_previous_text``; ``alignment_heads``, the published model
whose alignment heads word timing reads. Greedy at temperature 0 alone:
no fallback, no compression, log-probability or no-speech rule. A unit is
one recording; the window ends at the first recording boundary at or after
``--seconds``. ``audio_s_per_s`` counts each recording's own seconds, as
its user does. With word timestamps ``transcribe`` moves the seek to the
last word's end, which with random weights falls short of each window's
30 s by a seed-dependent amount, so a recording takes 5 to 11 windows,
most often 6 (four full ones, then windows of a few frames), and not the
4 that 30 s advances would give. The windows a second, counted 30 s each
(``rate_window``), and the windows of each recording are noted.

Set-up transcribes one recording, so that every shape is warm (the prompt
lengths of later windows, the alignment pass, the DTW kernel).

After the window the first ``check_recordings`` recordings run once more,
keeping per 30 s window the program's filtered logits at each step, its
alignment matrix and its DTW path. The check recomputes each window with
the plain reference (``reference.mel_ref`` over the recording,
``reference.whisper_ref`` teacher-forced with the window's prompt,
``reference.timing_ref`` for the alignment matrix and a NumPy DTW) and
compares:

- ``logit_rel_err_rms``: per token of every window, as ``offline_decode``;
- ``align_weight_err``: per window with text, the alignment heads' cross
  weights (softmax over the window's frames, before the normalisation
  over the tokens): the norm of the program's less the reference's over
  the norm of the reference's; the largest over the windows. The
  program's are its heads (``get_alignment_heads``) of the cross logits
  its alignment forward returned, the reference's its own heads (the
  published bitmap) of its own forward;
- ``align_matrix_gap``: per window, the largest difference between the
  program's alignment matrix and the one the reference's normalisation,
  median filter and mean over the heads make of the program's weights;
  the largest over the windows (what the program does after the
  weights);
- ``align_rel_err`` (noted): per window, the norm of the program's
  alignment matrix less the reference's over the norm of the reference's;
  the root mean square over the windows;
- ``dtw_path_gap``: per window, the cost of the program's DTW path through
  the cost matrix the program gave its kernel, less the cost of the NumPy
  DTW's path through the same matrix, over the summed magnitude along the
  latter (0 when the kernel's path, hence the word times, is the DP's
  optimum); the largest over the windows;
- ``windows_unlike_first``: windows whose tokens on the replay differ from
  the window's;
- ``tokens_not_argmax``: decoded tokens that are not the largest of the
  program's own filtered logits at their step (greedy at T = 0: the loop's
  choice, which the logits alone do not show).

Windows of one or two frames give 0 / 0 in the matrix's normalisation on
both sides and are left out of the matrix numbers. With random weights the
matrix itself is ill-conditioned against the reference (each frame's
cross-attention differs little between tokens, and the normalisation over
the tokens divides by that spread): ``align_rel_err`` reads 0.16-0.30 on
sound seeds against 0.44-0.70 for the fp8 control on the H100, too close
for a limit that new seeds keep, so it is noted, with ``ref_path_gap``
(the program's path through the reference's matrix against the
reference's own path). The weights before that normalisation are well
conditioned, and the limits hold them, what the program makes of them,
the logits and the kernel's path.

In traced runs this generator opens its ranges ``segment`` (one window's
decode, around ``transcribe``'s ``decode``), ``align`` (around
``timing.alignment_matrix``: the second encode and the cross-attention
weights) and ``dtw`` (around ``ops.dtw.dtw_trace``, the kernel), the last
two synchronised on both sides for their host times. (``window`` is the
harness's name for the measured window.)
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import time

import numpy as np
import torch

from .. import flops as F
from ..reference import mel_ref, timing_ref, whisper_ref
from . import common
from .offline_decode import relative_error

SAMPLE_RATE = 16000
N_FRAMES = 3000


class Driver:
    def __init__(self, cfg, traffic, seed, rec, device, control=False, seconds=0.0, units=0):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.seconds, self.units = seconds, units
        self.rec, self.device, self.control = rec, torch.device(device), control
        self.dec = traffic["decoding"]

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        from whisper_flamingo_tpu_torch.registry import alignment_heads_for

        cfg, dims = self.cfg, self.cfg["dims"]
        self.model = common.build_whisper(cfg, self.seed, self.device)
        self.model.dtype = common.DTYPES[cfg["dtype"]]
        self.model.alignment_heads = alignment_heads_for(
            self.traffic["alignment_heads"], dims["n_text_layer"], dims["n_text_head"])
        self.ref_heads = timing_ref.alignment_heads(
            self.traffic["alignment_heads"], dims["n_text_layer"], dims["n_text_head"])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        samples = int(self.traffic["recording_seconds"] * SAMPLE_RATE)
        self.pool = [common.audio_batch(gen, 1, samples, self.traffic["audio_std"],
                                        self.device)[0] for _ in range(self.traffic["pool"])]
        self._unit(0)
        common.sync(self.device)

    def _suppressed(self) -> list:
        tok = self.cfg["tokens"]
        out = set(tok["always_suppressed"])
        if self.dec.get("suppress_special"):
            out |= set(range(tok["eot"], self.cfg["dims"]["n_vocab"]))
        if not self.dec.get("suppress_eot"):
            out.discard(tok["eot"])
        return sorted(out)

    def _options(self) -> dict:
        return dict(
            temperature=0.0, compression_ratio_threshold=None, logprob_threshold=None,
            no_speech_threshold=None, word_timestamps=True,
            condition_on_previous_text=self.traffic["condition_on_previous_text"],
            language=self.dec["language"], sample_len=self.dec["sample_len"],
            suppress_tokens=self._suppressed(), without_timestamps=True,
            fp16=self.cfg["dtype"] == "bfloat16",
        )

    # -- the window ------------------------------------------------------------

    def _unit(self, i: int) -> dict:
        from whisper_flamingo_tpu_torch.transcribe import transcribe

        return transcribe(self.model, self.pool[i % len(self.pool)], **self._options())

    @contextlib.contextmanager
    def _ranges(self):
        """``segment``, ``align`` and ``dtw`` around the program's calls, in
        traced runs."""
        if not self.rec.traced:
            yield
            return
        tr = importlib.import_module("whisper_flamingo_tpu_torch.transcribe")
        from whisper_flamingo_tpu_torch import timing
        from whisper_flamingo_tpu_torch.ops import dtw as dtw_ops

        rec, saved = self.rec, []

        def patch(mod, name, wrapper):
            orig = getattr(mod, name)
            saved.append((mod, name, orig))
            # the wrapper carries the function's attributes (its launch counter)
            setattr(mod, name, functools.wraps(orig)(wrapper(orig)))

        def ranged(name, host=False):
            def wrapper(orig):
                def wrapped(*args, **kwargs):
                    if name == "dtw":
                        n, m = args[0].shape
                        rec.calls["dtw"].append({"n": int(n), "m": int(m)})
                    with (rec.host_span(name) if host else rec.range(name)):
                        return orig(*args, **kwargs)
                return wrapped
            return wrapper

        patch(tr, "decode", ranged("segment"))
        patch(timing, "alignment_matrix", ranged("align", host=True))
        patch(dtw_ops, "dtw_trace", ranged("dtw", host=True))
        try:
            yield
        finally:
            for mod, name, orig in reversed(saved):
                setattr(mod, name, orig)

    @contextlib.contextmanager
    def _decodes(self, into: list):
        """Each window's decoded tokens, appended to ``into`` as they come
        (a segment's own tokens are emptied when its words collapse)."""
        tr = importlib.import_module("whisper_flamingo_tpu_torch.transcribe")
        orig = tr.decode

        def recorded(*args, **kwargs):
            result = orig(*args, **kwargs)
            into.append(list(result.tokens))
            return result

        tr.decode = recorded
        try:
            yield
        finally:
            tr.decode = orig

    def _windows(self, result: dict, decoded: list) -> list:
        """(seek, the segment's tokens, the decoded tokens) of each window of
        one recording: one segment a window, the timestamps suppressed."""
        segs = result["segments"]
        if len(segs) != len(decoded):
            raise RuntimeError(f"{len(segs)} segments for {len(decoded)} decoded windows")
        return [(s["seek"], list(s["tokens"]), toks) for s, toks in zip(segs, decoded)]

    def run_window(self) -> dict:
        from ..instrument import instrument

        rec, seconds, units = self.rec, self.seconds, self.units
        self.done = []
        decoded: list = []
        with instrument(rec), self._ranges(), self._decodes(decoded), rec.profiling():
            t0 = time.perf_counter()
            with rec.range("window"):
                while True:
                    res = self._unit(len(self.done))
                    self.done.append(self._windows(res, decoded))
                    decoded.clear()
                    elapsed = time.perf_counter() - t0
                    if (units and len(self.done) >= units) or (not units and elapsed >= seconds):
                        break
            window_s = time.perf_counter() - t0  # the results are on the host: synchronised
        windows = [w for rec_ in self.done for w in rec_]
        failed = sum(1 for _, _, toks in windows if len(toks) != self.dec["sample_len"])
        recorded_s = len(self.done) * self.traffic["recording_seconds"]
        return {"window_s": window_s, "units": len(self.done), "attempted": len(windows),
                "failed": failed, "flops": sum(self.recording_flops(r) for r in self.done),
                "e2e": {"audio_s_per_s": recorded_s / window_s},
                "notes": {"rate_window": N_FRAMES / 100 * len(windows) / window_s,
                          "windows_per_recording": [len(r) for r in self.done],
                          "seeks": [[w[0] for w in r] for r in self.done[: self._checked()]]}}

    def _checked(self) -> int:
        """How many recordings the check replays: the first ones the window
        transcribed."""
        return min(self.traffic["check_recordings"], len(self.pool), len(self.done))

    def _initial_tokens(self, previous: list) -> list:
        """A window's initial tokens after the earlier windows' ``previous``
        tokens: transcribe's chained prompt (the newest n_text_ctx / 2 - 1,
        then their newest power-of-two count), then the start sequence."""
        tok = self.cfg["tokens"]
        init = list(tok["sot_sequence_notimestamps"])
        if not (previous and self.traffic["condition_on_previous_text"]):
            return init
        prompt = previous[-(self.cfg["dims"]["n_text_ctx"] // 2 - 1):]
        prompt = prompt[-(1 << (len(prompt).bit_length() - 1)):]
        return [self.traffic["sot_prev"]] + prompt + init

    def recording_flops(self, windows: list) -> float:
        """Operations of one recording: per window the encoder, the static
        K/V, the prefill (prompt included) and the greedy steps, then the
        alignment's second encode and teacher-forced forward."""
        dims, total, previous = self.cfg["dims"], 0.0, []
        n_sot = len(self.cfg["tokens"]["sot_sequence_notimestamps"]) - 1
        for _, kept, toks in windows:
            init_len = len(self._initial_tokens(previous))
            max_len = init_len + self.dec["sample_len"]
            total += F.encoder_flops(dims) + F.static_kv_flops(dims)
            total += F.decode_flops(dims, range(max_len - 1))
            total += F.model_flops(dims, 1, text_len=n_sot + 1 + len(toks) + 1)
            previous = previous + kept
        return total

    def release(self) -> None:
        if not self.control:
            self.replays = self._replay()
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def _replay(self) -> dict:
        """Each distinct recording the window transcribed, once more. By pool
        index: its windows as ``_windows`` gives them, and per window the
        program's filtered logits (steps, V), the cross logits (heads, T, S)
        of its alignment heads, its alignment matrix and DTW path (``None``
        where the window had no text to align)."""
        from unittest import mock

        from whisper_flamingo_tpu_torch import decoding, timing
        from whisper_flamingo_tpu_torch.ops import dtw as dtw_ops

        apply_filters, align, path = decoding._apply_filters, timing.alignment_matrix, dtw_ops.dtw
        forward = timing.decoder_apply
        heads = torch.as_tensor(np.argwhere(self.model.get_alignment_heads()), device=self.device)
        out = {}
        for p in range(self._checked()):
            per: list = []

            def recording(cfg, lg, tokens, cur_len):
                filtered = apply_filters(cfg, lg, tokens, cur_len)
                if cur_len == cfg.sample_begin:  # a window's first step
                    per.append({"logits": [], "qk": None, "matrix": None, "path": None})
                per[-1]["logits"].append(filtered[0])
                return filtered

            def aligning(*args, **kwargs):
                probs, matrix = align(*args, **kwargs)
                per[-1]["matrix"] = matrix.float().cpu()
                return probs, matrix

            def crossing(*args, **kwargs):
                out = forward(*args, **kwargs)
                if kwargs.get("return_cross_qk"):
                    per[-1]["qk"] = out[1][heads[:, 0], 0, heads[:, 1]].float().cpu()
                return out

            def walking(x):
                per[-1]["path"] = path(x)
                return per[-1]["path"]

            decoded: list = []
            with mock.patch.object(decoding, "_apply_filters", recording), \
                    mock.patch.object(timing, "alignment_matrix", aligning), \
                    mock.patch.object(timing, "decoder_apply", crossing), \
                    mock.patch.object(dtw_ops, "dtw", walking), self._decodes(decoded):
                res = self._unit(p)
            for w in per:
                w["logits"] = torch.stack(w["logits"])
            out[p] = {"windows": self._windows(res, decoded), "per": per}
        return out

    # -- the check ---------------------------------------------------------------

    @torch.no_grad()
    def check(self, limits: dict) -> list:
        """The numbers of the module's docstring. Under ``control="fp8"``
        the reference computed in fp8 stands in the program's place."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg, dims, tok = self.cfg, self.cfg["dims"], self.cfg["tokens"]
        sd = common.whisper_state(cfg, self.seed, self.device)
        lowp = "fp8" if self.control else None
        rel, align_errs, gaps, ref_gaps, unlike, not_argmax = [], [], [], [], 0, 0
        weight_errs, matrix_gaps = [], []
        n_sot = len(tok["sot_sequence_notimestamps"]) - 1  # rows before the no-timestamps one
        for p in range(self._checked()):
            audio, windows = self.pool[p], self.done[p]
            replay = None if self.control else self.replays[p]
            if replay is not None:
                unlike += sum(a != b for a, b in zip(replay["windows"], windows))
                unlike += abs(len(replay["windows"]) - len(windows))
            padded = torch.cat([audio, torch.zeros(N_FRAMES * 160, device=self.device)])
            mel = mel_ref.log_mel(padded[None], dims["n_mels"])
            content = mel.shape[-1] - N_FRAMES
            previous = []
            for k, (seek, kept, toks) in enumerate(windows):
                segment = mel[:, :, seek: seek + N_FRAMES]
                segment = torch.nn.functional.pad(segment, (0, N_FRAMES - segment.shape[-1]))
                init = self._initial_tokens(previous)
                previous = previous + kept
                num_frames = min(N_FRAMES, content - seek)
                ref_lp, ref_m, ref_w = self._window(sd, segment, init, toks, num_frames, None)
                got = None if replay is None or k >= len(replay["per"]) else replay["per"][k]
                got_w = None
                if self.control:
                    got_lp, got_m, got_w = self._window(sd, segment, init, toks, num_frames, lowp)
                elif got is not None and len(got["logits"]) >= len(toks):
                    got_lp = torch.log_softmax(got["logits"][: len(toks)], dim=-1)
                    got_m = got["matrix"]
                    if got["qk"] is not None:  # the program's softmax over the window's frames
                        got_w = torch.softmax(got["qk"][:, :, : num_frames // 2], dim=-1)
                else:
                    got_lp, got_m = torch.full_like(ref_lp, float("nan")), None
                rel.append(relative_error(got_lp, ref_lp).cpu())
                chosen = torch.tensor(toks, device=got_lp.device)
                not_argmax += int((got_lp.argmax(-1) != chosen).sum())
                if ref_m is None:  # no text: nothing aligned on either side
                    continue
                if got_w is None or got_w.shape != ref_w.shape:
                    weight_errs.append(float("inf"))
                else:
                    ref_w, got_w = ref_w.cpu().double(), got_w.cpu().double()
                    weight_errs.append(float((got_w - ref_w).norm() / ref_w.norm()))
                if got_m is None or got_m.shape != ref_m.shape:
                    align_errs.append(float("inf"))
                    gaps.append(float("inf"))
                    matrix_gaps.append(float("inf"))
                    continue
                ref_m, got_m = ref_m.cpu(), got_m.cpu()
                if got_w is not None and got_w.shape[1:] == got_m.shape:
                    made = timing_ref.matrix_from_weights(got_w.float())
                    both = torch.isfinite(made) & torch.isfinite(got_m)
                    diff = (made - got_m)[both].abs()
                    matrix_gaps.append(float(diff.max()) if diff.numel() else 0.0)
                    if not torch.equal(both, torch.isfinite(got_m)):
                        matrix_gaps[-1] = float("inf")
                else:
                    matrix_gaps.append(float("inf"))
                finite = torch.isfinite(ref_m)
                if not torch.equal(finite, torch.isfinite(got_m)):
                    align_errs.append(float("inf"))
                    gaps.append(float("inf"))
                    continue
                if not finite.all():  # a window of one or two frames: 0 / 0 on both sides
                    continue
                align_errs.append(float((got_m - ref_m).double().norm() / ref_m.double().norm()))
                rows = slice(n_sot, n_sot + sum(t < tok["eot"] for t in toks) + 1)
                got_cost, ref_cost = (-got_m[rows]).numpy(), (-ref_m[rows]).numpy()
                got_path = timing_ref.dtw(got_cost) if self.control else got["path"]
                gaps.append(_path_gap(got_cost, got_path, timing_ref.dtw(got_cost)))
                ref_gaps.append(_path_gap(ref_cost, got_path, timing_ref.dtw(ref_cost)))
        del sd
        self.replays = None
        rel = torch.cat(rel).double()
        self.numbers = {
            "logit_rel_err_rms": float(rel.square().mean().sqrt()),
            "align_weight_err": max(weight_errs, default=float("inf")),
            "align_matrix_gap": max(matrix_gaps, default=float("inf")),
            "align_rel_err": float(np.sqrt(np.mean(np.square(align_errs)))),
            "dtw_path_gap": max(gaps, default=float("inf")),
            "ref_path_gap": max(ref_gaps, default=float("nan")),
            "windows_unlike_first": float(unlike),
            "tokens_not_argmax": float(not_argmax),
            "logit_rel_err_max": float(rel.max()),
            "windows_checked": len(align_errs),
        }
        return [(name, self.numbers[name], limit) for name, limit in limits.items()]

    def notes(self) -> dict:
        return self.numbers

    def _window(self, sd, segment, init, toks, num_frames, lowp):
        """The reference over one window: the filtered log-probabilities
        (tokens, V) of ``toks`` after ``init``, and the alignment matrix of
        the window's text with the heads' weights it is made from."""
        dims, tok = self.cfg["dims"], self.cfg["tokens"]
        feats = whisper_ref.encoder(sd, dims, segment, lowp)
        seq = torch.tensor([init + toks[:-1]], dtype=torch.long, device=self.device)
        logits = whisper_ref.decoder_logits(sd, dims, seq, feats, None, lowp)[:, len(init) - 1:]
        lp = whisper_ref.filtered_logprobs(logits, self._suppressed(), tok["blank"], 0)[0]
        sot = list(tok["sot_sequence_notimestamps"])
        text = [t for t in toks if t < tok["eot"]]
        if not text:
            return lp, None, None
        align_seq = torch.tensor([sot + text + [tok["eot"]]], dtype=torch.long, device=self.device)
        _, qks = timing_ref.decoder_with_cross(sd, dims, align_seq, feats, lowp)
        w = timing_ref.weights(qks, self.ref_heads, num_frames)
        return lp, timing_ref.matrix_from_weights(w), w


def _path_gap(cost, path, best_path) -> float:
    """How much dearer ``path`` is through ``cost`` than the optimum
    ``best_path``, over the summed magnitude along the optimum."""
    best = timing_ref.path_cost(cost, *best_path)
    scale = float(np.abs(cost[best_path[0], best_path[1]]).sum())
    return (timing_ref.path_cost(cost, *path) - best) / scale
