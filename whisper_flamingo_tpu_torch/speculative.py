"""Speculative greedy decoding: a small draft model proposes K tokens and
the verifier checks them in one cached pass.

Port of ``whisper_flamingo_tpu/speculative.py``. The decode step reads the
decoder weights and the cross-attention slabs once per token; verifying K
drafted tokens in one pass reads them once for up to K + 1 accepted
tokens, while the output stays token-identical to plain greedy (argmax
acceptance; exact in exact arithmetic, pinned at fp32 against the JAX
package and plain greedy).

Scope, as in JAX: greedy only (``temperature=0``, no beam or best_of), no
conditioning streams; the whole logit-filter stack applies at every
drafted and verified position against the hypothesis prefix, so
timestamped decoding speculates too. Both models share the vocabulary and
the mel bins. The int8 modes compose: both models are quantized, and
int8kv stores both self caches int8.

One round (:func:`make_spec_round`), per row, with n the current length
and token n-1 not yet fed to either cache:

1. the draft takes K steps at per-row offsets (the first re-feeds tokens
   n-2 and n-1, repairing the draft cache's one-slot lag after a fully
   accepted round; the one-token steps run the decode-attention kernel with
   per-row offsets);
2. the verifier reads [token n-1, d_1 .. d_K] at offsets n-1 .. n+K-1 in
   one pass and takes its greedy choice at each of the K+1 positions;
3. the longest prefix where the choices equal the drafts is accepted, plus
   the verifier's next choice;
4. rows advance by that count (capped by the budget and the first EOT).
   Stale cache slots of rejected drafts lie where the next round writes
   before it attends, so nothing is rolled back.

The JAX ``while_loop`` is a Python loop over rounds that reads one flag
(is any row still going?) per round.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional

import torch

from .decoding import (
    DecodingOptions,
    DecodingResult,
    DecodingTask,
    _apply_filters,
    _features,
    _FilterConfig,
)
from .models.dims import ModelDimensions
from .models.whisper import decoder_apply, prepare_decode_params

if TYPE_CHECKING:
    from .models.whisper import Whisper

State = Dict[str, object]


def _write_at(buf: torch.Tensor, start: torch.Tensor, vals: torch.Tensor) -> None:
    """``buf[i, start[i] + j] = vals[i, j]``, in place."""
    idx = start.long()[:, None] + torch.arange(vals.shape[1], device=buf.device)[None]
    buf.scatter_(1, idx, vals)


def check_draft(model: "Whisper", draft_model: "Whisper") -> None:
    """Raise unless ``draft_model`` can draft for ``model``."""
    if draft_model.dims.n_vocab != model.dims.n_vocab:
        raise ValueError("draft and verifier must share the vocabulary")
    if draft_model.dims.n_mels != model.dims.n_mels:
        raise ValueError("draft and verifier must share the mel frontend")


def draft_params(task: DecodingTask, draft_model: "Whisper") -> "Whisper":
    """The draft's decode-time weights, prepared as ``task``'s verifier copy."""
    return prepare_decode_params(draft_model, task.compute_dtype,
                                 quantize=task.options.quantize is not None)


def make_spec_round(dims_v: ModelDimensions, dims_d: ModelDimensions, cfg: _FilterConfig,
                    eot: int, K: int, dtype: torch.dtype):
    """One draft-K / verify / accept round over per-row state, shared by
    :class:`SpeculativeDecodingTask` and the continuous batcher's
    speculative slots (``serving.ContinuousBatcher``).

    State (a dict, updated IN PLACE): ``tokens`` (B, >= max(caps) + K + 1)
    EOT-filled, ``lens``/``caps`` (B,) int, ``finished`` (B,) bool,
    ``sum_logprobs`` (B,), the decode caches ``cache_v``/``cache_d`` with
    at least max(caps) + K slots, and optional counters: ``accepted``
    (tokens appended), ``rounds`` and ``row_rounds`` (rows active in a
    round, summed over the rounds). Inactive rows are no-ops: their cache
    rewrites reproduce the values there."""
    pos_k = None

    def round_fn(params_v: "Whisper", params_d: "Whisper", s: State) -> State:
        nonlocal pos_k
        tokens, n, caps = s["tokens"], s["lens"], s["caps"]
        dev = tokens.device
        if pos_k is None or pos_k.device != dev:
            pos_k = torch.arange(K + 1, device=dev)[None]
        active = ~s["finished"] & (n < caps)
        off = n.to(torch.int32)
        last = tokens.gather(1, (n - 1)[:, None])

        # -- draft K tokens at per-row offsets; the drafts go into a scratch
        # copy of the buffer, so the filters see each hypothesis prefix
        tmp = tokens.clone()
        cur = tokens.gather(1, torch.stack([n - 2, n - 1], dim=1))
        cache_d, drafts = s["cache_d"], []
        for j in range(K):
            lg, cache_d = decoder_apply(params_d, dims_d, cur, cache=cache_d,
                                        offset=off - 2 if j == 0 else off - 1 + j, dtype=dtype)
            nxt = _apply_filters(cfg, lg[:, -1].float(), tmp, n + j).argmax(dim=-1)
            drafts.append(nxt)
            _write_at(tmp, n + j, nxt[:, None])
            cur = nxt[:, None]
        draft = torch.stack(drafts, dim=1)  # (B, K)

        # -- verify K+1 positions in one pass (the last is the bonus token)
        v_logits, cache_v = decoder_apply(params_v, dims_v, torch.cat([last, draft], dim=1),
                                          cache=s["cache_v"], offset=off - 1, dtype=dtype)
        flt = torch.stack([_apply_filters(cfg, v_logits[:, j].float(), tmp, n + j)
                           for j in range(K + 1)], dim=1)  # (B, K+1, V)
        choice = flt.argmax(dim=-1)
        tok_lp = torch.log_softmax(flt, dim=-1).gather(-1, choice[..., None])[..., 0]

        # -- the longest matching prefix plus the bonus token
        match = (choice[:, :K] == draft).long()
        a = match.cumprod(dim=1).sum(dim=1)
        n_new = torch.minimum(a + 1, caps - n)
        takes = pos_k < n_new[:, None]
        hit_eot = (choice == eot) & takes
        has_eot = hit_eot.any(dim=1)
        first_eot = hit_eot.long().argmax(dim=1)
        n_new = torch.where(has_eot, first_eot + 1, n_new)
        n_new = torch.where(active, n_new, torch.zeros_like(n_new))
        takes = pos_k < n_new[:, None]

        _write_at(tokens, n, torch.where(takes, choice, torch.full_like(choice, eot)))
        lens = n + n_new
        s["lens"] = lens
        s["finished"] = s["finished"] | hit_eot.any(dim=1) | (lens >= caps)
        s["sum_logprobs"] = s["sum_logprobs"] + torch.where(
            takes, tok_lp, torch.zeros_like(tok_lp)).sum(dim=1)
        s["cache_v"], s["cache_d"] = cache_v, cache_d
        if "accepted" in s:
            s["accepted"] = s["accepted"] + n_new.sum()
            s["rounds"] = s["rounds"] + 1
            s["row_rounds"] = s["row_rounds"] + active.sum()
        return s

    return round_fn


class SpeculativeDecodingTask(DecodingTask):
    """A :class:`..decoding.DecodingTask` whose loop drafts with a second
    model. Language detection, result assembly and ranking are inherited;
    the loop returns the greedy loop's fields, so results are built the
    same way and the tokens equal plain greedy's. ``last_stats`` holds the
    last run's appended tokens, rounds and active row-rounds: each active
    row appends its accepted drafts plus one token per round, so
    (accepted_tokens - row_rounds) / (draft_len * row_rounds) is the share
    of drafts accepted (a little low where a budget cuts the last round)."""

    def __init__(self, model: "Whisper", draft_model: "Whisper", options: DecodingOptions,
                 draft_len: int = 4):
        super().__init__(model, options)
        if options.beam_size is not None or options.best_of is not None:
            raise ValueError("speculative decoding is greedy-only")
        if options.temperature != 0:
            raise ValueError("speculative decoding requires temperature=0")
        check_draft(model, draft_model)
        if model.extras.add_gated_x_attn:
            raise ValueError("speculative decoding does not take conditioning streams")
        if draft_len < 1:
            raise ValueError("draft_len must be >= 1")
        self.draft_model = draft_model
        self.draft_len = int(draft_len)
        self.last_stats: Optional[dict] = None
        self.params_d = draft_params(self, draft_model)  # the draft's decode-time weights
        self._draft_mel: Optional[torch.Tensor] = None

    @torch.no_grad()
    def _main_loop(self, audio_features: torch.Tensor, init_tokens: torch.Tensor,
                   xt: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        dims_v, dims_d, dtype = self.model.dims, self.draft_model.dims, self.compute_dtype
        K, max_len, eot = self.draft_len, self.max_len, self.tokenizer.eot
        B = init_tokens.shape[0]
        dev = audio_features.device
        params_v, params_d = self.params, self.params_d
        feats_d = _features(self.draft_model, self._draft_mel.to(dev), dtype)
        logits_v, cache_v = self.prefill(params_v, audio_features, init_tokens, extra_len=K)
        _, cache_d = self.prefill(params_d, feats_d, init_tokens, extra_len=K)
        no_speech_probs = self.no_speech_probs(logits_v)

        # width max_len + K + 1: a round writes K+1 tokens at n <= max_len
        state: State = self.first_tokens(
            logits_v, init_tokens, max_len + K + 1,
            torch.full((B,), max_len, dtype=torch.long, device=dev))
        state.update(cache_v=cache_v, cache_d=cache_d)
        state.update({k: torch.zeros((), dtype=torch.long, device=dev)
                      for k in ("accepted", "rounds", "row_rounds")})
        round_fn = make_spec_round(dims_v, dims_d, self.filter_cfg, eot, K, dtype)
        while bool((~state["finished"] & (state["lens"] < state["caps"])).any()):
            state = round_fn(params_v, params_d, state)
        self.last_stats = {"accepted_tokens": int(state["accepted"]),
                           "rounds": int(state["rounds"]),
                           "row_rounds": int(state["row_rounds"])}
        return {"tokens": state["tokens"][:, :max_len + 1],
                "sum_logprobs": state["sum_logprobs"],
                "no_speech_probs": no_speech_probs}

    def run(self, mel, xt=None) -> List[DecodingResult]:
        if xt is not None:
            raise ValueError("speculative decoding does not take conditioning streams")
        mel = torch.as_tensor(mel)
        d = self.model.dims
        if tuple(mel.shape[-2:]) == (d.n_audio_ctx, d.n_audio_state):
            # the draft computes its own encoder features from the mel
            raise ValueError("speculative decoding requires raw mel input (the draft model "
                             "computes its own encoder features)")
        self._draft_mel = mel
        try:
            return super().run(mel)
        finally:
            self._draft_mel = None


def decode_speculative(
    model: "Whisper", draft_model: "Whisper", mel,
    options: DecodingOptions = DecodingOptions(without_timestamps=True), draft_len: int = 4,
):
    """Greedy decode with draft-model speculation on the model's device;
    token-identical to ``decode(model, mel, options)``. A 2-D mel decodes as
    one segment."""
    mel = torch.as_tensor(mel)
    single = mel.dim() == 2
    if single:
        mel = mel[None]
    result = SpeculativeDecodingTask(model, draft_model, options, draft_len).run(mel)
    return result[0] if single else result
