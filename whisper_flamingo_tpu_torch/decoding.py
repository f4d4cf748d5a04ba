"""Decoding: greedy, sampling and beam search over the KV-cached decoder.

Port of ``whisper_flamingo_tpu/decoding.py``. ``DecodingOptions`` and
``DecodingResult`` keep the JAX package's fields; the logit filters
(suppress, suppress-blank, timestamp rules) are masks over the whole
(rows, vocab) logits; the beam search is the same array algorithm (per-beam
top (G+1) candidates, a stable sort per audio, rank masks picking the G
best unfinished continuations, a fixed-capacity finished buffer for the
patience rule), run on the device.

The JAX ``while_loop`` becomes a Python loop over decoder steps. Each step
reads one flag back from the device (has every row finished?), so the loop
stops where the JAX loop stops; the bookkeeping stays on the device. The
beam's self cache is never reordered where the steps attend through the
decode-attention kernel: each row's history is read through an int32 row
table (``ops.decode_attn.beam_rows``), and only the table's written prefix
is reordered; the int8kv self cache (with its scales), whose steps take the
plain attention, is reordered by an ``index_select`` over the written
prefix. The incremental steps run the decode-attention
kernel (not under int8kv, as in JAX), the encoder the flash64 kernel. On
the card the incremental step replays CUDA graphs between the
decode-attention launches (``models.whisper.StepGraphs``, one holder a
task, captured per shape after two eager steps).

``quantize="int8"`` decodes with int8 weights and int8 static slabs
(``models.whisper.quantize_decode_params``, ``init_cache(quantize=True)``);
``"int8kv"`` also stores the self cache int8 with per-(token, head)
scales, the beam-mode variant (greedy warns, as in JAX). The logit filters
take one length for every row, or a (N,) tensor of per-row lengths
(speculative decoding and the continuous batcher), as JAX's vector form.

``bucket_prompt_lengths`` keeps the newest power-of-two count of prompt
tokens, as JAX does (``transcribe`` turns it on): it changes which tokens
the decoder sees, so it is output, not only a compile-count bound.

Under a mesh (a model sliced by ``parallel.mesh.shard_params``) each data
rank decodes its rows of the batch and :meth:`DecodingTask.run` returns
every row, in the input order, on every rank; the ranks of a model row see
the same all-reduced logits, so their beam bookkeeping stays in step with
no broadcast.

Left out: the alignment programs, and the one-hot beam reorder. A bf16 run
(``fp16=True``) decodes with a bf16 copy of the weights made once per
task; the encoder reads the model's own weights, cast per layer, as the
JAX encoder program does.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field, replace
from functools import lru_cache
from typing import TYPE_CHECKING, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from . import profiling
from .audio import CHUNK_LENGTH
from .models.whisper import (
    StepGraphs,
    decoder_apply,
    encoder_apply,
    init_cache,
    prepare_decode_params,
    self_step_kernel,
)
from .ops import decode_attn
from .tokenizer import Tokenizer, get_tokenizer
from .utils import compression_ratio

if TYPE_CHECKING:
    from .models.whisper import Whisper

NEG_INF = float("-inf")


@dataclass(frozen=True)
class DecodingOptions:
    """The JAX package's decode options (``fp16`` selects bfloat16 compute;
    ``seed`` seeds the sampling generator)."""

    task: str = "transcribe"
    language: Optional[str] = None

    temperature: float = 0.0
    sample_len: Optional[int] = None
    best_of: Optional[int] = None
    beam_size: Optional[int] = None
    patience: Optional[float] = None

    length_penalty: Optional[float] = None

    prompt: Optional[Union[str, List[int]]] = None
    prefix: Optional[Union[str, List[int]]] = None

    suppress_tokens: Optional[Union[str, Iterable[int]]] = "-1"
    suppress_blank: bool = True

    without_timestamps: bool = False
    max_initial_timestamp: Optional[float] = 1.0

    fp16: bool = True  # selects bfloat16 compute
    seed: int = 0

    # keep the newest floor-to-power-of-two count of prompt tokens (JAX's
    # compile-count bound; it changes the prompt, so transcribe() sets it
    # as JAX's does)
    bucket_prompt_lengths: bool = False

    # "int8": int8 decode weights and static K/V slabs; "int8kv": also the
    # self cache (the beam-mode variant)
    quantize: Optional[str] = None

    # attach a host numpy copy of each result's encoder features
    return_audio_features: bool = False


@dataclass(frozen=True)
class DecodingResult:
    audio_features: Optional[np.ndarray]
    language: str
    language_probs: Optional[Dict[str, float]] = None
    tokens: List[int] = field(default_factory=list)
    text: str = ""
    avg_logprob: float = np.nan
    no_speech_prob: float = np.nan
    temperature: float = np.nan
    compression_ratio: float = np.nan


def _features(model: "Whisper", mel: torch.Tensor, dtype) -> torch.Tensor:
    """Encoder features of ``mel``, or ``mel`` itself when it already has
    the features' shape."""
    if tuple(mel.shape[-2:]) == (model.dims.n_audio_ctx, model.dims.n_audio_state):
        return mel.to(dtype)
    return encoder_apply(model, model.dims, mel, dtype=dtype)


@torch.no_grad()
def detect_language(model: "Whisper", mel, tokenizer: Optional[Tokenizer] = None):
    """Return (language tokens (n_audio,), list of {code: prob} dicts); the
    single-segment form for a 2-D ``mel``."""
    if tokenizer is None:
        tokenizer = get_tokenizer(model.is_multilingual, num_languages=model.num_languages)
    if tokenizer.language is None or tokenizer.language_token not in tokenizer.sot_sequence:
        raise ValueError("This model doesn't have language tokens so it can't perform lang id")
    dev = model.device
    mel = torch.as_tensor(mel).to(dev)
    single = mel.dim() == 2
    if single:
        mel = mel[None]
    features = _features(model, mel, model.dtype)
    n_audio = features.shape[0]
    x = torch.full((n_audio, 1), tokenizer.sot, dtype=torch.long, device=dev)
    logits, _ = decoder_apply(model, model.dims, x, features, dtype=model.dtype)
    lang_ids = torch.tensor(tokenizer.all_language_tokens, device=dev)
    lang_logits = logits[:, 0, :][:, lang_ids].float()
    tokens = lang_ids[lang_logits.argmax(dim=-1)].cpu().numpy()
    probs = torch.softmax(lang_logits, dim=-1).cpu().numpy()
    language_probs = [
        {c: float(probs[i, j]) for j, c in enumerate(tokenizer.all_language_codes)}
        for i in range(n_audio)
    ]
    if single:
        return tokens[0], language_probs[0]
    return tokens, language_probs


# ---------------------------------------------------------------------------
# Logit filters
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _FilterConfig:
    sample_begin: int
    eot: int
    blank_tokens: Tuple[int, ...]
    suppress_tokens: Tuple[int, ...]
    timestamp_begin: Optional[int]
    no_timestamps: Optional[int]
    max_initial_timestamp_index: Optional[int]
    apply_blank: bool
    apply_suppress: bool
    apply_timestamps: bool


@lru_cache(maxsize=16)
def _token_mask(tokens: Tuple[int, ...], v: int, device: torch.device) -> torch.Tensor:
    """Additive (V,) mask, -inf at ``tokens``; built once per device (the
    index upload would otherwise sync every step)."""
    m = torch.zeros((v,), dtype=torch.float32)
    m[list(tokens)] = NEG_INF
    return m.to(device)


def _apply_filters(cfg: _FilterConfig, logits: torch.Tensor, tokens: torch.Tensor,
                   cur_len: Union[int, torch.Tensor]) -> torch.Tensor:
    """All filters as masks over fp32 logits (N, V); ``tokens`` (N, L) holds
    ``cur_len`` tokens per row: one int for every row, or a (N,) tensor of
    per-row lengths (speculative decoding, the continuous batcher). Every
    rule is written against the per-row broadcast, as in the JAX package."""
    n, v = logits.shape
    dev = logits.device
    if isinstance(cur_len, torch.Tensor):
        cur_len = cur_len.long()
    else:
        cur_len = torch.full((n,), cur_len, dtype=torch.long, device=dev)
    is_begin = cur_len == cfg.sample_begin  # (N,)
    neg = torch.full((), NEG_INF, device=dev)

    if cfg.apply_suppress and cfg.suppress_tokens:
        logits = logits + _token_mask(cfg.suppress_tokens, v, dev)[None]
    if cfg.apply_blank and cfg.blank_tokens:
        logits = torch.where(is_begin[:, None],
                             logits + _token_mask(cfg.blank_tokens, v, dev)[None], logits)

    if cfg.apply_timestamps:
        ts_begin = cfg.timestamp_begin
        col = torch.arange(v, device=dev)[None]
        logits = torch.where(col == cfg.no_timestamps, neg, logits)

        last = tokens.gather(1, (cur_len - 1).clamp_min(0)[:, None])[:, 0]
        penult = tokens.gather(1, (cur_len - 2).clamp_min(0)[:, None])[:, 0]
        n_sampled = cur_len - cfg.sample_begin
        last_was_ts = (n_sampled >= 1) & (last >= ts_begin)
        penult_was_ts = (n_sampled < 2) | (penult >= ts_begin)
        # timestamps appear in pairs, except directly before EOT
        mask_a = last_was_ts & penult_was_ts  # next must be non-timestamp
        mask_b = last_was_ts & ~penult_was_ts  # next cannot be text
        logits = torch.where(mask_a[:, None] & (col >= ts_begin), neg, logits)
        logits = torch.where(mask_b[:, None] & (col < cfg.eot), neg, logits)

        # timestamps must be monotonic and segments non-empty: sampled
        # timestamps are non-decreasing, so the max is the last one
        pos = torch.arange(tokens.shape[1], device=dev)[None]
        sampled = (pos >= cfg.sample_begin) & (pos < cur_len[:, None])
        is_ts = sampled & (tokens >= ts_begin)
        have_ts = is_ts.any(dim=1)
        ts_max = torch.where(is_ts, tokens, torch.full_like(tokens, -1)).amax(dim=1)
        ts_limit = torch.where(mask_b, ts_max, ts_max + 1)
        logits = torch.where(
            have_ts[:, None] & (col >= ts_begin) & (col < ts_limit[:, None]), neg, logits
        )

        # at the very beginning: timestamps only, capped at max_initial
        logits = torch.where(is_begin[:, None] & (col < ts_begin), neg, logits)
        if cfg.max_initial_timestamp_index is not None:
            last_allowed = ts_begin + cfg.max_initial_timestamp_index
            logits = torch.where(is_begin[:, None] & (col > last_allowed), neg, logits)

        # if the total timestamp probability beats any text token, force one
        logprobs = torch.log_softmax(logits.float(), dim=-1)
        ts_logprob = torch.logsumexp(logprobs[:, ts_begin:], dim=-1)
        max_text = logprobs[:, :ts_begin].amax(dim=-1)
        force_ts = ts_logprob > max_text
        logits = torch.where(force_ts[:, None] & (col < ts_begin), neg, logits)
    return logits


# ---------------------------------------------------------------------------
# Decoding task
# ---------------------------------------------------------------------------

class DecodingTask:
    """Static decode configuration plus the decode loop, on the model's
    device (a model on the CPU exists only if the caller asked for it).

    ``streams_at_ctx`` holds the gated slabs of every batch's conditioning
    streams at the decoder's ``n_text_ctx`` keys, the keys past a batch's
    stream length masked out of the gated softmax
    (``init_cache(xt_at_ctx=True)``): a task held over batches whose
    streams differ in length then keeps one step-graph key. False keeps
    each batch's own length."""

    def __init__(self, model: "Whisper", options: DecodingOptions,
                 streams_at_ctx: bool = False):
        self.model = model
        self.streams_at_ctx = streams_at_ctx
        language = options.language or "en"
        tokenizer = get_tokenizer(
            model.is_multilingual, num_languages=model.num_languages,
            language=language, task=options.task,
        )
        self.tokenizer = tokenizer
        self.options = self._verify_options(options)

        self.n_group: int = options.beam_size or options.best_of or 1
        self.n_ctx: int = model.dims.n_text_ctx
        self.sample_len: int = options.sample_len or model.dims.n_text_ctx // 2

        self.sot_sequence = tokenizer.sot_sequence
        if self.options.without_timestamps:
            self.sot_sequence = tokenizer.sot_sequence_including_notimestamps

        self.initial_tokens: Tuple[int, ...] = self._get_initial_tokens()
        self.sample_begin: int = len(self.initial_tokens)
        self.sot_index: int = self.initial_tokens.index(tokenizer.sot)
        self.max_len: int = min(self.n_ctx, self.sample_begin + self.sample_len)

        self.beam_size = options.beam_size
        self.patience = options.patience or 1.0
        self.max_candidates = (
            round(self.beam_size * self.patience) if self.beam_size else self.n_group
        )
        if self.beam_size and self.max_candidates <= 0:
            raise ValueError(
                f"Invalid beam size ({self.beam_size}) or patience ({options.patience})"
            )

        max_initial_timestamp_index = None
        if not options.without_timestamps and options.max_initial_timestamp:
            precision = CHUNK_LENGTH / model.dims.n_audio_ctx  # usually 0.02 s
            max_initial_timestamp_index = round(options.max_initial_timestamp / precision)

        self.filter_cfg = _FilterConfig(
            sample_begin=self.sample_begin,
            eot=tokenizer.eot,
            blank_tokens=tuple(tokenizer.encode(" ") + [tokenizer.eot]),
            suppress_tokens=self._get_suppress_tokens(),
            timestamp_begin=tokenizer.timestamp_begin,
            no_timestamps=tokenizer.no_timestamps,
            max_initial_timestamp_index=max_initial_timestamp_index,
            apply_blank=self.options.suppress_blank,
            apply_suppress=bool(self.options.suppress_tokens),
            apply_timestamps=not self.options.without_timestamps,
        )
        self.compute_dtype = torch.bfloat16 if options.fp16 else torch.float32
        self._sequential_xt: bool = getattr(model.extras, "sequential_gated_x_attn", False)
        self.device = model.device
        self._params = None
        self.step_graphs = StepGraphs()

    def _verify_options(self, options: DecodingOptions) -> DecodingOptions:
        if options.beam_size is not None and options.best_of is not None:
            raise ValueError("beam_size and best_of can't be given together")
        if options.temperature == 0 and options.best_of is not None:
            raise ValueError("best_of with greedy sampling (T=0) is not compatible")
        if options.patience is not None and options.beam_size is None:
            raise ValueError("patience requires beam_size to be given")
        if options.length_penalty is not None and not (0 <= options.length_penalty <= 1):
            raise ValueError("length_penalty (alpha) should be a value between 0 and 1")
        if options.quantize not in (None, "int8", "int8kv"):
            raise ValueError(f"quantize must be None, 'int8' or 'int8kv', got {options.quantize!r}")
        if options.quantize == "int8kv" and options.beam_size is None:
            # the int8 self cache takes the greedy step off the decode-attention
            # kernel, and the greedy step is not bound by the self cache
            warnings.warn(
                "quantize='int8kv' without beam_size: int8kv is the beam-mode serving "
                "variant; use 'int8' for greedy decoding",
                stacklevel=3,
            )
        return options

    def _get_initial_tokens(self) -> Tuple[int, ...]:
        tokens = list(self.sot_sequence)
        if prefix := self.options.prefix:
            prefix_tokens = (
                self.tokenizer.encode(" " + prefix.strip()) if isinstance(prefix, str) else prefix
            )
            if self.sample_len is not None:
                max_prefix_len = self.n_ctx // 2 - self.sample_len
                prefix_tokens = prefix_tokens[-max_prefix_len:]
            tokens = tokens + list(prefix_tokens)
        if prompt := self.options.prompt:
            prompt_tokens = (
                self.tokenizer.encode(" " + prompt.strip()) if isinstance(prompt, str) else prompt
            )
            prompt_tokens = list(prompt_tokens)[-(self.n_ctx // 2 - 1):]
            if self.options.bucket_prompt_lengths and prompt_tokens:
                keep = 1 << (len(prompt_tokens).bit_length() - 1)
                prompt_tokens = prompt_tokens[-keep:]
            tokens = [self.tokenizer.sot_prev] + prompt_tokens + tokens
        return tuple(tokens)

    def _get_suppress_tokens(self) -> Tuple[int, ...]:
        suppress_tokens = self.options.suppress_tokens
        if isinstance(suppress_tokens, str):
            suppress_tokens = [int(t) for t in suppress_tokens.split(",")]
        suppress_tokens = [] if suppress_tokens is None else list(suppress_tokens)
        if -1 in suppress_tokens:
            suppress_tokens = [t for t in suppress_tokens if t >= 0]
            suppress_tokens.extend(self.tokenizer.non_speech_tokens)
        suppress_tokens.extend([
            self.tokenizer.transcribe, self.tokenizer.translate, self.tokenizer.sot,
            self.tokenizer.sot_prev, self.tokenizer.sot_lm,
        ])
        if self.tokenizer.no_speech is not None:
            suppress_tokens.append(self.tokenizer.no_speech)
        return tuple(sorted(set(suppress_tokens)))

    @property
    def params(self) -> "Whisper":
        """The decode-time weights (a compute-dtype copy, made once)."""
        if self._params is None:
            self._params = prepare_decode_params(
                self.model, self.compute_dtype, quantize=self.options.quantize is not None
            )
        return self._params

    # -- the set-up of every decode loop -------------------------------------
    # ``_main_loop``, the continuous batcher's slots and speculative
    # decoding's verifier and draft start from these.

    def new_cache(self, params: "Whisper", audio_features: torch.Tensor,
                  xt: Optional[torch.Tensor] = None, extra_len: int = 0):
        """A decode cache of ``params`` (the task's copy, or a draft's) over
        ``audio_features`` and the streams ``xt``: the task's dtype and
        quantize mode, ``max_len`` + ``extra_len`` self-cache slots (a
        draft's K)."""
        quantize = self.options.quantize
        return init_cache(params, params.dims, audio_features, xt=xt,
                          max_len=self.max_len + extra_len, dtype=self.compute_dtype,
                          quantize=quantize is not None, quantize_self=quantize == "int8kv",
                          xt_at_ctx=self.streams_at_ctx)

    def prefill(self, params: "Whisper", audio_features: torch.Tensor,
                init_tokens: torch.Tensor, xt: Optional[torch.Tensor] = None,
                extra_len: int = 0):
        """(fp32 logits (B, T, V), cache) after the initial tokens, at batch B."""
        cache = self.new_cache(params, audio_features, xt, extra_len)
        return decoder_apply(params, params.dims, init_tokens, cache=cache, offset=0,
                             dtype=self.compute_dtype, sequential_xt=self._sequential_xt)

    def no_speech_probs(self, logits: torch.Tensor) -> torch.Tensor:
        """(B,) no-speech probabilities at the SOT position of the prefill's
        ``logits`` (NaN where the vocabulary has no such token)."""
        no_speech = self.tokenizer.no_speech
        if no_speech is None:
            return torch.full((logits.shape[0],), float("nan"), device=logits.device)
        return torch.softmax(logits[:, self.sot_index].float(), dim=-1)[:, no_speech]

    def first_tokens(self, logits: torch.Tensor, init_tokens: torch.Tensor, width: int,
                     caps: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The per-row greedy state after the prefill's ``logits``: ``tokens``
        (B, width), the initial tokens and the first filtered token, EOT
        after; ``lens``; ``caps`` (B,); ``finished`` (EOT or at its cap);
        ``sum_logprobs``, the first token's log-prob."""
        eot = self.tokenizer.eot
        k, init_len = init_tokens.shape
        dev = init_tokens.device
        tokens = torch.full((k, width), eot, dtype=torch.long, device=dev)
        tokens[:, :init_len] = init_tokens
        flt = _apply_filters(self.filter_cfg, logits[:, -1].float(), tokens, init_len)
        t0 = flt.argmax(dim=-1)
        tokens[:, init_len] = t0
        return {
            "tokens": tokens,
            "lens": torch.full((k,), init_len + 1, dtype=torch.long, device=dev),
            "caps": caps,
            "finished": (t0 == eot) | (init_len + 1 >= caps),
            "sum_logprobs": torch.log_softmax(flt, dim=-1).gather(1, t0[:, None])[:, 0],
        }

    # -- the decode loop ----------------------------------------------------

    def _main_loop(self, audio_features: torch.Tensor, init_tokens: torch.Tensor,
                   xt: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        dims, dtype, G = self.model.dims, self.compute_dtype, self.n_group
        eot, max_len, C = self.tokenizer.eot, self.max_len, self.max_candidates
        params, sequential_xt = self.params, self._sequential_xt
        dev = audio_features.device
        n_audio, init_len = init_tokens.shape
        n_batch = n_audio * G
        use_beam = self.beam_size is not None

        # the static K/V and the prefill run at batch B (prompts and
        # audio are the same across a row's beams)
        logits, cache = self.prefill(params, audio_features, init_tokens, xt)
        no_speech_probs = self.no_speech_probs(logits)

        # expand only the per-beam state to B * G rows
        self_keys = [k for k in ("k", "v", "k_s", "v_s") if k in cache]
        for key in self_keys:
            cache[key] = cache[key].repeat_interleave(G, dim=1)
        # beam search through the decode-attention kernel reorders a table
        # of the rows that hold each position, not the cache: a row's next
        # write lands in its own row, at a position no entry points to yet
        rows = None
        if use_beam and self_step_kernel(cache):
            t_max = cache["k"].shape[-2]
            rows = torch.arange(n_batch, dtype=torch.int32, device=dev)[:, None].repeat(1, t_max)
        last_logits = logits[:, -1].float().repeat_interleave(G, dim=0)
        tokens = torch.full((n_batch, max_len + 1), eot, dtype=torch.long, device=dev)
        tokens[:, :init_len] = init_tokens.repeat_interleave(G, dim=0)
        if use_beam:
            sum_logprobs = torch.tensor([0.0] + [NEG_INF] * (G - 1), device=dev).repeat(n_audio)
            fin_tokens = torch.full((n_audio, C, max_len + 1), eot, dtype=torch.long, device=dev)
            fin_scores = torch.full((n_audio, C), NEG_INF, device=dev)
            fin_count = torch.zeros((n_audio,), dtype=torch.long, device=dev)
        else:
            sum_logprobs = torch.zeros((n_batch,), device=dev)
        finished = torch.zeros((n_batch,), dtype=torch.bool, device=dev)
        gen = None
        if self.options.temperature > 0:
            gen = torch.Generator(device=dev).manual_seed(self.options.seed)

        cur_len = init_len
        while cur_len < max_len:
            with profiling.span("decode.step"):
                logits = _apply_filters(self.filter_cfg, last_logits, tokens, cur_len)
                if use_beam:
                    K = G + 1
                    N = G * K
                    logprobs = torch.log_softmax(logits, dim=-1)
                    top_vals, top_idx = torch.topk(logprobs, K, dim=-1)
                    cand_scores = (sum_logprobs[:, None] + top_vals).reshape(n_audio, N)
                    cand_tokens = top_idx.reshape(n_audio, N)
                    sort_idx = torch.argsort(-cand_scores, dim=1, stable=True)
                    s_scores = cand_scores.gather(1, sort_idx)
                    s_tokens = cand_tokens.gather(1, sort_idx)
                    s_is_eot = s_tokens == eot
                    nonterm = (~s_is_eot).long()
                    nonterm_rank = nonterm.cumsum(dim=1) - nonterm  # exclusive
                    iota = torch.arange(N, device=dev)[None]

                    # the G best unfinished continuations
                    order_key = torch.where(s_is_eot, N + iota, nonterm_rank)
                    beam_pos = torch.argsort(order_key, dim=1, stable=True)[:, :G]
                    sel_flat = sort_idx.gather(1, beam_pos)
                    sel_scores = s_scores.gather(1, beam_pos)
                    sel_token = s_tokens.gather(1, beam_pos)
                    src_global = (
                        torch.arange(n_audio, device=dev)[:, None] * G + sel_flat // K
                    ).reshape(-1)

                    # newly finished sequences -> the fixed-capacity buffer
                    eligible = s_is_eot & (nonterm_rank < G)
                    elig = eligible.long()
                    elig_rank = elig.cumsum(dim=1) - elig
                    n_elig = elig.sum(dim=1)
                    elig_key = torch.where(eligible, elig_rank, N + iota)
                    elig_pos = torch.argsort(elig_key, dim=1, stable=True)
                    elig_flat = sort_idx.gather(1, elig_pos)
                    elig_scores = torch.where(
                        iota < n_elig[:, None], s_scores.gather(1, elig_pos),
                        torch.full((), NEG_INF, device=dev),
                    )
                    slot = torch.arange(C, device=dev)[None]
                    take_src = slot - fin_count[:, None]
                    valid = (take_src >= 0) & (take_src < n_elig[:, None])
                    take_clip = take_src.clamp(0, N - 1)
                    fin_scores = torch.where(valid, elig_scores.gather(1, take_clip), fin_scores)
                    src_beam_fin = elig_flat.gather(1, take_clip) // K  # (B, C)
                    fin_rows = tokens.reshape(n_audio, G, -1)[
                        torch.arange(n_audio, device=dev)[:, None], src_beam_fin
                    ]  # (B, C, L), from the tokens before the reorder
                    fin_rows[:, :, cur_len] = eot
                    fin_tokens = torch.where(valid[:, :, None], fin_rows, fin_tokens)
                    fin_count = (fin_count + n_elig).clamp(max=C)

                    tokens = tokens.index_select(0, src_global)
                    tokens[:, cur_len] = sel_token.reshape(-1)
                    sum_logprobs = sel_scores.reshape(-1)
                    # the surviving beams' history: only the written prefix matters
                    if rows is not None:
                        pre = rows[:, :cur_len]
                        pre.copy_(pre.index_select(0, src_global))
                        profiling.count("decode.reorder_indirect")
                    else:
                        for key in self_keys:
                            pre = cache[key][:, :, :cur_len]
                            pre.copy_(pre.index_select(1, src_global))
                        profiling.count("decode.reorder_copied")
                    completed = (fin_count >= C).all()
                else:
                    if gen is None:
                        next_tokens = logits.argmax(dim=-1)
                    else:  # Gumbel-max sampling with the task's generator
                        u = torch.rand(logits.shape, generator=gen, device=dev)
                        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
                        next_tokens = (logits / self.options.temperature + gumbel).argmax(dim=-1)
                    logprobs = torch.log_softmax(logits, dim=-1)
                    current = logprobs.gather(1, next_tokens[:, None])[:, 0]
                    sum_logprobs = sum_logprobs + current * (~finished)
                    next_tokens = torch.where(finished, torch.full_like(next_tokens, eot),
                                              next_tokens)
                    tokens[:, cur_len] = next_tokens
                    finished = finished | (next_tokens == eot)
                    completed = finished.all()
                cur_len += 1
                if cur_len >= max_len:
                    break  # the last step's logits would go unread
                with profiling.span("decode.sync"):
                    done = bool(completed)
                if done:
                    break
                with profiling.span("decode.forward"), decode_attn.beam_rows(rows):
                    new_logits, cache = decoder_apply(
                        params, dims, tokens[:, cur_len - 1: cur_len], cache=cache,
                        offset=cur_len - 1, dtype=dtype, sequential_xt=sequential_xt,
                        step_graphs=self.step_graphs,
                    )
                last_logits = new_logits[:, -1].float()

        out = {
            "tokens": tokens,
            "sum_logprobs": sum_logprobs,
            "no_speech_probs": no_speech_probs.repeat_interleave(G, dim=0),
        }
        if use_beam:
            out.update(fin_tokens=fin_tokens, fin_scores=fin_scores, fin_count=fin_count)
        return out

    # -- host-side finalize -------------------------------------------------

    def _finalize(self, out) -> Tuple[List[List[np.ndarray]], List[List[float]]]:
        """Candidate sequences and scores per audio."""
        G = self.n_group
        eot = self.tokenizer.eot
        tokens = out["tokens"]
        sum_logprobs = out["sum_logprobs"]
        B = tokens.shape[0] // G
        grouped = tokens.reshape(B, G, -1)
        lps = sum_logprobs.reshape(B, G)
        if self.beam_size is None:
            return (
                [[grouped[i, j] for j in range(G)] for i in range(B)],
                [list(map(float, lps[i])) for i in range(B)],
            )
        all_tokens, all_scores = [], []
        for i in range(B):
            n = int(out["fin_count"][i])
            seqs = [out["fin_tokens"][i, c] for c in range(n)]
            scores = [float(out["fin_scores"][i, c]) for c in range(n)]
            if len(seqs) < self.beam_size:
                for j in np.argsort(lps[i])[::-1]:
                    seqs.append(np.concatenate([grouped[i, j], [eot]]))
                    scores.append(float(lps[i, j]))
                    if len(seqs) >= self.beam_size:
                        break
            all_tokens.append(seqs)
            all_scores.append(scores)
        return all_tokens, all_scores

    def _rank(self, tokens: List[List[np.ndarray]], sum_logprobs: List[List[float]]) -> List[int]:
        """GNMT length-penalty ranking."""
        alpha = self.options.length_penalty

        def scores(logprobs, lengths):
            return [
                lp / (length if alpha is None else ((5 + length) / 6) ** alpha)
                for lp, length in zip(logprobs, lengths)
            ]

        lengths = [[len(t) for t in s] for s in tokens]
        return [int(np.argmax(scores(p, l))) for p, l in zip(sum_logprobs, lengths)]

    # -- public API ---------------------------------------------------------

    @torch.no_grad()
    def run(self, mel, xt=None) -> List[DecodingResult]:
        """``mel`` (B, n_mels, T) or precomputed features; ``xt`` optional
        conditioning streams (n_langs, B, S, D) for the gated decoder. Under
        data ranks each decodes its block of rows (a ragged batch padded
        by repeating the last row) and the results are gathered."""
        mesh = getattr(self.model, "mesh", None)
        if mesh is None or mesh.n_data == 1:
            return self._run(mel, xt)
        from .parallel.mesh import DATA_AXIS, shard_batch

        rows = shard_batch({"mel": mel} if xt is None else {"mel": mel, "xt": xt}, mesh)
        local = self._run(rows["mel"], rows.get("xt"))
        gathered = mesh.all_gather_object(local, DATA_AXIS)
        return [r for part in gathered for r in part][: len(mel)]

    def _run(self, mel, xt=None) -> List[DecodingResult]:
        tokenizer = self.tokenizer
        dev = self.device
        mel = torch.as_tensor(mel).to(dev)
        n_audio = mel.shape[0]
        audio_features = _features(self.model, mel, self.compute_dtype)

        init = np.tile(np.asarray(self.initial_tokens, np.int64), (n_audio, 1))
        languages = [self.options.language] * n_audio
        language_probs: List[Optional[dict]] = [None] * n_audio
        if self.options.language is None or self.options.task == "lang_id":
            lang_tokens, language_probs = detect_language(self.model, audio_features, tokenizer)
            languages = [max(p, key=p.get) for p in language_probs]
            if self.options.language is None:
                init[:, self.sot_index + 1] = np.asarray(lang_tokens).reshape(-1)
        if self.options.task == "lang_id":
            af = self._host_features(audio_features, n_audio)
            return [
                DecodingResult(audio_features=af[i], language=languages[i],
                               language_probs=language_probs[i])
                for i in range(n_audio)
            ]

        if xt is not None:
            xt = torch.as_tensor(xt).to(dev)
        out = self._main_loop(audio_features, torch.from_numpy(init).to(dev), xt)
        out = {k: v.cpu().numpy() for k, v in out.items()}  # one transfer

        G = self.n_group
        no_speech_probs = out["no_speech_probs"][::G]
        cand_tokens, cand_scores = self._finalize(out)
        sliced: List[List[np.ndarray]] = []
        for seqs in cand_tokens:
            rows = []
            for t in seqs:
                t = np.asarray(t)
                eots = np.nonzero(t[self.sample_begin:] == tokenizer.eot)[0]
                end = self.sample_begin + (eots[0] if len(eots) else len(t))
                rows.append(t[self.sample_begin:end])
            sliced.append(rows)

        selected = self._rank(sliced, cand_scores)
        final_tokens = [sliced[i][selected[i]].tolist() for i in range(n_audio)]
        texts = [tokenizer.decode(t).strip() for t in final_tokens]
        final_scores = [cand_scores[i][selected[i]] for i in range(n_audio)]
        avg_logprobs = [lp / (len(t) + 1) for t, lp in zip(final_tokens, final_scores)]
        af = self._host_features(audio_features, n_audio)
        return [
            DecodingResult(
                audio_features=af[i], language=languages[i], tokens=final_tokens[i],
                text=texts[i], avg_logprob=float(avg_logprobs[i]),
                no_speech_prob=float(no_speech_probs[i]),
                temperature=self.options.temperature,
                compression_ratio=compression_ratio(texts[i]),
            )
            for i in range(n_audio)
        ]

    def _host_features(self, audio_features: torch.Tensor, n_audio: int):
        if self.options.return_audio_features:
            host = audio_features.float().cpu().numpy()
            return [host[i] for i in range(n_audio)]
        return [None] * n_audio


def decode(
    model: "Whisper", mel, options: DecodingOptions = DecodingOptions(), xt=None, **kwargs,
) -> Union[DecodingResult, List[DecodingResult]]:
    """Decode 30-second mel segment(s) on the model's device. ``xt``
    optionally supplies gated x-attn conditioning streams (n_langs, B, S, D)."""
    mel = torch.as_tensor(mel)
    single = mel.dim() == 2
    if single:
        mel = mel[None]
        if xt is not None:
            xt = torch.as_tensor(xt)
            if xt.dim() == 3:  # (n_langs, S, D) -> add the batch axis
                xt = xt[:, None]
    if kwargs:
        options = replace(options, **kwargs)
    result = DecodingTask(model, options).run(mel, xt=xt)
    return result[0] if single else result
