"""Word-level timestamps: cross-attention alignment and DTW.

Port of ``whisper_flamingo_tpu/timing.py``:

- :func:`find_alignment` runs one teacher-forced forward over the window
  that returns the audio cross-attention logits
  (``decoder_apply(return_cross_qk=True)``), keeps the alignment heads,
  and computes in the reference's eager order: slice to the window's
  frames -> softmax -> z-norm over the tokens -> median filter -> mean
  over the heads. The matrix stays on the model's device; the DTW
  (:mod:`.ops.dtw`, the CUDA kernel on the card) gets its negated text
  rows as one contiguous fp32 tensor, and only the trace comes back;
- :func:`merge_punctuations` and :func:`add_word_timestamps` keep the
  reference's boundary rules (punctuation gluing, the clamps of
  anomalous durations at sentence and segment edges) statement for
  statement: they are the word-timestamp spec.

Left out, each a TPU workaround: the token bucket of the alignment
program, and the masked softmax, masked z-norm and reflect-into-pad that
exist only because of that bucket (the port slices first). As in the JAX
package, the alignment pass encodes the window's mel again.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import TYPE_CHECKING, List

import numpy as np
import torch

from .audio import HOP_LENGTH, SAMPLE_RATE, TOKENS_PER_SECOND
from .models.whisper import decoder_apply, encoder_apply
from .ops import dtw as dtw_ops
from .ops.median import median_filter
from .tokenizer import Tokenizer

if TYPE_CHECKING:
    from .models.whisper import Whisper


@dataclass
class WordTiming:
    word: str
    tokens: List[int]
    start: float
    end: float
    probability: float


@torch.no_grad()
def alignment_matrix(
    model: "Whisper",
    tokenizer: Tokenizer,
    text_tokens: List[int],
    mel,
    num_frames: int,
    *,
    medfilt_width: int = 7,
    qk_scale: float = 1.0,
):
    """(text token probabilities (n_text,) on the host, alignment matrix
    (n_tok, num_frames // 2) fp32 on the model's device) for one window."""
    dev = model.device
    tokens = torch.tensor(
        [*tokenizer.sot_sequence, tokenizer.no_timestamps, *text_tokens, tokenizer.eot],
        dtype=torch.long, device=dev,
    )
    mel = torch.as_tensor(mel).to(dev)
    if mel.dim() == 2:
        mel = mel[None]
    n_sot = len(tokenizer.sot_sequence)

    features = encoder_apply(model, model.dims, mel, dtype=model.dtype)
    logits, qks = decoder_apply(
        model, model.dims, tokens[None], features, dtype=model.dtype, return_cross_qk=True
    )
    # row n_sot + k predicts text token k
    sampled = logits[0, n_sot:, : tokenizer.eot].float()
    token_probs = torch.softmax(sampled, dim=-1)
    rows = torch.arange(len(text_tokens), device=dev)
    text_token_probs = token_probs[rows, tokens[n_sot + 1: n_sot + 1 + len(text_tokens)]]

    heads = torch.from_numpy(np.argwhere(model.get_alignment_heads())).to(dev)
    weights = qks[heads[:, 0], 0, heads[:, 1]][:, :, : num_frames // 2]  # (n_sel, T, nfh)
    weights = torch.softmax(weights.float() * qk_scale, dim=-1)
    std, mean = torch.std_mean(weights, dim=-2, keepdim=True, correction=0)
    weights = median_filter((weights - mean) / std, medfilt_width)
    return text_token_probs.cpu().numpy(), weights.mean(dim=0)


def find_alignment(
    model: "Whisper",
    tokenizer: Tokenizer,
    text_tokens: List[int],
    mel,
    num_frames: int,
    *,
    medfilt_width: int = 7,
    qk_scale: float = 1.0,
) -> List[WordTiming]:
    """Word timings of ``text_tokens`` in one window, on the model's device."""
    if len(text_tokens) == 0:
        return []

    probs, matrix = alignment_matrix(
        model, tokenizer, text_tokens, mel, num_frames,
        medfilt_width=medfilt_width, qk_scale=qk_scale,
    )
    text_token_probs = probs.tolist()
    n_sot = len(tokenizer.sot_sequence)
    n_tok = n_sot + len(text_tokens) + 2
    cost = (-matrix[n_sot: n_tok - 1]).contiguous()
    text_indices, time_indices = dtw_ops.dtw(cost)

    words, word_tokens = tokenizer.split_to_word_tokens(list(text_tokens) + [tokenizer.eot])
    if len(word_tokens) <= 1:
        return []
    word_boundaries = np.pad(np.cumsum([len(t) for t in word_tokens[:-1]]), (1, 0))

    jumps = np.pad(np.diff(text_indices), (1, 0), constant_values=1).astype(bool)
    jump_times = time_indices[jumps] / TOKENS_PER_SECOND
    start_times = jump_times[word_boundaries[:-1]]
    end_times = jump_times[word_boundaries[1:]]
    word_probabilities = [
        np.mean(text_token_probs[i:j])
        for i, j in zip(word_boundaries[:-1], word_boundaries[1:])
    ]

    return [
        WordTiming(word, tokens_, float(start), float(end), float(probability))
        for word, tokens_, start, end, probability in zip(
            words, word_tokens, start_times, end_times, word_probabilities
        )
    ]


def merge_punctuations(alignment: List[WordTiming], prepended: str, appended: str):
    # merge prepended punctuations
    i = len(alignment) - 2
    j = len(alignment) - 1
    while i >= 0:
        previous = alignment[i]
        following = alignment[j]
        if previous.word.startswith(" ") and previous.word.strip() in prepended:
            following.word = previous.word + following.word
            following.tokens = previous.tokens + following.tokens
            previous.word = ""
            previous.tokens = []
        else:
            j = i
        i -= 1

    # merge appended punctuations
    i = 0
    j = 1
    while j < len(alignment):
        previous = alignment[i]
        following = alignment[j]
        if not previous.word.endswith(" ") and following.word in appended:
            previous.word = previous.word + following.word
            previous.tokens = previous.tokens + following.tokens
            following.word = ""
            following.tokens = []
        else:
            i = j
        j += 1


def add_word_timestamps(
    *,
    segments: List[dict],
    model: "Whisper",
    tokenizer: Tokenizer,
    mel,
    num_frames: int,
    prepend_punctuations: str = "\"'“¿([{-",
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
    last_speech_timestamp: float,
    **kwargs,
):
    """Attach ``words`` to each segment of one window (the reference's
    median-duration truncations at sentence and segment boundaries
    included)."""
    if len(segments) == 0:
        return

    text_tokens_per_segment = [
        [token for token in segment["tokens"] if token < tokenizer.eot]
        for segment in segments
    ]

    text_tokens = list(itertools.chain.from_iterable(text_tokens_per_segment))
    alignment = find_alignment(model, tokenizer, text_tokens, mel, num_frames, **kwargs)
    word_durations = np.array([t.end - t.start for t in alignment])
    word_durations = word_durations[word_durations.nonzero()]
    median_duration = np.median(word_durations) if len(word_durations) > 0 else 0.0
    max_duration = median_duration * 2

    # truncate long words at sentence boundaries
    if len(word_durations) > 0:
        sentence_end_marks = ".。!！?？"
        for i in range(1, len(alignment)):
            if alignment[i].end - alignment[i].start > max_duration:
                if alignment[i].word in sentence_end_marks:
                    alignment[i].end = alignment[i].start + max_duration
                elif alignment[i - 1].word in sentence_end_marks:
                    alignment[i].start = alignment[i].end - max_duration

    merge_punctuations(alignment, prepend_punctuations, append_punctuations)

    time_offset = segments[0]["seek"] * HOP_LENGTH / SAMPLE_RATE
    word_index = 0

    for segment, seg_text_tokens in zip(segments, text_tokens_per_segment):
        saved_tokens = 0
        words = []

        while word_index < len(alignment) and saved_tokens < len(seg_text_tokens):
            timing = alignment[word_index]
            if timing.word:
                words.append(
                    dict(
                        word=timing.word,
                        start=round(time_offset + timing.start, 2),
                        end=round(time_offset + timing.end, 2),
                        probability=timing.probability,
                    )
                )
            saved_tokens += len(timing.tokens)
            word_index += 1

        # truncate long words at segment boundaries
        if len(words) > 0:
            if words[0]["end"] - last_speech_timestamp > median_duration * 4 and (
                words[0]["end"] - words[0]["start"] > max_duration
                or (
                    len(words) > 1
                    and words[1]["end"] - words[0]["start"] > max_duration * 2
                )
            ):
                if len(words) > 1 and words[1]["end"] - words[1]["start"] > max_duration:
                    boundary = max(words[1]["end"] / 2, words[1]["end"] - max_duration)
                    words[0]["end"] = words[1]["start"] = boundary
                words[0]["start"] = max(0, words[0]["end"] - max_duration)

            # prefer the segment-level start/end when words run long
            if (
                segment["start"] < words[0]["end"]
                and segment["start"] - 0.5 > words[0]["start"]
            ):
                words[0]["start"] = max(
                    0, min(words[0]["end"] - median_duration, segment["start"])
                )
            else:
                segment["start"] = words[0]["start"]

            if (
                segment["end"] > words[-1]["start"]
                and segment["end"] + 0.5 < words[-1]["end"]
            ):
                words[-1]["end"] = max(
                    words[-1]["start"] + median_duration, segment["end"]
                )
            else:
                segment["end"] = words[-1]["end"]

            last_speech_timestamp = segment["end"]

        segment["words"] = words
