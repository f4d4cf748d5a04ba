"""Operations (multiply-add = 2) of the work a window completed, from shapes.

The encoder and teacher-forced decoder arithmetic is that of the port's
``profiling.model_flops`` (kept here so the yardstick cannot move with the
program); the cached decode counts each generated token at its own position.
LayerNorms, softmax, GELU and the mel front end are left out: they are
elementwise and a fraction of a percent of the products.
"""

from __future__ import annotations

from typing import Dict, Sequence

Dims = Dict[str, int]


def encoder_flops(dims: Dims, mel_frames: int = 3000) -> float:
    """One clip through the conv stem and the encoder blocks."""
    ta = min(mel_frames // 2, dims["n_audio_ctx"])
    d, n_mels = dims["n_audio_state"], dims["n_mels"]
    conv = 2 * mel_frames * 3 * n_mels * d + 2 * ta * 3 * d * d
    layer = 4 * 2 * ta * d * d + 2 * 2 * ta * ta * d + 2 * 2 * ta * d * 4 * d
    return float(conv + dims["n_audio_layer"] * layer)


def model_flops(dims: Dims, batch: int, mel_frames: int = 3000, text_len: int = 128,
                n_xt_streams: int = 0, xt_len: int = 0) -> float:
    """Forward operations of one teacher-forced batch (``profiling.model_flops``)."""
    ta = min(mel_frames // 2, dims["n_audio_ctx"])
    dt, t = dims["n_text_state"], text_len
    dec_layer = (
        4 * 2 * t * dt * dt
        + 2 * 2 * t * t * dt
        + 2 * 2 * dt * dt * ta
        + 2 * 2 * t * dt * dt
        + 2 * 2 * t * ta * dt
        + 2 * 2 * t * dt * 4 * dt
        + n_xt_streams * (4 * 2 * t * dt * dt + 2 * 2 * t * xt_len * dt + 2 * 2 * t * dt * 4 * dt)
    )
    decoder = dims["n_text_layer"] * dec_layer + 2 * t * dt * dims["n_vocab"]
    return float(batch * (encoder_flops(dims, mel_frames) + decoder))


def static_kv_flops(dims: Dims, n_streams: int = 0, xt_len: int = 0, bert_dim: int = 0) -> float:
    """One audio's cross-attention K/V slabs (and its streams' gated K/V and
    width projection), computed once when its cache is made."""
    d, ta, lt = dims["n_text_state"], dims["n_audio_ctx"], dims["n_text_layer"]
    total = lt * 2 * 2 * ta * d * d
    if n_streams:
        total += lt * n_streams * 2 * 2 * xt_len * d * d
        if bert_dim and bert_dim != d:
            total += n_streams * 2 * xt_len * bert_dim * d
    return float(total)


def token_flops(dims: Dims, pos: int, n_streams: int = 0, xt_len: int = 0) -> float:
    """One decoder token at position ``pos`` through the cached decoder:
    projections, attention over pos + 1 self keys, the audio and the streams,
    the MLPs and the logits."""
    d, ta = dims["n_text_state"], dims["n_audio_ctx"]
    layer = (
        4 * 2 * d * d + 2 * 2 * (pos + 1) * d
        + 2 * 2 * d * d + 2 * 2 * ta * d
        + 2 * 2 * d * 4 * d
    )
    if n_streams:
        layer += n_streams * (2 * 2 * d * d + 2 * 2 * xt_len * d) + 2 * 2 * d * 4 * d
    return float(dims["n_text_layer"] * layer + 2 * d * dims["n_vocab"])


def decode_flops(dims: Dims, positions: Sequence[int], n_streams: int = 0,
                 xt_len: int = 0) -> float:
    """The cached decoder's tokens at ``positions`` (prefill and steps)."""
    return sum(token_flops(dims, p, n_streams, xt_len) for p in positions)


def bert_flops(bert: Dict[str, float], rows: int, seq: int) -> float:
    """A BERT encoder over ``rows`` sequences of ``seq`` tokens."""
    d, f = int(bert["hidden_size"]), int(bert["intermediate_size"])
    layer = 4 * 2 * seq * d * d + 2 * 2 * seq * seq * d + 2 * 2 * seq * d * f
    return float(rows * int(bert["num_hidden_layers"]) * layer)
