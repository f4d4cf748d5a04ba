"""Plain float32 Whisper with Flamingo gated cross-attention.

The published equations over a state dict with the OpenAI key names (and
the Whisper-Flamingo fork's ``gated_x_attn_layers`` / ``ff`` / ``ff_gate`` /
``xt_projection``) in float32: no kernel, no cache, no batching across
requests. It reads only the benchmark's own weights and inputs.

- encoder: conv1 (k3, p1) + GELU, conv2 (k3, s2, p1) + GELU, sinusoidal
  positions, pre-LN blocks (self-attention, MLP), final LN;
- attention: q and k each scaled by d_head^-0.25, softmax, the key
  projection without bias;
- decoder, teacher-forced: token embedding + learned positions; in a gated
  block first the parallel gated cross-attention over the text streams
  (each stream's attention from LN(x) of the block input, times
  tanh(gate), summed into x) and the tanh-gated FFN; then causal
  self-attention, cross-attention to the audio, MLP; final LN; logits
  against the tied embedding;
- the streams: ``xt_projection`` when the conditioner's width differs,
  then the decoder's learned positions over the stream length.

GELU is the exact erf form; LayerNorm eps 1e-5.

``lowp="fp8"`` is the control of the ``correct`` checks: every product with
a weight (the linears and the logits) takes its input and its weight
rounded to float8 e4m3, each tensor scaled so that its largest magnitude is
e4m3's largest (448), and accumulates in float32, as an fp8 GEMM does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

State = Dict[str, torch.Tensor]


def sinusoids(length: int, channels: int, max_timescale: float = 10000) -> torch.Tensor:
    log_inc = math.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32))


def _ln(sd: State, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], sd[f"{name}.weight"], sd[f"{name}.bias"], 1e-5)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in fp32;
    under autograd the rounding passes the gradient straight through."""
    with torch.no_grad():
        scale = t.abs().amax().clamp_min(1e-30) / 448.0
        q = (t / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach() if t.requires_grad else q


def _lin(sd: State, name: str, x: torch.Tensor, lowp: Optional[str] = None) -> torch.Tensor:
    w = sd[f"{name}.weight"]
    if lowp == "fp8":
        x, w = fp8(x), fp8(w)
    return F.linear(x, w, sd.get(f"{name}.bias"))


def attention(sd: State, name: str, x: torch.Tensor, kv: torch.Tensor, n_head: int,
              causal: bool = False, lowp: Optional[str] = None) -> torch.Tensor:
    q = _lin(sd, f"{name}.query", x, lowp)
    k, v = _lin(sd, f"{name}.key", kv, lowp), _lin(sd, f"{name}.value", kv, lowp)
    b, t, d = q.shape
    s, dh = k.shape[1], d // n_head
    scale = dh ** -0.25
    qh = q.view(b, t, n_head, dh).transpose(1, 2) * scale
    kh = k.view(b, s, n_head, dh).transpose(1, 2) * scale
    vh = v.view(b, s, n_head, dh).transpose(1, 2)
    w = qh @ kh.transpose(-1, -2)
    if causal:
        w = w + torch.full((t, s), float("-inf"), device=x.device).triu(1)
    out = (torch.softmax(w, dim=-1) @ vh).transpose(1, 2).reshape(b, t, d)
    return _lin(sd, f"{name}.out", out, lowp)


def _mlp(sd: State, name: str, x: torch.Tensor, lowp: Optional[str] = None) -> torch.Tensor:
    return _lin(sd, f"{name}.2", F.gelu(_lin(sd, f"{name}.0", x, lowp)), lowp)


def encoder(sd: State, dims: Dict[str, int], mel: torch.Tensor,
            lowp: Optional[str] = None) -> torch.Tensor:
    """mel (B, n_mels, 3000) -> features (B, 1500, D)."""
    x = F.gelu(F.conv1d(mel, sd["encoder.conv1.weight"], sd["encoder.conv1.bias"], padding=1))
    x = F.gelu(F.conv1d(x, sd["encoder.conv2.weight"], sd["encoder.conv2.bias"],
                        stride=2, padding=1)).transpose(1, 2)
    x = x[:, : dims["n_audio_ctx"]]
    x = x + sinusoids(dims["n_audio_ctx"], dims["n_audio_state"]).to(x.device)[: x.shape[1]]
    h = dims["n_audio_head"]
    for i in range(dims["n_audio_layer"]):
        p = f"encoder.blocks.{i}"
        y = _ln(sd, f"{p}.attn_ln", x)
        x = x + attention(sd, f"{p}.attn", y, y, h, lowp=lowp)
        x = x + _mlp(sd, f"{p}.mlp", _ln(sd, f"{p}.mlp_ln", x), lowp)
    return _ln(sd, "encoder.ln_post", x)


def prepare_streams(sd: State, xt: torch.Tensor, lowp: Optional[str] = None) -> torch.Tensor:
    """(n_streams, B, S, bert_dim) conditioner output -> (n_streams, B, S, D)."""
    if "decoder.xt_projection.weight" in sd:
        xt = _lin(sd, "decoder.xt_projection", xt, lowp)
    return xt + sd["decoder.positional_embedding"][: xt.shape[2]]


def decoder_logits(sd: State, dims: Dict[str, int], tokens: torch.Tensor,
                   features: torch.Tensor, xt: Optional[torch.Tensor] = None,
                   lowp: Optional[str] = None) -> torch.Tensor:
    """Teacher-forced fp32 logits (B, T, V) of ``tokens`` (B, T) given the
    audio features and, for a gated model, the streams (from
    :func:`prepare_streams`)."""
    t = tokens.shape[1]
    x = sd["decoder.token_embedding.weight"][tokens] + sd["decoder.positional_embedding"][:t]
    h = dims["n_text_head"]
    for i in range(dims["n_text_layer"]):
        p = f"decoder.blocks.{i}"
        if f"{p}.ff_gate" in sd:
            if xt is not None:
                delta = torch.zeros_like(x)
                for j in range(xt.shape[0]):
                    g = f"{p}.gated_x_attn_layers.{j}"
                    a = attention(sd, f"{g}.attn", _ln(sd, f"{g}.attn_ln", x), xt[j], h,
                                  lowp=lowp)
                    delta = delta + a * torch.tanh(sd[f"{g}.attn_gate"])
                x = x + delta
            ff = _mlp(sd, f"{p}.ff", _ln(sd, f"{p}.ff_ln", x), lowp)
            x = x + ff * torch.tanh(sd[f"{p}.ff_gate"])
        y = _ln(sd, f"{p}.attn_ln", x)
        x = x + attention(sd, f"{p}.attn", y, y, h, causal=True, lowp=lowp)
        x = x + attention(sd, f"{p}.cross_attn", _ln(sd, f"{p}.cross_attn_ln", x), features, h,
                          lowp=lowp)
        x = x + _mlp(sd, f"{p}.mlp", _ln(sd, f"{p}.mlp_ln", x), lowp)
    x = _ln(sd, "decoder.ln", x)
    emb = sd["decoder.token_embedding.weight"]
    if lowp == "fp8":
        x, emb = fp8(x), fp8(emb)
    return x @ emb.t()


def filtered_logprobs(logits: torch.Tensor, suppressed, blank, first_pos: int) -> torch.Tensor:
    """log-softmax over the allowed vocabulary: the ``suppressed`` ids at
    every position, and the ``blank`` ids at position ``first_pos`` of the
    sequence axis (the first sampled token), are removed."""
    logits = logits.clone()
    logits[..., list(suppressed)] = float("-inf")
    logits[..., first_pos, list(blank)] = float("-inf")
    return torch.log_softmax(logits, dim=-1)
