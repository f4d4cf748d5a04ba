"""Seeded random weights, made on the device in a few large calls.

The benchmark makes the weights itself and hands the same state dict to the
program (``load_state_dict`` into the port's modules) and to the plain
reference, which reads them by the OpenAI / HF key names. The layout is the
published one; the values are random (no checkpoint is in the repo):

- linear and conv weights N(0, 1/fan_in), token embedding N(0, 1/D),
  learned positions 0.01 N(0, 1), BERT's tables N(0, 0.02);
- biases and LayerNorm offsets 0.02 N(0, 1), LayerNorm scales
  1 + 0.02 N(0, 1), so that no bias or norm path is trivially zero;
- the Flamingo gates at the configuration's ``gate_value``.

One normal draw fills a flat buffer; every tensor is a scaled view of it,
so the seed alone fixes every weight, on any card.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...], str, float]]  # name, shape, kind, scale


def _linear(out: Spec, name: str, n_in: int, n_out: int, bias: bool = True) -> None:
    out.append((f"{name}.weight", (n_out, n_in), "normal", n_in ** -0.5))
    if bias:
        out.append((f"{name}.bias", (n_out,), "normal", 0.02))


def _norm(out: Spec, name: str, d: int) -> None:
    out.append((f"{name}.weight", (d,), "one_plus", 0.02))
    out.append((f"{name}.bias", (d,), "normal", 0.02))


def _mha(out: Spec, name: str, d: int) -> None:
    _linear(out, f"{name}.query", d, d)
    _linear(out, f"{name}.key", d, d, bias=False)
    _linear(out, f"{name}.value", d, d)
    _linear(out, f"{name}.out", d, d)


def _mlp(out: Spec, name: str, d: int) -> None:
    _linear(out, f"{name}.0", d, 4 * d)
    _linear(out, f"{name}.2", 4 * d, d)


def whisper_spec(dims: Dict[str, int], extras: Dict[str, int], gate_value: float = 0.0) -> Spec:
    """Every parameter of a (Flamingo) Whisper under its OpenAI key name."""
    d_a, d_t, n_mels = dims["n_audio_state"], dims["n_text_state"], dims["n_mels"]
    out: Spec = [
        ("encoder.conv1.weight", (d_a, n_mels, 3), "normal", (3 * n_mels) ** -0.5),
        ("encoder.conv1.bias", (d_a,), "normal", 0.02),
        ("encoder.conv2.weight", (d_a, d_a, 3), "normal", (3 * d_a) ** -0.5),
        ("encoder.conv2.bias", (d_a,), "normal", 0.02),
    ]
    for i in range(dims["n_audio_layer"]):
        p = f"encoder.blocks.{i}"
        _mha(out, f"{p}.attn", d_a)
        _norm(out, f"{p}.attn_ln", d_a)
        _mlp(out, f"{p}.mlp", d_a)
        _norm(out, f"{p}.mlp_ln", d_a)
    _norm(out, "encoder.ln_post", d_a)
    out.append(("decoder.token_embedding.weight", (dims["n_vocab"], d_t), "normal", d_t ** -0.5))
    out.append(("decoder.positional_embedding", (dims["n_text_ctx"], d_t), "normal", 0.01))
    gated = bool(extras.get("add_gated_x_attn"))
    n_streams = max(int(extras.get("num_langs", 0)), 1) if gated else 0
    for i in range(dims["n_text_layer"]):
        p = f"decoder.blocks.{i}"
        _mha(out, f"{p}.attn", d_t)
        _norm(out, f"{p}.attn_ln", d_t)
        _mha(out, f"{p}.cross_attn", d_t)
        _norm(out, f"{p}.cross_attn_ln", d_t)
        _mlp(out, f"{p}.mlp", d_t)
        _norm(out, f"{p}.mlp_ln", d_t)
        for j in range(n_streams):
            g = f"{p}.gated_x_attn_layers.{j}"
            _mha(out, f"{g}.attn", d_t)
            _norm(out, f"{g}.attn_ln", d_t)
            out.append((f"{g}.attn_gate", (1,), "fill", gate_value))
        if n_streams:
            _norm(out, f"{p}.ff_ln", d_t)
            _mlp(out, f"{p}.ff", d_t)
            out.append((f"{p}.ff_gate", (1,), "fill", gate_value))
    _norm(out, "decoder.ln", d_t)
    bert_dim = int(extras.get("bert_dim", d_t))
    if gated and bert_dim != d_t:
        _linear(out, "decoder.xt_projection", bert_dim, d_t)
    return out


def bert_spec(bert: Dict[str, float]) -> Spec:
    """Every parameter of a BERT encoder (no pooler) under HF's key names,
    ``bert.`` stripped."""
    d, f = int(bert["hidden_size"]), int(bert["intermediate_size"])
    std = float(bert.get("initializer_range", 0.02))
    out: Spec = [
        ("embeddings.word_embeddings.weight", (int(bert["vocab_size"]), d), "normal", std),
        ("embeddings.position_embeddings.weight",
         (int(bert["max_position_embeddings"]), d), "normal", std),
        ("embeddings.token_type_embeddings.weight", (int(bert["type_vocab_size"]), d),
         "normal", std),
    ]
    _norm(out, "embeddings.LayerNorm", d)
    for i in range(int(bert["num_hidden_layers"])):
        p = f"encoder.layer.{i}"
        for name in ("query", "key", "value"):
            _linear(out, f"{p}.attention.self.{name}", d, d)
        _linear(out, f"{p}.attention.output.dense", d, d)
        _norm(out, f"{p}.attention.output.LayerNorm", d)
        _linear(out, f"{p}.intermediate.dense", d, f)
        _linear(out, f"{p}.output.dense", f, d)
        _norm(out, f"{p}.output.LayerNorm", d)
    return out


def make_state(spec: Spec, seed: int, device, salt: int = 0) -> Dict[str, torch.Tensor]:
    """fp32 tensors of ``spec`` from one normal draw of a generator on
    ``device`` seeded by ``seed`` (and ``salt``, to tell two models of one
    run apart). The tensors are views of one buffer."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + salt) % (2 ** 63))
    sizes = [int(torch.Size(shape).numel()) for _, shape, _, _ in spec]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    flat.normal_(0.0, 1.0, generator=gen)
    state: Dict[str, torch.Tensor] = {}
    off = 0
    with torch.no_grad():
        for (name, shape, kind, scale), n in zip(spec, sizes):
            t = flat[off: off + n].view(shape)
            off += n
            if kind == "normal":
                t.mul_(scale)
            elif kind == "one_plus":
                t.mul_(scale).add_(1.0)
            elif kind == "fill":
                t.fill_(scale)
            else:
                raise ValueError(f"unknown init kind {kind!r} for {name}")
            state[name] = t
    return state
