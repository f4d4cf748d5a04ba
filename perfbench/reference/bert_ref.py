"""Plain BERT encoder (last hidden state, no pooler) and the offline byte
tokenizer, as the conditioner feeds them.

Tokens: ``[1] + [2 + (b % (vocab - 3)) for each UTF-8 byte] + [2]``, cut to
``max_length``, padded with 0 to the longest row and then to a multiple of
``pad_multiple`` (at most ``max_length``); the mask is 1 on real tokens.
Encoder: word + type-0 + position embeddings, LayerNorm; post-LN layers of
softmax(q k^T / sqrt(d_head) + bias) v with the bias 0 on real keys and
float32's minimum on padded ones, output dense, residual, LayerNorm, then
the exact-GELU FFN, residual, LayerNorm. float32 throughout."""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def tokenize(texts: Sequence[str], vocab_size: int, max_length: int,
             pad_multiple: int) -> Tuple[np.ndarray, np.ndarray]:
    rows = [[1] + [2 + (b % (vocab_size - 3)) for b in t.encode("utf-8")][: max_length - 2] + [2]
            for t in texts]
    n = max(len(r) for r in rows)
    n = min(-(-n // pad_multiple) * pad_multiple, max_length)
    ids = np.zeros((len(rows), n), np.int64)
    mask = np.zeros((len(rows), n), np.int64)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = r
        mask[i, : len(r)] = 1
    return ids, mask


def encode(sd: Dict[str, torch.Tensor], bert: Dict[str, float], ids: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    b, s = ids.shape
    d, h = int(bert["hidden_size"]), int(bert["num_attention_heads"])
    dh, eps = d // h, float(bert["layer_norm_eps"])

    def ln(name, x):
        return F.layer_norm(x, (d,), sd[f"{name}.weight"], sd[f"{name}.bias"], eps)

    def lin(name, x):
        return F.linear(x, sd[f"{name}.weight"], sd[f"{name}.bias"])

    def heads(t):
        return t.view(b, s, h, dh).transpose(1, 2)

    x = (sd["embeddings.word_embeddings.weight"][ids]
         + sd["embeddings.token_type_embeddings.weight"][0]
         + sd["embeddings.position_embeddings.weight"][:s])
    x = ln("embeddings.LayerNorm", x)
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, torch.finfo(torch.float32).min)
    for i in range(int(bert["num_hidden_layers"])):
        p = f"encoder.layer.{i}"
        q = heads(lin(f"{p}.attention.self.query", x)) / math.sqrt(dh)
        k = heads(lin(f"{p}.attention.self.key", x))
        v = heads(lin(f"{p}.attention.self.value", x))
        ctx = (torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1) @ v)
        ctx = ctx.transpose(1, 2).reshape(b, s, d)
        x = ln(f"{p}.attention.output.LayerNorm", lin(f"{p}.attention.output.dense", ctx) + x)
        inner = F.gelu(lin(f"{p}.intermediate.dense", x))
        x = ln(f"{p}.output.LayerNorm", lin(f"{p}.output.dense", inner) + x)
    return x


def encode_streams(sd, bert, streams: Sequence[Sequence[str]], max_length: int,
                   pad_multiple: int, device) -> torch.Tensor:
    """(n_streams lists of B strings) -> (n_streams, B, S, D), each stream
    zero-padded to the longest stream's S."""
    out = []
    for texts in streams:
        ids, mask = tokenize(texts, int(bert["vocab_size"]), max_length, pad_multiple)
        out.append(encode(sd, bert, torch.from_numpy(ids).to(device),
                          torch.from_numpy(mask).to(device)))
    s_max = max(o.shape[1] for o in out)
    return torch.stack([F.pad(o, (0, 0, 0, s_max - o.shape[1])) for o in out])
