"""Plain word alignment: the cross-attention weights of a teacher-forced
Whisper forward, the alignment matrix and a NumPy DTW.

The published word-timestamp procedure (OpenAI Whisper's ``timing.py``)
in float32 PyTorch and NumPy over the state dict ``whisper_ref`` reads:

- the window's tokens (the start-of-transcript sequence, no-timestamps,
  the text tokens, end-of-text) teacher-forced through the decoder; the
  audio cross-attention logits (q and k each scaled by d_head^-0.25) of
  the alignment heads (the published bitmap, decoded here), cut to the window's frames, softmax over frames,
  normalised over the tokens (zero mean, unit standard deviation), a
  median filter of width 7 along the frames (reflected at the ends), the
  mean over the heads;
- the DTW over the negated text rows: each cell adds its cost to the least
  of its three predecessors (diagonal first, then the row above, then the
  column before, on ties), then the path walked back from the last cell.
"""

from __future__ import annotations

import base64
import gzip
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import whisper_ref
from .whisper_ref import _ln, _lin, _mlp, fp8


def _cross(sd, name: str, x: torch.Tensor, kv: torch.Tensor, n_head: int,
           lowp: Optional[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention's output and its fp32 logits (B, H, T, S)."""
    q = _lin(sd, f"{name}.query", x, lowp)
    k, v = _lin(sd, f"{name}.key", kv, lowp), _lin(sd, f"{name}.value", kv, lowp)
    b, t, d = q.shape
    s, dh = k.shape[1], d // n_head
    scale = dh ** -0.25
    qh = q.view(b, t, n_head, dh).transpose(1, 2) * scale
    kh = k.view(b, s, n_head, dh).transpose(1, 2) * scale
    vh = v.view(b, s, n_head, dh).transpose(1, 2)
    w = qh @ kh.transpose(-1, -2)
    out = (torch.softmax(w, dim=-1) @ vh).transpose(1, 2).reshape(b, t, d)
    return _lin(sd, f"{name}.out", out, lowp), w


def decoder_with_cross(sd, dims, tokens: torch.Tensor, features: torch.Tensor,
                       lowp: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced logits (B, T, V) of a plain Whisper and its audio
    cross-attention logits (L, B, H, T, S)."""
    t = tokens.shape[1]
    x = sd["decoder.token_embedding.weight"][tokens] + sd["decoder.positional_embedding"][:t]
    h = dims["n_text_head"]
    qks = []
    for i in range(dims["n_text_layer"]):
        p = f"decoder.blocks.{i}"
        y = _ln(sd, f"{p}.attn_ln", x)
        x = x + whisper_ref.attention(sd, f"{p}.attn", y, y, h, causal=True, lowp=lowp)
        out, qk = _cross(sd, f"{p}.cross_attn", _ln(sd, f"{p}.cross_attn_ln", x), features, h,
                         lowp)
        x = x + out
        qks.append(qk)
        x = x + _mlp(sd, f"{p}.mlp", _ln(sd, f"{p}.mlp_ln", x), lowp)
    x = _ln(sd, "decoder.ln", x)
    emb = sd["decoder.token_embedding.weight"]
    if lowp == "fp8":
        x, emb = fp8(x), fp8(emb)
    return x @ emb.t(), torch.stack(qks)


def median_filter(x: torch.Tensor, width: int) -> torch.Tensor:
    """Median over a sliding window of odd ``width`` along the last axis,
    reflected at the ends; an axis no longer than half the width passes
    unfiltered, as in the published code."""
    pad = width // 2
    if x.shape[-1] <= pad:
        return x
    y = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    return y.unfold(-1, width, 1).median(dim=-1).values.reshape(x.shape)


# The published alignment heads (base85 of the gzipped (layers, heads) bool
# bitmap), as OpenAI Whisper's ``_ALIGNMENT_HEADS`` gives them
PUBLISHED_HEADS = {
    "large-v2": b"ABzY8zd+h!0{>%R7=D0pU<_bnWW*tkYAhobTNnu$jnkEkXqp)j;w1Tzk)UH3X%SZd&fFZ2fC2yj",
}


def alignment_heads(name: str, n_layer: int, n_head: int) -> List[Tuple[int, int]]:
    """(layer, head) of the published heads of ``name``; every head of the
    decoder's second half for a model with none published."""
    if name in PUBLISHED_HEADS:
        bits = np.frombuffer(gzip.decompress(base64.b85decode(PUBLISHED_HEADS[name])), bool)
        bits = bits.reshape(n_layer, n_head)
    else:
        bits = np.zeros((n_layer, n_head), bool)
        bits[n_layer // 2:] = True
    return [(int(l), int(h)) for l, h in np.argwhere(bits)]


def weights(qks: torch.Tensor, heads: Sequence[Tuple[int, int]], num_frames: int) -> torch.Tensor:
    """(heads, tokens, num_frames // 2) softmax over the window's frames of
    the cross logits (L, 1, H, T, S) at the alignment ``heads``."""
    w = torch.stack([qks[l, 0, h] for l, h in heads])[:, :, : num_frames // 2]
    return torch.softmax(w.float(), dim=-1)


def matrix_from_weights(w: torch.Tensor, medfilt_width: int = 7) -> torch.Tensor:
    """(tokens, frames) alignment matrix of the heads' ``weights``."""
    std, mean = torch.std_mean(w, dim=-2, keepdim=True, correction=0)
    return median_filter((w - mean) / std, medfilt_width).mean(dim=0)


def alignment_matrix(qks: torch.Tensor, heads: Sequence[Tuple[int, int]], num_frames: int,
                     medfilt_width: int = 7) -> torch.Tensor:
    """(tokens, num_frames // 2) matrix of one window from its cross logits
    (L, 1, H, T, S) at the alignment ``heads`` (layer, head)."""
    return matrix_from_weights(weights(qks, heads, num_frames), medfilt_width)


def dtw(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The monotonic path (text indices, time indices) of cost ``x`` (N, M)."""
    n, m = x.shape
    inf = float("inf")
    rows = x.astype(np.float32).tolist()
    cost = [[inf] * (m + 1) for _ in range(n + 1)]
    trace = [[-1] * (m + 1) for _ in range(n + 1)]
    cost[0][0] = 0.0
    for j in range(1, m + 1):
        for i in range(1, n + 1):
            c0, c1, c2 = cost[i - 1][j - 1], cost[i - 1][j], cost[i][j - 1]
            if c0 < c1 and c0 < c2:
                c, t = c0, 0
            elif c1 < c0 and c1 < c2:
                c, t = c1, 1
            else:
                c, t = c2, 2
            cost[i][j] = float(np.float32(rows[i - 1][j - 1]) + np.float32(c))
            trace[i][j] = t
    i, j = n, m
    path: List[Tuple[int, int]] = []
    while i > 0 or j > 0:
        path.append((i - 1, j - 1))
        t = 0 if i > 0 and j > 0 and trace[i][j] == 0 else (
            1 if j == 0 or (i > 0 and trace[i][j] == 1) else 2)
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    path.reverse()
    out = np.array(path).T
    return out[0], out[1]


def path_cost(x: np.ndarray, text: np.ndarray, time: np.ndarray) -> float:
    """The summed cost of ``x`` along a path."""
    keep = (text >= 0) & (time >= 0)
    return float(x[text[keep], time[keep]].astype(np.float64).sum())
