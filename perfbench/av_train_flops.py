"""Operations (multiply-add = 2) of one Whisper-Flamingo step-2 training step,
from shapes.

Each product of the step counts once in the forward, and once more in the
backward for each of its operands that needs a gradient: the activation's
when it depends on a trained weight, the weight's when it is trained. So

- the frozen trunk, the frozen encoder and ``xt_projection`` (their inputs
  detached) count once;
- the frozen decoder sub-blocks count twice (forward, activation gradient),
  but for the cross-attention's K/V projections of the detached audio
  features, once, and the self-attention's two products, three times (q, k
  and v all carry the gradient); the logits twice;
- the gated blocks count three times (forward, activation and weight
  gradients), but for their K/V projections of the detached video
  features, twice (no activation gradient), and the first layer's gated
  q projection, twice (its input, the embedding, is frozen).

The remat recompute is not counted. LayerNorm, softmax, GELU, the gates and
the trunk's BatchNorm, PReLU and pooling are elementwise and left out, as in
:mod:`perfbench.flops`. Every length is the padded one the device computes.
"""

from __future__ import annotations

from typing import Dict

from . import av_flops
from . import flops as F


def decoder_flops(dims: Dict[str, int], text_len: int, audio_len: int, video_len: int) -> float:
    """One row's decoder forward and backward: gated blocks, frozen
    sub-blocks and the logits."""
    d, t, ta, s = dims["n_text_state"], text_len, audio_len, video_len
    lin = 2 * t * d * d  # one d x d projection of the text positions
    gated = (2 * lin * 3  # q, out
             + 2 * (2 * s * d * d) * 2  # K, V of the video features
             + 2 * (2 * t * s * d) * 3  # QK^T, PV
             + 2 * (2 * t * d * 4 * d) * 3)  # the gated FFN
    frozen = (4 * lin * 2  # self-attention q, k, v, out
              + 2 * (2 * t * t * d) * 3  # its QK^T, PV
              + 2 * lin * 2  # cross-attention q, out
              + 2 * (2 * ta * d * d)  # K, V of the audio features
              + 2 * (2 * t * ta * d) * 2  # QK^T, PV over the audio
              + 2 * (2 * t * d * 4 * d) * 2)  # the MLP
    first_q = lin  # layer 0's gated q projection: no activation gradient
    logits = 2 * t * d * dims["n_vocab"] * 2
    return float(dims["n_text_layer"] * (gated + frozen) - first_q + logits)


def step_flops(cfg: dict, rows: int, mel_frames: int, text_len: int, video_frames: int) -> float:
    """One step over ``rows`` clips padded to ``mel_frames`` mel frames,
    ``text_len`` tokens and ``video_frames`` video frames."""
    dims, v = cfg["dims"], cfg["video"]
    d, bert = dims["n_text_state"], int(cfg["extras"]["bert_dim"])
    ta = min(mel_frames // 2, dims["n_audio_ctx"])
    row = av_flops.trunk_flops(cfg["trunk"], video_frames, v["height"], v["width"])
    row += F.encoder_flops(dims, mel_frames)
    if bert != d:
        row += 2 * video_frames * bert * d  # xt_projection
    row += decoder_flops(dims, text_len, ta, video_frames)
    return float(rows * row)
