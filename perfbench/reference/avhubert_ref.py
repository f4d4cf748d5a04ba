"""Plain float32 AV-HuBERT trunk (video only), with the parameter layout.

The published trunk (Shi et al., arXiv 2201.02184; AV-HuBERT's
``ResEncoder`` and ``TransformerEncoder``) over a state dict with fairseq's
key names as the port keeps them, in float32 ``torch`` operations: no
kernel, no cache, no batching across requests. With ``whisper_ref`` (which
projects the features by ``xt_projection`` and attends to them in the gated
blocks) it is the reference of the whole audio-visual Whisper-Flamingo.

- lip-video front end: Conv3d 1 -> 64, kernel (5, 7, 7), stride (1, 2, 2),
  padding (2, 3, 3), no bias; BatchNorm with its stored statistics (eps
  1e-5); per-channel PReLU; max pool (1, 3, 3), stride (1, 2, 2), padding
  (0, 1, 1); then each frame alone through a ResNet-18 of BasicBlocks
  [2, 2, 2, 2] (conv 3x3, BatchNorm, PReLU, conv 3x3, BatchNorm, the
  shortcut a strided 1x1 conv and BatchNorm where the shape changes, add,
  PReLU) and the mean over the 2-D map: 512 per frame;
- ``proj`` 512 -> D;
- the positional embedding: a grouped Conv1d (kernel K, ``groups``
  groups, padding K // 2) whose last output frame is dropped (K even),
  exact GELU, added;
- pre-LN layers: x + out(softmax(q k^T / sqrt(d_head)) v) of LN(x), then x
  + fc2(GELU(fc1(LN(x)))); the final LayerNorm after the layers. LayerNorm
  eps 1e-5.

Departures from the published model, each the port's too: the
fine-tuned checkpoint's audio trunk and modality fusion are absent (the
video-only ``large`` trunk of ``video_encoder: large``); the positional
conv's weight norm is folded into one weight; dropout and layer drop are
off (evaluation).

``lowp="fp8"`` is the control of the ``correct`` checks, as in
``whisper_ref``: every product with a weight (the convolutions and the
linears) takes its input and its weight rounded to float8 e4m3 under a
per-tensor scale, and accumulates in float32.

:func:`trunk_spec` lists every parameter and statistic in the layout of
``perfbench.weights`` (name, shape, kind, scale), so that the benchmark's
seeded weights reach the program and this reference alike.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .whisper_ref import fp8

State = Dict[str, torch.Tensor]
Spec = List[Tuple[str, Tuple[int, ...], str, float]]

STAGES = (("layer1", 64, 1), ("layer2", 128, 2), ("layer3", 256, 2), ("layer4", 512, 2))
RESNET = "feature_extractor_video.resnet"


# -- the parameter layout -------------------------------------------------------

def _bn(out: Spec, name: str, c: int) -> None:
    out.append((f"{name}.weight", (c,), "one_plus", 0.02))
    out.append((f"{name}.bias", (c,), "normal", 0.02))
    out.append((f"{name}.running_mean", (c,), "normal", 0.02))
    out.append((f"{name}.running_var", (c,), "one_plus", 0.02))


def _conv(out: Spec, name: str, shape: Tuple[int, ...]) -> None:
    fan_in = 1
    for n in shape[1:]:
        fan_in *= n
    out.append((f"{name}.weight", shape, "normal", fan_in ** -0.5))


def _linear(out: Spec, name: str, n_in: int, n_out: int) -> None:
    out.append((f"{name}.weight", (n_out, n_in), "normal", n_in ** -0.5))
    out.append((f"{name}.bias", (n_out,), "normal", 0.02))


def _ln(out: Spec, name: str, d: int) -> None:
    out.append((f"{name}.weight", (d,), "one_plus", 0.02))
    out.append((f"{name}.bias", (d,), "normal", 0.02))


def trunk_spec(trunk: Dict[str, int]) -> Spec:
    """Every parameter and BatchNorm statistic of the video-only trunk of
    shape ``trunk`` (``embed_dim``, ``n_layers``, ``n_heads``, ``ffn_dim``,
    ``conv_pos``, ``conv_pos_groups``, ``frontend_dim``) under its key
    name: conv and linear weights N(0, 1/fan_in), biases, BatchNorm
    shifts and running means 0.02 N(0, 1), BatchNorm scales and running
    variances and LayerNorm scales 1 + 0.02 N(0, 1), PReLU slopes 0.25."""
    d, f = trunk["embed_dim"], trunk["ffn_dim"]
    out: Spec = []
    _conv(out, f"{RESNET}.frontend3D.0", (64, 1, 5, 7, 7))
    _bn(out, f"{RESNET}.frontend3D.1", 64)
    out.append((f"{RESNET}.frontend3D.2.weight", (64,), "fill", 0.25))
    inplanes = 64
    for stage, planes, stride in STAGES:
        for i in range(2):
            p = f"{RESNET}.{stage}.{i}"
            c_in, s = (inplanes, stride) if i == 0 else (planes, 1)
            _conv(out, f"{p}.conv1", (planes, c_in, 3, 3))
            _bn(out, f"{p}.bn1", planes)
            out.append((f"{p}.relu1.weight", (planes,), "fill", 0.25))
            _conv(out, f"{p}.conv2", (planes, planes, 3, 3))
            _bn(out, f"{p}.bn2", planes)
            out.append((f"{p}.relu2.weight", (planes,), "fill", 0.25))
            if s != 1 or c_in != planes:
                _conv(out, f"{p}.downsample.0", (planes, c_in, 1, 1))
                _bn(out, f"{p}.downsample.1", planes)
        inplanes = planes
    _linear(out, "feature_extractor_video.proj", trunk["frontend_dim"], d)
    k, g = trunk["conv_pos"], trunk["conv_pos_groups"]
    _conv(out, "encoder.pos_conv.0", (d, d // g, k))
    out.append(("encoder.pos_conv.0.bias", (d,), "normal", 0.02))
    for i in range(trunk["n_layers"]):
        p = f"encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(out, f"{p}.self_attn.{name}", d, d)
        _ln(out, f"{p}.self_attn_layer_norm", d)
        _linear(out, f"{p}.fc1", d, f)
        _linear(out, f"{p}.fc2", f, d)
        _ln(out, f"{p}.final_layer_norm", d)
    _ln(out, "encoder.layer_norm", d)
    return out


# -- the forward ----------------------------------------------------------------

def _low(x: torch.Tensor, w: torch.Tensor, lowp: Optional[str]):
    return (fp8(x), fp8(w)) if lowp == "fp8" else (x, w)


def _batch_norm(sd: State, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.batch_norm(x, sd[f"{name}.running_mean"], sd[f"{name}.running_var"],
                        sd[f"{name}.weight"], sd[f"{name}.bias"], training=False, eps=1e-5)


def _conv2d(sd: State, name: str, x: torch.Tensor, stride: int, padding: int,
            lowp: Optional[str]) -> torch.Tensor:
    x, w = _low(x, sd[f"{name}.weight"], lowp)
    return F.conv2d(x, w, None, stride, padding)


def _block(sd: State, p: str, x: torch.Tensor, stride: int, lowp: Optional[str]) -> torch.Tensor:
    out = _conv2d(sd, f"{p}.conv1", x, stride, 1, lowp)
    out = F.prelu(_batch_norm(sd, f"{p}.bn1", out), sd[f"{p}.relu1.weight"])
    out = _batch_norm(sd, f"{p}.bn2", _conv2d(sd, f"{p}.conv2", out, 1, 1, lowp))
    short = x
    if f"{p}.downsample.0.weight" in sd:
        short = _batch_norm(sd, f"{p}.downsample.1",
                            _conv2d(sd, f"{p}.downsample.0", x, stride, 0, lowp))
    return F.prelu(out + short, sd[f"{p}.relu2.weight"])


def frontend(sd: State, video: torch.Tensor, lowp: Optional[str] = None) -> torch.Tensor:
    """(B, T, H, W) lip crops -> (B, T, 512) frame features."""
    b, t = video.shape[:2]
    x, w = _low(video[:, None], sd[f"{RESNET}.frontend3D.0.weight"], lowp)
    x = F.conv3d(x, w, None, (1, 2, 2), (2, 3, 3))
    x = F.prelu(_batch_norm(sd, f"{RESNET}.frontend3D.1", x), sd[f"{RESNET}.frontend3D.2.weight"])
    x = F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))  # (B, 64, T, h, w)
    c, h, w = x.shape[1], x.shape[3], x.shape[4]
    x = x.transpose(1, 2).reshape(b * t, c, h, w)  # each frame alone
    for stage, _, stride in STAGES:
        for i in range(2):
            x = _block(sd, f"{RESNET}.{stage}.{i}", x, stride if i == 0 else 1, lowp)
    return x.mean(dim=(2, 3)).reshape(b, t, -1)


def _lin(sd: State, name: str, x: torch.Tensor, lowp: Optional[str]) -> torch.Tensor:
    x, w = _low(x, sd[f"{name}.weight"], lowp)
    return F.linear(x, w, sd[f"{name}.bias"])


def _layer_norm(sd: State, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], sd[f"{name}.weight"], sd[f"{name}.bias"], 1e-5)


def _self_attention(sd: State, p: str, x: torch.Tensor, n_heads: int,
                    lowp: Optional[str]) -> torch.Tensor:
    b, t, d = x.shape
    dh = d // n_heads

    def heads(name):
        return _lin(sd, f"{p}.{name}", x, lowp).view(b, t, n_heads, dh).transpose(1, 2)

    q, k, v = heads("q_proj"), heads("k_proj"), heads("v_proj")
    w = torch.softmax(q @ k.transpose(-1, -2) / dh ** 0.5, dim=-1)
    return _lin(sd, f"{p}.out_proj", (w @ v).transpose(1, 2).reshape(b, t, d), lowp)


@contextlib.contextmanager
def _no_tf32():
    """float32 products in float32 on the card: TF32 off for the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@torch.no_grad()
def trunk(sd: State, cfg: Dict[str, int], video: torch.Tensor,
          lowp: Optional[str] = None) -> torch.Tensor:
    """(B, T, H, W) normalised lip crops -> (B, T, embed_dim) features, with
    TF32 off."""
    with _no_tf32():
        return _trunk(sd, cfg, video, lowp)


def _trunk(sd: State, cfg: Dict[str, int], video: torch.Tensor,
           lowp: Optional[str]) -> torch.Tensor:
    x = _lin(sd, "feature_extractor_video.proj", frontend(sd, video, lowp), lowp)
    k, g = cfg["conv_pos"], cfg["conv_pos_groups"]
    xc, w = _low(x.transpose(1, 2), sd["encoder.pos_conv.0.weight"], lowp)
    pos = F.conv1d(xc, w, sd["encoder.pos_conv.0.bias"], padding=k // 2, groups=g)
    if k % 2 == 0:
        pos = pos[..., :-1]
    x = x + F.gelu(pos.transpose(1, 2))
    for i in range(cfg["n_layers"]):
        p = f"encoder.layers.{i}"
        x = x + _self_attention(sd, f"{p}.self_attn", _layer_norm(sd, f"{p}.self_attn_layer_norm",
                                                                   x), cfg["n_heads"], lowp)
        y = _layer_norm(sd, f"{p}.final_layer_norm", x)
        x = x + _lin(sd, f"{p}.fc2", F.gelu(_lin(sd, f"{p}.fc1", y, lowp)), lowp)
    return _layer_norm(sd, "encoder.layer_norm", x)
