"""The AV-HuBERT encoder and the audio-visual Whisper wrapper, in PyTorch.

Port of ``whisper_flamingo_tpu/models/avhubert.py``:

- :class:`VideoEncoder`, the AV-HuBERT trunk: the lip-video frontend
  (:mod:`.visual`) projected 512 -> D, optionally fused with the stacked
  log-filterbank audio stream (``concat``: LayerNorm(2D) then Linear(2D ->
  D), or ``add``), a grouped convolutional positional embedding (kernel
  128 in 16 groups for the released sizes), pre-LN (``large``) or post-LN
  (``base``) transformer layers. The modules carry fairseq's key names
  (``encoder.layers.{i}.self_attn.q_proj``, ``encoder.pos_conv.0``,
  ``feature_extractor_video.resnet.*``, ``feature_extractor_audio.proj``,
  ``layer_norm``, ``post_extract_proj``), so :func:`load_avhubert_torch`
  maps a fairseq checkpoint by key, rebuilding the weight-normed
  ``pos_conv``;
- :func:`avhubert_encoder_apply` / :func:`video_encoder_apply`, plain
  functions over that tree, with the JAX package's names and numerics
  (fp32 LayerNorm islands, exact GELU, the attention's fp32 logits and
  softmax). The trunk's attention is the plain path: the JAX package runs
  it through XLA, not through a kernel of the repo;
- :func:`stacked_fbank_features`, the avsr audio input, a numpy copy of the
  JAX package's (bit-equal);
- :class:`AVWhisper`, Whisper with the trunk's features as the gated
  cross-attention stream, the ``test_a`` / ``test_v`` modality masks and
  train-time modality dropout drawn from an explicit ``torch.Generator``.
  Its decode entry holds one ``DecodingTask`` for its options over every
  batch, the gated slabs at the decoder's stream cap (``n_text_ctx``), so
  that batches of any video length share one step-graph key.

Spans: ``av.trunk`` (:func:`avhubert_encoder_apply`), inside it
``av.frontend`` (the lip-video ResNet) and ``av.transformer`` (the
positional conv, the layers and the last LayerNorm). Counters:
``av.frames`` (the clips' own video frames through the trunk) and
``av.pad_frames`` (the frames padding to the batch's longest clip adds).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import profiling
from ..decoding import DecodingOptions, DecodingTask
from ..ops.attention import qkv_attention
from ..utils import resolve_device
from .dims import ModelDimensions
from .visual import (
    VisualFrontend,
    init_visual_frontend,
    load_visual_frontend_torch,
    visual_frontend_apply,
)
from .whisper import Whisper, encoder_apply, gelu, layer_norm, linear


@dataclass(frozen=True)
class VideoEncoderConfig:
    """AV-HuBERT encoder shape. large_noise_pt_noise_ft_433h: 24 layers,
    1024 dim, 16 heads; base: 12 layers, 768 dim, 12 heads.

    ``audio_feat_dim`` enables the audio trunk (``--modalities avsr``):
    stacked log-filterbank features (26 mels x 4 frames = 104 at 25 fps)
    projected to the embed dim and fused with the video stream before the
    transformer, by ``modality_fuse`` ``"concat"`` (the released
    checkpoints') or ``"add"``. ``None`` is the video-only trunk."""

    embed_dim: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    ffn_dim: int = 4096
    conv_pos: int = 128
    conv_pos_groups: int = 16
    frontend_dim: int = 512
    layer_norm_first: bool = True
    audio_feat_dim: Optional[int] = None
    modality_fuse: str = "concat"

    @property
    def fused_dim(self) -> int:
        if self.audio_feat_dim is None or self.modality_fuse == "add":
            return self.embed_dim
        return 2 * self.embed_dim


VIDEO_ENCODER_CONFIGS = {
    # video-only trunks (--modalities vsr checkpoints)
    "large": VideoEncoderConfig(),
    "base": VideoEncoderConfig(embed_dim=768, n_layers=12, n_heads=12, ffn_dim=3072,
                               layer_norm_first=False),
    # audio+video trunks (--modalities avsr, e.g. large_noise_pt_noise_ft_433h)
    "large-avsr": VideoEncoderConfig(audio_feat_dim=104),
    "base-avsr": VideoEncoderConfig(embed_dim=768, n_layers=12, n_heads=12,
                                    ffn_dim=3072, layer_norm_first=False,
                                    audio_feat_dim=104),
    "debug": VideoEncoderConfig(embed_dim=64, n_layers=2, n_heads=2, ffn_dim=128,
                                conv_pos=8, conv_pos_groups=2),
    # tiny audio+video trunk for tests
    "debug-av": VideoEncoderConfig(embed_dim=64, n_layers=2, n_heads=2, ffn_dim=128,
                                   conv_pos=8, conv_pos_groups=2, audio_feat_dim=8),
}


# ---------------------------------------------------------------------------
# Modules (fairseq's key names)
# ---------------------------------------------------------------------------

class _SelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)


class TransformerLayer(nn.Module):
    def __init__(self, d: int, ffn: int):
        super().__init__()
        self.self_attn = _SelfAttention(d)
        self.self_attn_layer_norm = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d, ffn)
        self.fc2 = nn.Linear(ffn, d)
        self.final_layer_norm = nn.LayerNorm(d)


class _Transformer(nn.Module):
    def __init__(self, cfg: VideoEncoderConfig):
        super().__init__()
        d = cfg.embed_dim
        self.pos_conv = nn.Sequential(
            nn.Conv1d(d, d, cfg.conv_pos, padding=cfg.conv_pos // 2, groups=cfg.conv_pos_groups)
        )
        self.layers = nn.ModuleList(TransformerLayer(d, cfg.ffn_dim) for _ in range(cfg.n_layers))
        self.layer_norm = nn.LayerNorm(d)  # after the layers (pre-LN) or before them


class _VideoFeatures(nn.Module):
    def __init__(self, cfg: VideoEncoderConfig):
        super().__init__()
        self.resnet = VisualFrontend()
        self.proj = nn.Linear(cfg.frontend_dim, cfg.embed_dim)


class _AudioFeatures(nn.Module):
    def __init__(self, cfg: VideoEncoderConfig):
        super().__init__()
        self.proj = nn.Linear(cfg.audio_feat_dim, cfg.embed_dim)


class VideoEncoder(nn.Module):
    """The AV-HuBERT trunk's parameter tree; ``cfg`` is its shape. No
    parameter requires grad (the trunk is frozen in every recipe)."""

    def __init__(self, cfg: VideoEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor_video = _VideoFeatures(cfg)
        if cfg.audio_feat_dim is not None:
            self.feature_extractor_audio = _AudioFeatures(cfg)
            self.layer_norm = nn.LayerNorm(cfg.fused_dim)  # the fused features'
            if cfg.fused_dim != cfg.embed_dim:
                self.post_extract_proj = nn.Linear(cfg.fused_dim, cfg.embed_dim)
        self.encoder = _Transformer(cfg)
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.encoder.layer_norm.weight.device


# ---------------------------------------------------------------------------
# Compute
# ---------------------------------------------------------------------------

def _conv_pos_embed(p: nn.Conv1d, x: torch.Tensor, cfg: VideoEncoderConfig) -> torch.Tensor:
    """Grouped temporal conv positional embedding over (B, T, D); an even
    kernel drops the last frame; exact GELU."""
    out = F.conv1d(x.transpose(1, 2), p.weight.to(x.dtype), p.bias.to(x.dtype),
                   padding=cfg.conv_pos // 2, groups=cfg.conv_pos_groups)
    if cfg.conv_pos % 2 == 0:
        out = out[..., :-1]
    return gelu(out.transpose(1, 2))


def _mask_rows(feat: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return feat
    return feat * mask.to(feat.dtype)[:, None, None]


def _mlp(p: TransformerLayer, x: torch.Tensor) -> torch.Tensor:
    return linear(p.fc2, gelu(linear(p.fc1, x)))


def _self_attention(p: _SelfAttention, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    q, k, v = linear(p.q_proj, x), linear(p.k_proj, x), linear(p.v_proj, x)
    return linear(p.out_proj, qkv_attention(q, k, v, n_heads))


def avhubert_encoder_apply(
    params: VideoEncoder,
    cfg: VideoEncoderConfig,
    video: Optional[torch.Tensor] = None,
    audio: Optional[torch.Tensor] = None,
    *,
    video_mask: Optional[torch.Tensor] = None,
    audio_mask: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32,
    lengths: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """The AV-HuBERT encoder over either or both modalities, under the span
    ``av.trunk``.

    ``video``: (B, T, H, W) lip crops; ``audio``: (B, T, audio_feat_dim)
    stacked log-filterbank features at the 25 fps video rate. A missing
    modality contributes zeros; the fused feature is cat([audio, video])
    (the audio leads) -> LayerNorm(2D) -> Linear(2D -> D) for ``concat``.
    ``video_mask`` / ``audio_mask``: optional (B,) bools; a False row has
    that stream's projected features zeroed before the fusion (a zero
    input alone is not zero after the conv biases and the LayerNorms).
    ``lengths``: each clip's own frame count, the rest of T its padding
    (only counted: every frame goes through the trunk). Returns (B, T,
    embed_dim)."""
    if video is None and audio is None:
        raise ValueError("at least one of video/audio must be given")
    b, t = (video if video is not None else audio).shape[:2]
    real = b * t if lengths is None else int(sum(lengths))
    profiling.count("av.frames", real)
    profiling.count("av.pad_frames", b * t - real)
    with profiling.span("av.trunk"):
        return _trunk(params, cfg, video, audio, video_mask, audio_mask, dtype)


def _trunk(params, cfg, video, audio, video_mask, audio_mask, dtype) -> torch.Tensor:
    vfeat = None
    if video is not None:
        fx = params.feature_extractor_video
        feats = visual_frontend_apply(fx.resnet, video, dtype=dtype)
        vfeat = _mask_rows(linear(fx.proj, feats), video_mask)

    if cfg.audio_feat_dim is None:
        if vfeat is None:
            raise ValueError("video-only trunk (audio_feat_dim=None) needs video")
        x = vfeat
    else:
        afeat = None
        if audio is not None:
            afeat = _mask_rows(
                linear(params.feature_extractor_audio.proj, audio.to(dtype)), audio_mask
            )
        if vfeat is None:
            vfeat = torch.zeros_like(afeat)
        if afeat is None:
            afeat = torch.zeros_like(vfeat)
        if cfg.modality_fuse == "concat":
            x = torch.cat([afeat, vfeat], dim=-1)
        else:  # "add"
            x = afeat + vfeat
        x = layer_norm(params.layer_norm, x)
        if hasattr(params, "post_extract_proj"):
            x = linear(params.post_extract_proj, x)

    with profiling.span("av.transformer"):
        return _transformer(params.encoder, cfg, x)


def _transformer(enc: _Transformer, cfg: VideoEncoderConfig, x: torch.Tensor) -> torch.Tensor:
    x = x + _conv_pos_embed(enc.pos_conv[0], x, cfg)
    if not cfg.layer_norm_first:
        x = layer_norm(enc.layer_norm, x)
    for lp in enc.layers:
        if cfg.layer_norm_first:  # pre-LN (large)
            x = x + _self_attention(lp.self_attn, layer_norm(lp.self_attn_layer_norm, x),
                                    cfg.n_heads)
            x = x + _mlp(lp, layer_norm(lp.final_layer_norm, x))
        else:  # post-LN (base)
            x = layer_norm(lp.self_attn_layer_norm, x + _self_attention(lp.self_attn, x,
                                                                        cfg.n_heads))
            x = layer_norm(lp.final_layer_norm, x + _mlp(lp, x))
    if cfg.layer_norm_first:
        x = layer_norm(enc.layer_norm, x)
    return x


def video_encoder_apply(
    params: VideoEncoder, cfg: VideoEncoderConfig, frames: torch.Tensor, *,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(B, T, H, W) lip crops -> (B, T, embed_dim); the video-only entry
    (``--modalities vsr``). With an audio trunk the audio stream is zeros."""
    return avhubert_encoder_apply(params, cfg, video=frames, dtype=dtype)


def stacked_fbank_features(
    audio: "np.ndarray", sample_rate: int = 16000, *,
    n_filters: int = 26, stack_order: int = 4,
    normalize: bool = True,
) -> "np.ndarray":
    """Waveform -> (T_25fps, n_filters*stack_order) stacked log filterbank.

    AV-HuBERT's audio frontend: a 26-mel log filterbank at 100 fps (25 ms
    window, 10 ms hop, HTK mel scale, power spectrum of a 512-point rFFT,
    0.97 pre-emphasis: the python_speech_features ``logfbank`` defaults),
    then every 4 consecutive frames concatenated to one 104-dim vector at
    the 25 fps video rate (the tail group zero-padded). ``normalize``
    applies AV-HuBERT's per-frame layer norm over the stacked dims. Host
    numpy, the JAX package's code."""
    audio = np.asarray(audio, np.float32)
    if audio.ndim != 1:
        audio = audio.reshape(-1)
    emph = np.concatenate([audio[:1], audio[1:] - 0.97 * audio[:-1]])
    win, hop, nfft = int(0.025 * sample_rate), int(0.01 * sample_rate), 512
    n_frames = 1 + max(0, int(np.ceil((len(emph) - win) / hop)))
    pad = (n_frames - 1) * hop + win - len(emph)
    emph = np.pad(emph, (0, max(0, pad)))
    idx = np.arange(win)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = emph[idx]
    power = np.abs(np.fft.rfft(frames, nfft)) ** 2 / nfft  # (T, 257)

    # HTK mel filterbank, lowfreq 0 .. highfreq sr/2
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10 ** (m / 2595.0) - 1.0)

    mel_pts = mel_to_hz(np.linspace(0.0, hz_to_mel(sample_rate / 2), n_filters + 2))
    bins = np.floor((nfft + 1) * mel_pts / sample_rate).astype(int)
    fbank = np.zeros((n_filters, nfft // 2 + 1), np.float32)
    for i in range(n_filters):
        lo, ctr, hi = bins[i], bins[i + 1], bins[i + 2]
        for b in range(lo, ctr):
            fbank[i, b] = (b - lo) / max(ctr - lo, 1)
        for b in range(ctr, hi):
            fbank[i, b] = (hi - b) / max(hi - ctr, 1)
    feats = power @ fbank.T
    feats = np.log(np.where(feats == 0, np.finfo(np.float32).eps, feats))

    if len(feats) % stack_order:
        res = stack_order - len(feats) % stack_order
        feats = np.concatenate([feats, np.zeros((res, n_filters), feats.dtype)])
    feats = feats.reshape(-1, stack_order * n_filters).astype(np.float32)
    if normalize and len(feats):
        mu = feats.mean(axis=1, keepdims=True)
        var = feats.var(axis=1, keepdims=True)
        feats = (feats - mu) / np.sqrt(var + 1e-5)
    return feats.astype(np.float32)


# ---------------------------------------------------------------------------
# Initialization and the fairseq import
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_video_encoder(generator: torch.Generator, cfg: VideoEncoderConfig,
                       device=None) -> VideoEncoder:
    """A random trunk on ``device`` (the card unless named) with the JAX
    package's distributions: linear weights N(0, 1/d_in), zero biases, unit
    LayerNorms, the pos conv N(0, 4 / (K D)) with a zero bias, the frontend
    as :func:`.visual.init_visual_frontend`. ``generator`` must live on
    ``device``; the values differ from JAX's for the same seed."""
    device = resolve_device(device)
    with device:
        model = VideoEncoder(cfg).to(device)
    model.feature_extractor_video.resnet = init_visual_frontend(generator, device)
    for name, mod in model.named_modules():
        if name.startswith("feature_extractor_video.resnet"):
            continue
        if isinstance(mod, nn.Linear):
            mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.in_features), generator=generator)
            mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, nn.Conv1d):
            mod.weight.normal_(0.0, math.sqrt(4.0 / (cfg.conv_pos * cfg.embed_dim)),
                               generator=generator)
            mod.bias.zero_()
    return model.eval()


def load_avhubert_torch(state: Mapping[str, Any], cfg: VideoEncoderConfig,
                        trunk: Optional[VideoEncoder] = None, device=None) -> VideoEncoder:
    """Import fairseq AV-HuBERT encoder weights into ``trunk`` (by default a
    trunk initialized from seed 0 on ``device``, the card unless named,
    as the JAX package starts from its seed-0 init).

    Every ``encoder.layers.{i}`` weight must be present; ``pos_conv``
    (a plain weight, or fairseq's weight norm ``weight_g`` (1, 1, K) and
    ``weight_v`` (O, I/g, K), rebuilt as w = v g / ||v|| with the norm over
    every axis but the kernel's), ``encoder.layer_norm``, the video
    ``proj`` and the audio trunk's fuse ``layer_norm`` and
    ``post_extract_proj`` are taken when present. The visual trunk is keyed
    ``...resnet.{frontend3D.*, trunk.layer*}`` in real checkpoints: every
    key holding ``resnet.`` goes to the frontend with ``trunk.`` dropped.
    A trunk config and a checkpoint that disagree on the audio trunk raise
    ``ValueError``."""
    if trunk is None:
        cpu = init_video_encoder(torch.Generator().manual_seed(0), cfg, device="cpu")
        trunk = cpu.to(resolve_device(device))
    has_audio_keys = "feature_extractor_audio.proj.weight" in state
    if cfg.audio_feat_dim is not None and not has_audio_keys:
        raise ValueError(
            f"config expects the avsr audio trunk (audio_feat_dim={cfg.audio_feat_dim}) "
            "but the checkpoint has no feature_extractor_audio keys; use the "
            "video-only config (e.g. 'large'/'base' instead of '*-avsr')"
        )
    if cfg.audio_feat_dim is None and has_audio_keys:
        raise ValueError(
            "checkpoint carries an avsr audio trunk (feature_extractor_audio keys) "
            "but the config is video-only; use the matching '*-avsr' config"
        )

    def t(v) -> torch.Tensor:
        return torch.as_tensor(np.asarray(v.detach().cpu() if hasattr(v, "detach") else v,
                                          np.float32))

    own = trunk.state_dict()
    mapped = {k: t(state[k]) for k in own if k.startswith("encoder.layers.")}
    if "encoder.pos_conv.0.weight_v" in state:
        v = t(state["encoder.pos_conv.0.weight_v"])
        g = t(state["encoder.pos_conv.0.weight_g"])
        mapped["encoder.pos_conv.0.weight"] = v * (g / v.pow(2).sum((0, 1), keepdim=True).sqrt())
        mapped["encoder.pos_conv.0.bias"] = t(state["encoder.pos_conv.0.bias"])
    optional = ["encoder.pos_conv.0.weight", "encoder.pos_conv.0.bias",
                "encoder.layer_norm.weight", "encoder.layer_norm.bias",
                "feature_extractor_video.proj.weight", "feature_extractor_video.proj.bias"]
    if cfg.audio_feat_dim is not None:
        optional += ["feature_extractor_audio.proj.weight", "feature_extractor_audio.proj.bias",
                     "layer_norm.weight", "layer_norm.bias"]
        if "post_extract_proj.weight" in own:
            optional += ["post_extract_proj.weight", "post_extract_proj.bias"]
    for k in optional:
        if k in state and k not in mapped:
            mapped[k] = t(state[k])
    trunk.load_state_dict(mapped, strict=False)

    resnet = {}
    for k, v in state.items():
        if "resnet." in k:
            sub = k.split("resnet.", 1)[1]
            resnet[sub[len("trunk."):] if sub.startswith("trunk.") else sub] = v
    if resnet:
        load_visual_frontend_torch(resnet, trunk.feature_extractor_video.resnet)
    return trunk


# ---------------------------------------------------------------------------
# Audio-visual Whisper wrapper
# ---------------------------------------------------------------------------

@dataclass
class AVWhisper:
    """Whisper + the AV-HuBERT trunk with gated x-attn fusion
    (``av_fusion="separate"``) and modality dropout: the trunk's features
    are the decoder's one conditioning stream (projected by
    ``xt_projection`` when the widths differ)."""

    whisper: Whisper
    video: VideoEncoder
    prob_av: float = 0.5  # P(use both) during training
    prob_a: float = 0.25  # P(audio only); remainder = video only
    _tasks: Dict[str, DecodingTask] = field(default_factory=dict, init=False, repr=False)

    @property
    def dims(self) -> ModelDimensions:
        return self.whisper.dims

    @property
    def video_cfg(self) -> VideoEncoderConfig:
        return self.video.cfg

    def _conditioning(self, video, audio, *, dtype, lengths=None):
        """The conditioning stream from the trunk over whichever of video /
        stacked-fbank audio is given (audio only with an audio trunk); the
        missing one contributes zeros. None when nothing conditions."""
        a_in = audio if self.video_cfg.audio_feat_dim is not None else None
        if video is None and a_in is None:
            return None
        dev = self.video.device

        def on(x):
            return None if x is None else torch.as_tensor(x).to(dev)

        return avhubert_encoder_apply(self.video, self.video_cfg, video=on(video),
                                      audio=on(a_in), dtype=dtype, lengths=lengths)

    def encode(
        self, mel, video=None, audio=None, *, test_a: bool = False, test_v: bool = False,
        generator: Optional[torch.Generator] = None, training: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        """(audio features, video features or None) with the modality masks:
        ``test_a`` zeroes the conditioning stream (kept present, as
        training's drop_video), ``test_v`` zeroes the Whisper audio
        features; in training, modality dropout draws one ``u`` from
        ``generator``: both if u < prob_av, audio only if u < prob_av +
        prob_a, video only otherwise."""
        drop_video = test_a or (video is None and audio is None)
        drop_audio = test_v
        if training and generator is not None and video is not None:
            u = float(torch.rand((), generator=generator))
            drop_video = drop_video or self.prob_av <= u < self.prob_av + self.prob_a
            drop_audio = drop_audio or u >= self.prob_av + self.prob_a

        mel = torch.as_tensor(mel).to(self.whisper.device)
        audio_features = encoder_apply(self.whisper, self.dims, mel, dtype=dtype)
        if drop_audio:
            audio_features = torch.zeros_like(audio_features)
        video_features = self._conditioning(video, audio, dtype=dtype)
        if video_features is not None and drop_video:
            video_features = torch.zeros_like(video_features)
        if video_features is None and test_a:
            # a length-1 zero stream equals a zeroed full trunk forward
            video_features = torch.zeros((audio_features.shape[0], 1, self.video_cfg.embed_dim),
                                         dtype=dtype, device=audio_features.device)
        return audio_features, video_features

    def task(self, options: DecodingOptions) -> DecodingTask:
        """The ``DecodingTask`` held for ``options``: made on first use, with
        the gated slabs at the stream cap ``n_text_ctx`` (the trunk's
        features are at most that long: the decoder's positions cap them),
        and kept, with its decode-time copy of the decoder and its step
        graphs, for every later batch with equal options. Other options
        replace it, so one copy of the decoder is held. The copy is made
        once: after a change to the Whisper weights, clear
        ``_tasks``."""
        key = repr(options)
        task = self._tasks.get(key)
        if task is None:
            self._tasks.clear()
            task = self._tasks[key] = DecodingTask(self.whisper, options, streams_at_ctx=True)
        return task

    def decode(self, mel, options, video=None, audio=None,
               test_a: bool = False, test_v: bool = False, video_lengths=None):
        """AV decode (the reference's ``whisper.decode(model, mel, options,
        x_v, test_v, test_a)``) through the task held for ``options``
        (:meth:`task`); ``audio`` adds the audio-trunk stream
        (``--modalities avsr``); ``video_lengths``, each clip's own frames
        in a ``video`` padded to the batch's longest, feeds the frame
        counters.

        ``test_a`` decodes with a present-but-zero stream of one frame (the
        gated x-attn over identical zero frames does not depend on their
        count) and skips the trunk; ``test_v`` decodes zero encoder
        features, which take the decode's pre-encoded branch, so the
        Whisper encoder does not run."""
        mel = torch.as_tensor(mel)
        single = mel.dim() == 2
        if single:
            mel = mel[None]
        dtype, dev = self.whisper.dtype, self.whisper.device
        if test_a:
            vf = torch.zeros((mel.shape[0], 1, self.video_cfg.embed_dim), dtype=dtype,
                             device=dev)
        else:
            vf = self._conditioning(video, audio, dtype=dtype, lengths=video_lengths)
        xt = None if vf is None else vf[None]
        if test_v:
            d = self.dims
            mel = torch.zeros(mel.shape[:-2] + (d.n_audio_ctx, d.n_audio_state), dtype=dtype)
        results = self.task(options).run(mel, xt=xt)
        return results[0] if single else results
