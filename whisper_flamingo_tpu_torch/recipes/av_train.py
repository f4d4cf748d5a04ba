"""Audio-visual Whisper-Flamingo training (step 2: a frozen Whisper and a
frozen AV-HuBERT trunk, the gated x-attn layers learn on lip-video
features): the port of the JAX package's ``recipes/av_train.py``.

Run:

    python -m whisper_flamingo_tpu_torch.recipes.av_train <config.yaml> [key=value ...]

on the card unless the config or an override says ``device=cpu``
(``configs/smoke/av.yaml device=cpu`` trains the debug dims on the CPU).

The manifest gives a ``video_path`` per utterance (a .npy of (T, H, W)
grayscale lip crops at 25 fps); a source without video (``synthetic``)
gets random frames drawn from the utterance id. The trunk is
``video_encoder`` (``large`` / ``base`` by the model name otherwise),
loaded from ``video_model_ckpt`` when set, else random from ``seed``; an
``*-avsr`` trunk also reads the stacked-fbank audio stream. Validation runs
the AV path. Extra keys as in ``whisper_ft``: ``log_every``,
``save_top_k``, ``max_steps``.

The frozen Whisper encoder and trunk run forward only inside
``make_av_train_step`` with autograd left on: nothing of theirs requires
grad, so no graph or activation is kept, and ``torch.no_grad()`` read the
same device time, host time and memory on the H100 at
``av_en_large.yaml``'s widths and batch (``PERF.md``).
"""

from __future__ import annotations

import functools
import zlib
from typing import List, Optional

import numpy as np
import torch

from ..data.dataset import SpeechDataset
from ..models.avhubert import (
    VIDEO_ENCODER_CONFIGS,
    VideoEncoder,
    init_video_encoder,
    load_avhubert_torch,
    stacked_fbank_features,
)
from ..tokenizer import get_tokenizer
from ..training.checkpoints import torch_load_prefer_safe
from ..training.optim import flamingo_trainable_mask, whisper_flamingo_optimizer
from ..training.steps import TrainState, make_av_eval_step, make_av_train_step
from ..training.trainer import Trainer
from ..utils import resolve_device
from . import common


class VideoSpeechDataset(SpeechDataset):
    """SpeechDataset emitting the lip-video frames beside the mel; with
    ``emit_fbank`` (avsr trunks) also the stacked-fbank audio stream of the
    same processed waveform as the mel, so noise hits both modalities."""

    video_hw: int = 88
    emit_fbank: bool = False
    fbank_dim: int = 104  # sliced for tiny test trunks (debug-av)

    def __getitem__(self, idx):
        ex = self.source[idx]
        self.emit_wav = self.emit_fbank
        feat = super().__getitem__(idx, ex=ex)  # one source fetch
        video = ex.video
        if video is None:  # synthetic: deterministic random frames
            # a stable digest, not hash(): str hashes are salted per process
            rng = np.random.default_rng(zlib.crc32(ex.id.encode()))
            n_frames = max(int(feat["audio_frames"] // 4), 2)  # ~25 fps
            video = rng.standard_normal((n_frames, self.video_hw, self.video_hw)).astype(np.float32)
        elif isinstance(video, str):
            video = np.load(video).astype(np.float32)
        feat["video"] = video
        if self.emit_fbank:
            feat["fbank"] = stacked_fbank_features(feat.pop("wav"))[:, : self.fbank_dim]
        return feat


def cast_video_bf16(video: VideoEncoder) -> VideoEncoder:
    """The frozen trunk stored in bf16, in place, as the JAX package casts
    its frozen params: every float32 tensor but the LayerNorm and
    BatchNorm weights and biases (read at fp32)."""
    for mod in video.modules():
        keep = isinstance(mod, (torch.nn.LayerNorm, torch.nn.modules.batchnorm._BatchNorm))
        for name, t in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            if t.dtype == torch.float32 and not (keep and name in ("weight", "bias")):
                t.data = t.data.to(torch.bfloat16)
    return video


def build_video_encoder(cfg) -> VideoEncoder:
    """The trunk ``video_encoder`` on ``cfg.device``: ``video_model_ckpt``
    when set (a fairseq checkpoint, its ``model`` entry if it has one),
    else random weights from ``cfg.seed``."""
    name = cfg.extras.get("video_encoder", "large" if "large" in cfg.model_name else "base")
    vcfg = VIDEO_ENCODER_CONFIGS[name]
    if cfg.video_model_ckpt:
        state = torch_load_prefer_safe(cfg.video_model_ckpt)
        return load_avhubert_torch(state.get("model", state), vcfg, device=cfg.device)
    device = resolve_device(cfg.device)
    return init_video_encoder(torch.Generator(device=device).manual_seed(cfg.seed), vcfg,
                              device=device)


def main(argv: Optional[List[str]] = None) -> TrainState:
    cfg = common.load_config(argv)
    mesh = common.setup_mesh(cfg)  # joins the process group before the model is built
    model = common.build_model(cfg, gated=True)
    video = build_video_encoder(cfg)
    vcfg = video.cfg

    tokenizer = get_tokenizer(model.is_multilingual, num_languages=model.num_languages,
                              language=cfg.lang, task="transcribe")
    train_loader = common.build_loader(cfg, "train", tokenizer, training=True)
    val_loader = common.build_loader(cfg, "validation", tokenizer, training=False)
    for loader in (train_loader, val_loader):  # the video datasets
        loader.dataset.__class__ = VideoSpeechDataset
        if vcfg.audio_feat_dim is not None:  # avsr trunk: add the fbank stream
            loader.dataset.emit_fbank = True
            loader.dataset.fbank_dim = vcfg.audio_feat_dim

    common.maybe_cast_frozen(cfg, model, flamingo_trainable_mask(model))
    if (cfg.freeze_video_model and cfg.compute_dtype == torch.bfloat16
            and cfg.extras.get("frozen_params_bf16", True)):
        cast_video_bf16(video)
    tx, _ = whisper_flamingo_optimizer(
        model, cfg.learning_rate,
        weight_decay=cfg.weight_decay, adam_epsilon=cfg.adam_epsilon,
        warmup_steps=cfg.warmup_steps, total_steps=cfg.num_train_steps,
        max_grad_norm=cfg.max_grad_norm,
        accumulate_steps=cfg.gradient_accumulation_steps,
        optimizer=cfg.optimizer,
    )
    av_step = make_av_train_step(
        model.dims, prob_av=cfg.prob_av, prob_a=cfg.prob_a,
        freeze_video=bool(cfg.freeze_video_model), dtype=cfg.compute_dtype, remat=cfg.remat,
    )
    generator = torch.Generator().manual_seed(cfg.seed)  # the modality draws

    def step(state, batch):
        return av_step(state, video, batch, generator)

    trainer = Trainer(
        cfg=cfg, dims=model.dims, train_step=step,
        # validation runs the trained AV path (video -> gated x-attn): the
        # checkpoint monitor selects on this loss
        eval_step=functools.partial(make_av_eval_step(model.dims, dtype=cfg.compute_dtype), video),
        mesh=mesh,
    )
    state = trainer.maybe_resume(TrainState.create(model, tx))
    state = trainer.fit(state, train_loader, val_loaders={"val": val_loader},
                        max_steps=cfg.extras.get("max_steps"),
                        log_every=int(cfg.extras.get("log_every", 50)))
    trainer.logger.close()
    return state


if __name__ == "__main__":
    main()
