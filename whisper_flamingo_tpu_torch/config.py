"""Typed experiment configuration.

Port of ``whisper_flamingo_tpu/config.py``: one dataclass over the union of
the reference's YAML keys, read from the shared ``configs/**.yaml`` with
the same field names, defaults and ``key=value`` overrides; unknown keys
land in ``extras``.

What differs: :attr:`TrainConfig.compute_dtype` is a torch dtype, and the
new ``device`` key (default ``"cuda"``) says where a recipe runs. The
smoke configs' ``platform`` and ``cpu_devices`` keys configure JAX (its
platform and its virtual CPU device count): they are read into
``extras`` and not applied here; ``device=cpu`` runs a recipe on the CPU.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import yaml


@dataclass
class TrainConfig:
    # run identity / logging
    train_name: str = "whisper"
    train_id: str = "run"
    log_output_dir: str = "logs"
    check_output_dir: str = "checkpoints"
    filename: str = "step-{step:05d}"
    monitor: str = "val/loss"

    # model
    model_name: str = "small"
    dropout_rate: float = 0.0
    add_adapter: bool = False
    adapter_dim: int = 256
    add_gated_x_attn: int = 0
    num_langs: int = 0
    bert_encoder: str = "bert-base-multilingual-cased"
    bert_dim: int = 768
    pt_ckpt: str = ""
    teacher_ckpt: str = ""
    resume_training: bool = False

    # optimization: "adamw" or "adafactor"
    optimizer: str = "adamw"
    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    adam_epsilon: float = 1e-8
    batch_size: int = 8
    num_train_steps: int = 100_000
    warmup_steps: int = 0
    gradient_accumulation_steps: int = 1
    max_grad_norm: float = 0.0  # 0 = no clipping (the reference never clips)
    precision: str = "16-mixed"  # "16-mixed" -> bfloat16 compute
    # "full" (per-block recompute in the backward), "none", or an
    # argument-free jax.checkpoint_policies name such as "dots" (selective
    # recompute, models/whisper.REMAT_POLICIES). On the H100 "full" is both
    # faster and smaller than "dots" (README, chip_smoke.py phase 20)
    remat: str = "full"

    # data
    audio_max_length: int = 480_000
    text_max_length: Optional[int] = None
    num_worker: int = 4
    lang: str = "en"
    noise_prob: float = 0.0
    noise_fn: str = ""
    noise_fn_val: str = ""
    noise_fn_test: str = ""
    noise_snr_train: Union[int, Tuple[int, int]] = 0
    noise_snr_eval: int = 1000
    spec_augment: str = ""  # "", "ls-basic", "ls-double"
    config_names: str = ""
    translation_csv_train: str = ""
    translation_csv_eval: str = ""
    translation_base_dirs: List[str] = field(default_factory=list)
    prompt_lookup: str = ""
    max_prompt_len: int = 100

    # distillation
    alpha: float = 0.8
    beta: float = 1.0
    temperature: float = 2.0
    freeze_encoder: Union[bool, int] = 0
    use_pseudo_labels: bool = False
    pseudo_csv_path_train: str = ""

    # audio-visual
    video: bool = False
    video_model_ckpt: str = ""
    av_hubert_path: str = ""
    av_hubert_ckpt: str = ""
    freeze_video_model: bool = True
    prob_use_av: float = 1.0
    prob_av: float = 0.5
    prob_a: float = 0.25
    use_av_hubert_encoder: bool = True
    av_fusion: str = "separate"

    # runtime / parallelism
    accelerator: str = "auto"
    num_devices: int = 1
    tp_size: int = 1
    validate_every_n_batches: int = 1000
    seed: int = 3407  # parity: seed_everything(3407) everywhere
    device: str = "cuda"

    # free-form extras (forward compat with unknown yaml keys)
    extras: Dict[str, Any] = field(default_factory=dict)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if "16" in str(self.precision) else torch.float32

    @staticmethod
    def from_yaml(path: str, **overrides) -> "TrainConfig":
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        raw.update(overrides)
        return TrainConfig.from_dict(raw)

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "TrainConfig":
        names = {f.name for f in dataclasses.fields(TrainConfig)}
        known = {k: v for k, v in raw.items() if k in names}
        extras = {k: v for k, v in raw.items() if k not in names}
        cfg = TrainConfig(**known)
        cfg.extras = extras
        return cfg

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update(d.pop("extras"))
        return d
