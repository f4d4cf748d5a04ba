"""Shared recipe plumbing: config -> datasets, loaders, model.

Port of the JAX package's ``recipes/common.py`` (the one set of helpers
that replaced the reference scripts' copy-paste preamble). Dataset selection
comes from the config's ``dataset`` key:

- ``synthetic``: deterministic random utterances (smoke runs, tests);
- ``manifest:<path>``: a TSV/CSV manifest of wav paths and text (the path
  may hold ``{split}``);
- ``hf:<name>[:<config>]``: HuggingFace datasets (``HFAsrSource``; a
  local cache, as nothing is fetched).

The model and the text conditioner (:func:`build_conditioner`, BERT over
the translation strings, run by the trainer's ``prepare_batch`` hook) are
built on the config's ``device`` (the card unless it says ``cpu``).

Parallelism: ``num_devices`` x ``tp_size`` > 1 asks for a (data, model)
mesh of that many ranks, one process each, launched by ``torchrun``:

    torchrun --nproc-per-node 8 -m whisper_flamingo_tpu_torch.recipes.whisper_ft \
        configs/smoke/ft_dp.yaml device=cpu

:func:`setup_mesh` joins the process group (before the model is built, so
each rank builds on its own card) and builds the mesh; every rank reads
the same global batches of ``batch_size`` rows and steps on its data
index's rows (JAX's single-host semantics). The ``process_index`` /
:class:`..data.samplers.DistributedBatchSampler` path stays JAX's
multi-host mode, where each host reads its own batches.
"""

from __future__ import annotations

import argparse
import ast
import os
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from ..config import TrainConfig
from ..data.collator import WhisperCollator
from ..data.dataset import (
    DataLoader,
    HFAsrSource,
    ManifestAsrSource,
    SpeechDataset,
    SyntheticAsrSource,
)
from ..data.samplers import DistributedBatchSampler, ShuffledBatchSampler, SortedBatchSampler
from ..data.translations import CsvLookup, TranslatedSource, build_lookups
from ..models.bert import HFBertConditioner, TextConditioner
from ..models.whisper import Whisper
from ..parallel import distributed
from ..parallel.mesh import make_mesh
from ..training.optim import Mask
from ..training.steps import cast_frozen_bf16


def build_source(spec: str, split: str, cfg: TrainConfig):
    if spec == "synthetic" or not spec:
        n = int(cfg.extras.get("synthetic_n", 32))
        n_trans = cfg.num_langs if cfg.add_gated_x_attn else 0
        fixed_sec = cfg.extras.get("synthetic_sec")  # one utterance length
        kw = {"min_sec": float(fixed_sec), "max_sec": float(fixed_sec)} if fixed_sec else {}
        return SyntheticAsrSource(
            n=n if split == "train" else max(n // 4, 2),
            seed=0 if split == "train" else 1,
            n_translations=n_trans,
            **kw,
        )
    if spec.startswith("manifest:"):
        return ManifestAsrSource(spec.split(":", 1)[1].format(split=split))
    if spec.startswith("hf:"):
        parts = spec.split(":")
        return HFAsrSource(parts[1], split=split, config=parts[2] if len(parts) > 2 else None)
    raise ValueError(f"unknown dataset spec: {spec!r}")


class _PseudoSource:
    """Substitutes pseudo-label training text by utterance id."""

    def __init__(self, base, pseudo: CsvLookup):
        self.base = base
        self.pseudo = pseudo

    def __len__(self):
        return len(self.base)

    def lengths(self):
        return self.base.lengths()

    def __getitem__(self, idx):
        ex = self.base[idx]
        replacement = self.pseudo(ex.id)
        if replacement:
            ex.text = replacement
        return ex


def build_loader(cfg: TrainConfig, split: str, tokenizer, *, training: bool,
                 translations: bool = False, prompts: bool = False) -> DataLoader:
    source = build_source(str(cfg.extras.get("dataset", "synthetic")), split, cfg)
    # translations for the conditioning streams, keyed on the split
    csv_key = cfg.translation_csv_train if split == "train" else cfg.translation_csv_eval
    lookups = build_lookups(cfg.translation_base_dirs, [csv_key] if csv_key else [])
    if lookups:
        source = TranslatedSource(
            source, lookups,
            drop_missing=bool(cfg.extras.get("drop_missing_translations", False)),
        )
    if training and cfg.use_pseudo_labels and cfg.pseudo_csv_path_train:
        source = _PseudoSource(source, CsvLookup(cfg.pseudo_csv_path_train,
                                                 value_column="pseudo_text"))
    noise_wavs = []
    noise_fn = cfg.noise_fn if training else cfg.noise_fn_val
    if noise_fn and os.path.exists(noise_fn):
        with open(noise_fn) as f:  # tsv of noise wav paths
            noise_wavs = [line.split("\t")[0].strip() for line in f if line.strip()]
    # eval-time noise via noise_prob_eval; snr >= 1000 means clean
    eval_noise_prob = float(cfg.extras.get("noise_prob_eval", 0.0))
    if cfg.noise_snr_eval >= 1000:
        eval_noise_prob = 0.0
    ds = SpeechDataset(
        source=source,
        tokenizer=tokenizer,
        audio_max_length=cfg.audio_max_length,
        spec_augment=cfg.spec_augment if training else "",
        noise_prob=cfg.noise_prob if training else eval_noise_prob,
        noise_wavs=noise_wavs,
        noise_snr=cfg.noise_snr_train if training else cfg.noise_snr_eval,
        translations_use=translations,
        prompt_use=prompts,
        max_prompt_len=cfg.max_prompt_len,
        seed=cfg.seed,
        training=training,
    )
    drop_last = cfg.num_devices * cfg.tp_size > 1
    sampler = SortedBatchSampler(batch_size=cfg.batch_size, shapes=ds.mel_lengths(),
                                 drop_last=drop_last)
    if training:
        sampler = ShuffledBatchSampler(sampler, seed=cfg.seed)
    if cfg.num_devices > 1 and "process_index" in cfg.extras:
        sampler = DistributedBatchSampler(sampler, cfg.num_devices,
                                          int(cfg.extras["process_index"]))
    return DataLoader(ds, sampler, WhisperCollator())


def setup_mesh(cfg: TrainConfig):
    """``None`` for one device; for ``num_devices`` x ``tp_size`` > 1 the
    (``num_devices``, ``tp_size``) mesh over the process group, joined here
    from ``torchrun``'s environment when this process is not in one yet.
    Raises ``ValueError`` (naming the ``torchrun`` command) when there is
    no process group to join or its size differs."""
    total = cfg.num_devices * cfg.tp_size
    if total <= 1:
        return None
    launch = (f"`torchrun --nproc-per-node {total} -m whisper_flamingo_tpu_torch.recipes.<name> "
              "<config.yaml> ...`")
    if not dist.is_initialized():
        if not os.environ.get("WORLD_SIZE"):
            raise ValueError(
                f"num_devices={cfg.num_devices} x tp_size={cfg.tp_size} needs {total} ranks "
                f"and no process group exists: launch with {launch}"
            )
        distributed.initialize(device=cfg.device)
    if dist.get_world_size() != total:
        raise ValueError(
            f"num_devices={cfg.num_devices} x tp_size={cfg.tp_size} needs {total} ranks, the "
            f"process group has {dist.get_world_size()}: launch with {launch}"
        )
    return make_mesh(cfg.num_devices, cfg.tp_size)


def build_model(cfg: TrainConfig, *, gated: Optional[bool] = None) -> Whisper:
    """The model on ``cfg.device`` (random weights from ``cfg.seed`` unless
    ``pt_ckpt`` names a checkpoint), computing in ``cfg.compute_dtype``."""
    from .. import load_model
    from ..training.checkpoints import load_torch_checkpoint

    gated = cfg.add_gated_x_attn if gated is None else gated
    model = load_model(
        cfg.model_name,
        device=cfg.device,
        dropout_rate=cfg.dropout_rate,
        add_gated_x_attn=1 if gated else 0,
        bert_dim=cfg.bert_dim,
        num_langs=cfg.num_langs,
        seed=cfg.seed,
        dtype=cfg.compute_dtype,
    )
    if cfg.pt_ckpt:
        loaded, _ = load_torch_checkpoint(cfg.pt_ckpt, model.dims, model.extras,
                                          seed=cfg.seed, device=cfg.device)
        model.load_state_dict(loaded.state_dict())
    return model


def maybe_cast_frozen(cfg: TrainConfig, model: Whisper, trainable_mask: Mask) -> Whisper:
    """Store frozen parameters in bf16 when computing in bf16 (the forward
    is unchanged); ``frozen_params_bf16: false`` turns it off."""
    if cfg.compute_dtype != torch.bfloat16 or not cfg.extras.get("frozen_params_bf16", True):
        return model
    return cast_frozen_bf16(model, trainable_mask)


def build_conditioner(cfg: TrainConfig) -> HFBertConditioner:
    """The BERT conditioner ``cfg.bert_encoder`` on ``cfg.device``
    (``bert_pretrained``, default true: its local weights; false: random
    weights, ``bert_dim`` wide when no cached config names a width). A
    conditioner of another width than ``bert_dim`` raises here: the model
    projects ``xt`` only when ``bert_dim`` differs from its own width, so a
    wrong width cannot be projected silently."""
    cond = HFBertConditioner(
        cfg.bert_encoder, pretrained=bool(cfg.extras.get("bert_pretrained", True)),
        hidden_size=int(cfg.bert_dim or 0), device=cfg.device,
    )
    if cond.dim != cfg.bert_dim:
        raise ValueError(
            f"conditioner '{cfg.bert_encoder}' emits {cond.dim}-dim states "
            f"but the config says bert_dim={cfg.bert_dim}; set bert_dim to "
            "the conditioner's true width"
        )
    return cond


def make_xt_prepare(conditioner: TextConditioner, num_langs: int) -> Callable:
    """Batch hook: the conditioner over the first ``num_langs`` translation
    streams of the batch, as ``batch["xt"]`` (n_langs, B, S, D); a batch
    without translations passes through."""

    def prepare(batch):
        if "all_translations" not in batch:
            return batch
        per_lang = list(zip(*batch["all_translations"]))[:num_langs]
        batch = dict(batch)
        batch["xt"] = conditioner.encode_multi(per_lang)
        return batch

    return prepare


def load_config(argv: Optional[List[str]] = None) -> TrainConfig:
    """``<config.yaml> [key=value ...]``: values are Python literals where
    they parse as one, strings otherwise."""
    parser = argparse.ArgumentParser()
    parser.add_argument("config", help="yaml config path")
    parser.add_argument("overrides", nargs="*", help="key=value overrides")
    args = parser.parse_args(argv)
    overrides = {}
    for item in args.overrides:
        k, v = item.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
        overrides[k] = v
    return TrainConfig.from_yaml(args.config, **overrides)
