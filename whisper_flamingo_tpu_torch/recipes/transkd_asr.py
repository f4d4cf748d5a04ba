"""TransKD-ASR knowledge distillation (the reference's family D): the port
of the JAX package's ``recipes/transkd_asr.py``.

Run:

    python -m whisper_flamingo_tpu_torch.recipes.transkd_asr <config.yaml> [key=value ...]

on the card unless the config or an override says ``device=cpu``. The
teacher is the frozen translation-conditioned Flamingo model (``pt_ckpt``,
then ``teacher_ckpt`` when given); the student is an audio-only Whisper
initialized from it (the encoder, and the decoder without the gated
weights). The loss is ``alpha`` CE + ``beta`` T^2 KL with label masking;
``freeze_encoder`` freezes the student's encoder and reuses the teacher's
encoder output. Extra keys as in ``whisper_ft``: ``log_every``,
``save_top_k``, ``max_steps``.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..models.whisper import ModelExtras, Whisper, init_params
from ..parallel.mesh import shard_params
from ..tokenizer import get_tokenizer
from ..training.checkpoints import load_torch_checkpoint
from ..training.optim import encoder_frozen_mask, flamingo_trainable_mask, whisper_optimizer
from ..training.steps import TrainState, make_eval_step, make_kd_train_step
from ..training.trainer import Trainer
from . import common


def init_student_from_teacher(teacher: Whisper, student: Whisper) -> Whisper:
    """Copy the teacher's tensors into ``student``, in place: every
    parameter and buffer of the student's state dict but the gated x-attn
    weights and ``xt_projection`` (strict: a name the teacher lacks
    raises). The student keeps its own storage, so training it leaves the
    teacher as it was."""
    skip = flamingo_trainable_mask(student, train_xt_projection=True)
    source = teacher.state_dict()
    with torch.no_grad():
        for name, tensor in student.state_dict().items():
            if not skip.get(name, False):
                tensor.copy_(source[name])
    return student


def main(argv: Optional[List[str]] = None) -> TrainState:
    cfg = common.load_config(argv)
    mesh = common.setup_mesh(cfg)  # joins the process group before the model is built
    teacher = common.build_model(cfg, gated=True)
    if cfg.teacher_ckpt:
        loaded, _ = load_torch_checkpoint(cfg.teacher_ckpt, teacher.dims, teacher.extras,
                                          seed=cfg.seed, device=cfg.device)
        teacher.load_state_dict(loaded.state_dict())
        del loaded
    gen = torch.Generator(device=teacher.device).manual_seed(cfg.seed)
    student = init_student_from_teacher(
        teacher, init_params(gen, teacher.dims, ModelExtras(), device=teacher.device))
    student.dtype = teacher.dtype

    tokenizer = get_tokenizer(teacher.is_multilingual, num_languages=teacher.num_languages,
                              language=cfg.lang, task="transcribe")
    conditioner = common.build_conditioner(cfg)
    train_loader = common.build_loader(cfg, "train", tokenizer, training=True, translations=True)
    val_loader = common.build_loader(cfg, "validation", tokenizer, training=False,
                                     translations=True)

    freeze = bool(cfg.freeze_encoder)
    # the teacher is frozen whole; the student's encoder optionally
    common.maybe_cast_frozen(cfg, teacher, {n: False for n, _ in teacher.named_parameters()})
    trainable = encoder_frozen_mask(student) if freeze else None
    if freeze:
        common.maybe_cast_frozen(cfg, student, trainable)
    tx, _ = whisper_optimizer(
        student,
        cfg.learning_rate,
        weight_decay=cfg.weight_decay,
        adam_epsilon=cfg.adam_epsilon,
        warmup_steps=cfg.warmup_steps,
        total_steps=cfg.num_train_steps,
        trainable_mask=trainable,
        max_grad_norm=cfg.max_grad_norm,
        accumulate_steps=cfg.gradient_accumulation_steps,
        optimizer=cfg.optimizer,
    )
    kd_step = make_kd_train_step(
        teacher.dims, alpha=cfg.alpha, beta=cfg.beta, temperature=cfg.temperature,
        freeze_student_encoder=freeze, share_teacher_features=freeze,
        dtype=cfg.compute_dtype, remat=cfg.remat,
    )

    def step(state, batch):
        return kd_step(state, teacher, batch)

    trainer = Trainer(
        cfg=cfg, dims=teacher.dims, train_step=step,
        eval_step=make_eval_step(teacher.dims, dtype=cfg.compute_dtype),
        prepare_batch=common.make_xt_prepare(conditioner, cfg.num_langs),
        mesh=mesh,
    )
    if mesh is not None:
        shard_params(teacher, mesh)
    state = trainer.maybe_resume(TrainState.create(student, tx))
    state = trainer.fit(state, train_loader, val_loaders={"val": val_loader},
                        max_steps=cfg.extras.get("max_steps"),
                        log_every=int(cfg.extras.get("log_every", 50)))
    trainer.logger.close()
    return state


if __name__ == "__main__":
    main()
