"""Prompt distillation (the reference's family E): the port of the JAX
package's ``recipes/distil_prompt.py``.

Run:

    python -m whisper_flamingo_tpu_torch.recipes.distil_prompt <config.yaml> [key=value ...]

on the card unless the config or an override says ``device=cpu``. The
frozen teacher (``pt_ckpt``, then ``teacher_ckpt`` when given) reads
``[sot_prev] + prompt`` token streams, the student (a copy of it) the plain
streams; the collator's ``teacher_*`` fields carry the asymmetric padding.
Extra keys as in ``whisper_ft``: ``log_every``, ``save_top_k``,
``max_steps``.
"""

from __future__ import annotations

import copy
from typing import List, Optional

from ..data.dataset import SpeechDataset
from ..parallel.mesh import shard_params
from ..tokenizer import get_tokenizer
from ..training.checkpoints import load_torch_checkpoint
from ..training.optim import encoder_frozen_mask, whisper_optimizer
from ..training.steps import TrainState, make_eval_step, make_prompt_kd_train_step
from ..training.trainer import Trainer
from . import common


class PromptTeacherDataset(SpeechDataset):
    """Emits the prompted (teacher) and the plain (student) token streams:
    the teacher's is ``[sot_prev] + prompt[-max_prompt_len:]`` before the
    student's, its prefix label-masked. The prompt is the example's, else
    its first translation; without either both streams are the same."""

    def __getitem__(self, idx):
        ex = self.source[idx]
        saved = self.prompt_use
        self.prompt_use = False
        feat = super().__getitem__(idx, ex=ex)  # one source fetch
        self.prompt_use = saved

        prompt = ex.prompt or (ex.translations[0] if ex.translations else "")
        if prompt:
            prompt_tokens = self.tokenizer.encode(" " + prompt.strip())[-self.max_prompt_len:]
            prefix = [self.tokenizer.sot_prev] + prompt_tokens
            feat["teacher_dec_input_ids"] = prefix + feat["dec_input_ids"]
            feat["teacher_labels"] = [-100] * len(prefix) + feat["labels"]
        else:
            feat["teacher_dec_input_ids"] = feat["dec_input_ids"]
            feat["teacher_labels"] = feat["labels"]
        return feat


def main(argv: Optional[List[str]] = None) -> TrainState:
    cfg = common.load_config(argv)
    mesh = common.setup_mesh(cfg)  # joins the process group before the model is built
    teacher = common.build_model(cfg, gated=False)
    if cfg.teacher_ckpt:
        loaded, _ = load_torch_checkpoint(cfg.teacher_ckpt, teacher.dims, seed=cfg.seed,
                                          device=cfg.device)
        teacher.load_state_dict(loaded.state_dict())
        del loaded
    student = copy.deepcopy(teacher)

    tokenizer = get_tokenizer(teacher.is_multilingual, num_languages=teacher.num_languages,
                              language=cfg.lang, task="transcribe")
    train_loader = common.build_loader(cfg, "train", tokenizer, training=True)
    train_loader.dataset.__class__ = PromptTeacherDataset
    val_loader = common.build_loader(cfg, "validation", tokenizer, training=False)

    freeze = bool(cfg.freeze_encoder)
    common.maybe_cast_frozen(cfg, teacher, {n: False for n, _ in teacher.named_parameters()})
    trainable = encoder_frozen_mask(student) if freeze else None
    if freeze:
        common.maybe_cast_frozen(cfg, student, trainable)
    tx, _ = whisper_optimizer(
        student, cfg.learning_rate,
        weight_decay=cfg.weight_decay, adam_epsilon=cfg.adam_epsilon,
        warmup_steps=cfg.warmup_steps, total_steps=cfg.num_train_steps,
        trainable_mask=trainable,
        max_grad_norm=cfg.max_grad_norm,
        accumulate_steps=cfg.gradient_accumulation_steps,
        optimizer=cfg.optimizer,
    )
    kd_step = make_prompt_kd_train_step(
        teacher.dims, alpha=cfg.alpha, beta=cfg.beta, temperature=cfg.temperature,
        freeze_student_encoder=freeze, dtype=cfg.compute_dtype, remat=cfg.remat,
    )

    def step(state, batch):
        return kd_step(state, teacher, batch)

    trainer = Trainer(
        cfg=cfg, dims=teacher.dims, train_step=step,
        eval_step=make_eval_step(teacher.dims, dtype=cfg.compute_dtype),
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
