"""Trans-ASR: translation-conditioned gated x-attn fine-tuning (the
reference's family C): the port of the JAX package's
``recipes/trans_asr.py``.

Run:

    python -m whisper_flamingo_tpu_torch.recipes.trans_asr <config.yaml> [key=value ...]

on the card unless the config or an override says ``device=cpu``. The
encoder is frozen and only the gated x-attn parameters train
(``train_xt_projection: true`` adds ``xt_projection``); each batch's
translations go through the BERT conditioner into the ``xt`` streams in
the trainer's ``prepare_batch`` hook. ``oracle: true`` conditions on the
transcript itself. Extra keys as in ``whisper_ft``: ``log_every``,
``save_top_k``, ``max_steps``.
"""

from __future__ import annotations

from typing import List, Optional

from ..tokenizer import get_tokenizer
from ..training.optim import flamingo_trainable_mask, whisper_flamingo_optimizer
from ..training.steps import TrainState, make_ce_train_step, make_eval_step
from ..training.trainer import Trainer
from . import common


def main(argv: Optional[List[str]] = None) -> TrainState:
    cfg = common.load_config(argv)
    mesh = common.setup_mesh(cfg)  # joins the process group before the model is built
    if not cfg.add_gated_x_attn:
        raise ValueError("trans_asr requires add_gated_x_attn: 1")

    model = common.build_model(cfg, gated=True)
    tokenizer = get_tokenizer(model.is_multilingual, num_languages=model.num_languages,
                              language=cfg.lang, task="transcribe")
    conditioner = common.build_conditioner(cfg)
    train_loader = common.build_loader(cfg, "train", tokenizer, training=True, translations=True)
    val_loader = common.build_loader(cfg, "validation", tokenizer, training=False,
                                     translations=True)

    prepare = common.make_xt_prepare(conditioner, cfg.num_langs)
    if cfg.extras.get("oracle"):
        base_prepare = prepare

        def prepare(batch):  # oracle: condition on the transcript itself
            batch = dict(batch)
            batch["all_translations"] = [[t] * max(cfg.num_langs, 1) for t in batch["text"]]
            return base_prepare(batch)

    train_xt_projection = bool(cfg.extras.get("train_xt_projection", False))
    common.maybe_cast_frozen(cfg, model, flamingo_trainable_mask(model, train_xt_projection))
    tx, _ = whisper_flamingo_optimizer(
        model,
        cfg.learning_rate,
        weight_decay=cfg.weight_decay,
        adam_epsilon=cfg.adam_epsilon,
        warmup_steps=cfg.warmup_steps,
        total_steps=cfg.num_train_steps,
        train_xt_projection=train_xt_projection,
        max_grad_norm=cfg.max_grad_norm,
        accumulate_steps=cfg.gradient_accumulation_steps,
        optimizer=cfg.optimizer,
    )
    step = make_ce_train_step(model.dims, freeze_encoder=True, use_xt=True,
                              dtype=cfg.compute_dtype, remat=cfg.remat)
    trainer = Trainer(
        cfg=cfg, dims=model.dims, train_step=step,
        eval_step=make_eval_step(model.dims, use_xt=True, dtype=cfg.compute_dtype),
        prepare_batch=prepare, mesh=mesh,
    )
    state = trainer.maybe_resume(TrainState.create(model, tx))
    state = trainer.fit(state, train_loader, val_loaders={"val": val_loader},
                        max_steps=cfg.extras.get("max_steps"),
                        log_every=int(cfg.extras.get("log_every", 50)))
    trainer.logger.close()
    return state


if __name__ == "__main__":
    main()
