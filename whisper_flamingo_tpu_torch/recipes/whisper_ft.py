"""Audio-only / prompted Whisper fine-tuning (the reference's families A
and B): the port of the JAX package's ``recipes/whisper_ft.py``.

Run:

    python -m whisper_flamingo_tpu_torch.recipes.whisper_ft <config.yaml> [key=value ...]

on the card unless the config or an override says ``device=cpu`` (e.g.
``configs/smoke/ft.yaml device=cpu``, the debug dims). The encoder trains
unless ``freeze_encoder`` or prompt mode (``use_prompt: true``: prompt
tokens spliced as ``[sot_prev] + prompt`` with the prompt region
label-masked) freezes it. Extra keys: ``log_every`` (default 50) sets how
often the train loss is logged, ``save_top_k`` (default 3) how many scored
checkpoints are kept, and ``max_steps`` stops the run early while the
schedule still spans ``num_train_steps`` (an interrupted run, to resume
with ``resume_training=True``).
"""

from __future__ import annotations

from typing import List, Optional

from ..tokenizer import get_tokenizer
from ..training.optim import encoder_frozen_mask, whisper_optimizer
from ..training.steps import TrainState, make_ce_train_step, make_eval_step
from ..training.trainer import Trainer
from .common import build_loader, build_model, load_config, maybe_cast_frozen, setup_mesh


def main(argv: Optional[List[str]] = None) -> TrainState:
    cfg = load_config(argv)
    mesh = setup_mesh(cfg)  # joins the process group before the model is built
    use_prompt = bool(cfg.extras.get("use_prompt", False))

    model = build_model(cfg, gated=False)
    tokenizer = get_tokenizer(model.is_multilingual, num_languages=model.num_languages,
                              language=cfg.lang, task="transcribe")
    train_loader = build_loader(cfg, "train", tokenizer, training=True, prompts=use_prompt)
    val_loader = build_loader(cfg, "validation", tokenizer, training=False, prompts=use_prompt)

    freeze = use_prompt or bool(cfg.freeze_encoder)
    trainable = encoder_frozen_mask(model) if freeze else None
    if freeze:
        maybe_cast_frozen(cfg, model, trainable)
    tx, _ = whisper_optimizer(
        model,
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
    step = make_ce_train_step(model.dims, freeze_encoder=freeze, dtype=cfg.compute_dtype,
                              remat=cfg.remat)
    trainer = Trainer(
        cfg=cfg, dims=model.dims, train_step=step,
        eval_step=make_eval_step(model.dims, dtype=cfg.compute_dtype),
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
