"""Evaluation (the reference's family G): the port of the JAX package's
``recipes/evaluate.py``.

Run:

    python -m whisper_flamingo_tpu_torch.recipes.evaluate <config.yaml> \
        [mode=teacher_forced|decode] [beam_size=N] [split=validation] [bleu=true]

on the card unless the config or an override says ``device=cpu``.

- ``teacher_forced``: the trainer's validation (loss, token accuracy, WER,
  CER);
- ``decode``: batched greedy or beam decoding and WER / CER over
  normalized text, with the real-time factor; ``bleu: true`` adds corpus
  BLEU when ``sacrebleu`` is installed (skipped otherwise, as in JAX).

Gated configs (``add_gated_x_attn``) condition on ``xt`` from the BERT
conditioner over the split's translations. :func:`main` prints the
metrics and returns them.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..audio import pad_or_trim
from ..decoding import DecodingOptions, DecodingTask
from ..metrics import wer_cer
from ..normalizers import BasicTextNormalizer
from ..tokenizer import get_tokenizer
from ..training.steps import make_eval_step
from ..training.trainer import Trainer
from . import common


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    cfg = common.load_config(argv)
    mode = cfg.extras.get("mode", "teacher_forced")
    split = cfg.extras.get("split", "validation")
    use_xt = bool(cfg.add_gated_x_attn)

    model = common.build_model(cfg)
    tokenizer = get_tokenizer(model.is_multilingual, num_languages=model.num_languages,
                              language=cfg.lang, task="transcribe")
    loader = common.build_loader(cfg, split, tokenizer, training=False, translations=use_xt)
    prepare = (common.make_xt_prepare(common.build_conditioner(cfg), cfg.num_langs)
               if use_xt else None)

    if mode == "teacher_forced":
        trainer = Trainer(
            cfg=cfg, dims=model.dims, train_step=None,
            eval_step=make_eval_step(model.dims, use_xt=use_xt, dtype=cfg.compute_dtype),
            prepare_batch=prepare,
        )
        metrics = trainer.validate(model, {split: loader})
        trainer.logger.close()
        print({k: round(v, 4) for k, v in metrics.items()})
        return metrics

    beam = cfg.extras.get("beam_size")
    task = DecodingTask(model, DecodingOptions(
        language=cfg.lang, without_timestamps=True, beam_size=int(beam) if beam else None,
        fp16="16" in str(cfg.precision),
    ))
    normalizer = BasicTextNormalizer(remove_diacritics=True)
    hyps, refs = [], []
    t0 = time.time()
    audio_seconds = 0.0
    for batch in loader:
        if prepare is not None:
            batch = prepare(batch)
        mel = pad_or_trim(np.asarray(batch["input_ids"]), 3000, axis=-1)
        results = task.run(mel, xt=batch.get("xt"))
        audio_seconds += float(np.sum(batch["wav_lens"])) / 16000.0
        for r, ref in zip(results, batch["text"]):
            hyps.append(normalizer(r.text))
            refs.append(normalizer(ref))
    wall = time.time() - t0
    wer, cer = wer_cer(hyps, refs)
    out = {"split": split, "n_utts": len(hyps), "wer": round(wer, 4), "cer": round(cer, 4),
           "rtf": round(audio_seconds / max(wall, 1e-9), 2)}
    if cfg.extras.get("bleu"):  # the En->X protocol
        try:
            import sacrebleu
        except ImportError:
            sacrebleu = None
        if sacrebleu is not None:
            out["bleu"] = round(sacrebleu.corpus_bleu(hyps, [refs]).score, 2)
    print(out)
    return out


if __name__ == "__main__":
    main()
