"""Pseudo-label generation (the reference's family F): the port of the JAX
package's ``recipes/generate_pseudo_labels.py``.

Run:

    python -m whisper_flamingo_tpu_torch.recipes.generate_pseudo_labels <config.yaml> \
        [out=labels.csv] [free_decode=true] [beam_size=N]

on the card unless the config or an override says ``device=cpu``. The
(optionally translation-conditioned) teacher labels the train split. As in
the reference, the labels are the teacher-forced argmax tokens; with
``free_decode: true`` they come from greedy or beam decoding instead. The
CSV's columns are ``id,pseudo_text,ground_truth,wer``; :func:`main` returns
its rows.
"""

from __future__ import annotations

import csv
from typing import Dict, List, Optional

import numpy as np

from ..audio import pad_or_trim
from ..decoding import DecodingOptions, DecodingTask
from ..metrics import wer_cer
from ..normalizers import BasicTextNormalizer
from ..tokenizer import get_tokenizer
from ..training.steps import make_eval_step
from . import common


def main(argv: Optional[List[str]] = None) -> List[Dict[str, object]]:
    cfg = common.load_config(argv)
    out_path = cfg.extras.get("out", f"pseudo_labels_{cfg.train_id}.csv")
    use_xt = bool(cfg.add_gated_x_attn)

    model = common.build_model(cfg)
    tokenizer = get_tokenizer(model.is_multilingual, num_languages=model.num_languages,
                              language=cfg.lang, task="transcribe")
    loader = common.build_loader(cfg, "train", tokenizer, training=False, translations=use_xt)
    prepare = (common.make_xt_prepare(common.build_conditioner(cfg), cfg.num_langs)
               if use_xt else None)
    eval_step = make_eval_step(model.dims, use_xt=use_xt, dtype=cfg.compute_dtype)
    normalizer = BasicTextNormalizer(remove_diacritics=True)

    task = None
    if cfg.extras.get("free_decode", False):
        beam = cfg.extras.get("beam_size")
        task = DecodingTask(model, DecodingOptions(
            language=cfg.lang, without_timestamps=True,
            beam_size=int(beam) if beam else None, fp16="16" in str(cfg.precision),
        ))

    rows = []
    for batch in loader:
        if prepare is not None:
            batch = prepare(batch)
        if task is not None:
            mel = pad_or_trim(np.asarray(batch["input_ids"]), 3000, axis=-1)
            pseudos = [r.text.strip() for r in task.run(mel, xt=batch.get("xt"))]
        else:
            _, preds = eval_step(model, batch)
            preds = preds.cpu().numpy()
            labels = np.asarray(batch["labels"])
            pseudos = []
            for i in range(preds.shape[0]):
                mask = labels[i] != -100
                hyp_tokens = [int(t) for t in preds[i][mask] if t != tokenizer.eot]
                pseudos.append(tokenizer.decode(hyp_tokens).strip())
        for i, pseudo in enumerate(pseudos):
            truth = batch["text"][i]
            wer, _ = wer_cer([normalizer(pseudo)], [normalizer(truth)])
            rows.append({"id": batch["ids"][i], "pseudo_text": pseudo, "ground_truth": truth,
                         "wer": round(wer, 4)})

    with open(out_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["id", "pseudo_text", "ground_truth", "wer"])
        writer.writeheader()
        writer.writerows(rows)
    print(f"wrote {len(rows)} pseudo labels to {out_path}")
    return rows


if __name__ == "__main__":
    main()
