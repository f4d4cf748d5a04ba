"""Decode-matrix fan-out: the port of the JAX package's
``recipes/decode_matrix.py`` (language x SNR cells, as the reference's
SLURM wrapper ran them).

Run:

    python -m whisper_flamingo_tpu_torch.recipes.decode_matrix <config.yaml> \
        langs=en,el,es snrs=1000,0 beam_size=15 [out=matrix.json]

on the card unless the config or an override says ``device=cpu``. Each
cell is a batched decode of the split with WER / CER; the table goes to one
JSON file, and :func:`main` returns it. A noisy cell (SNR < 1000) needs
``noise_fn_val`` naming an existing TSV of noise wavs, else the run stops
before decoding: a "noisy" row must not measure clean audio.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..audio import pad_or_trim
from ..decoding import DecodingOptions, DecodingTask
from ..metrics import wer_cer
from ..normalizers import BasicTextNormalizer
from ..tokenizer import get_tokenizer
from . import common


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, float]]:
    cfg = common.load_config(argv)
    langs = str(cfg.extras.get("langs", cfg.lang)).split(",")
    # overrides are literals where they parse: `snrs=1000,0` is a tuple
    raw_snrs = cfg.extras.get("snrs", "1000")
    if isinstance(raw_snrs, (tuple, list)):
        snrs = [int(s) for s in raw_snrs]
    else:
        snrs = [int(s) for s in str(raw_snrs).split(",")]
    if any(s < 1000 for s in snrs) and not (cfg.noise_fn_val and os.path.exists(cfg.noise_fn_val)):
        raise SystemExit(
            "noisy decode cells (snr < 1000) need noise_fn_val pointing at "
            "an EXISTING tsv of noise wav paths — otherwise the 'noisy' "
            "rows would silently measure clean audio"
        )
    beam = cfg.extras.get("beam_size")
    split = cfg.extras.get("split", "validation")
    out_path = cfg.extras.get("out", f"decode_matrix_{cfg.train_id}.json")
    use_xt = bool(cfg.add_gated_x_attn)

    model = common.build_model(cfg)
    prepare = (common.make_xt_prepare(common.build_conditioner(cfg), cfg.num_langs)
               if use_xt else None)
    normalizer = BasicTextNormalizer(remove_diacritics=True)

    table = {}
    for lang in langs:
        tokenizer = get_tokenizer(model.is_multilingual, num_languages=model.num_languages,
                                  language=lang, task="transcribe")
        for snr in snrs:
            cfg.noise_snr_eval = snr
            cfg.extras["noise_prob_eval"] = 0.0 if snr >= 1000 else 1.0
            loader = common.build_loader(cfg, split, tokenizer, training=False,
                                         translations=use_xt)
            task = DecodingTask(model, DecodingOptions(
                language=lang, without_timestamps=True,
                beam_size=int(beam) if beam else None, fp16="16" in str(cfg.precision),
            ))
            hyps, refs = [], []
            for batch in loader:
                if prepare is not None:
                    batch = prepare(batch)
                mel = pad_or_trim(np.asarray(batch["input_ids"]), 3000, axis=-1)
                for r, ref in zip(task.run(mel, xt=batch.get("xt")), batch["text"]):
                    hyps.append(normalizer(r.text))
                    refs.append(normalizer(ref))
            wer, cer = wer_cer(hyps, refs)
            key = f"{lang}/snr{snr}"
            table[key] = {"wer": round(wer, 4), "cer": round(cer, 4), "n": len(hyps)}
            print(key, table[key])

    with open(out_path, "w") as f:
        json.dump(table, f, indent=2)
    print(f"wrote {out_path}")
    return table


if __name__ == "__main__":
    main()
