"""Keyword / dictionary coverage statistics (the reference's family H):
the port of the JAX package's ``recipes/keyword_stats.py``.

Run:

    python -m whisper_flamingo_tpu_torch.recipes.keyword_stats <config.yaml> \
        [dict=words.txt] [out=stats.json]

Over the train split's texts: the utterance, token and type counts, the
share of tokens found in the lexicon, the top words and the top words
outside the lexicon. Space-less (zh-style) text is segmented with ``jieba``
when it is installed, by character otherwise; other text by whitespace. It
reads no model, so it needs no device. :func:`main` returns the stats.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Any, Dict, List, Optional

from ..tokenizer import get_tokenizer
from . import common


def segment(text: str) -> List[str]:
    if " " not in text.strip():
        try:
            import jieba
        except ImportError:
            return list(text.strip())
        return [w for w in jieba.lcut(text) if w.strip()]
    return text.split()


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    cfg = common.load_config(argv)
    out_path = cfg.extras.get("out", f"keyword_stats_{cfg.train_id}.json")
    lexicon = set()
    if cfg.extras.get("dict") and os.path.exists(cfg.extras["dict"]):
        with open(cfg.extras["dict"]) as f:
            lexicon = {line.strip().split()[0] for line in f if line.strip()}

    tokenizer = get_tokenizer(True, language=cfg.lang, task="transcribe")
    loader = common.build_loader(cfg, "train", tokenizer, training=False)

    counter: collections.Counter = collections.Counter()
    n_utts = 0
    for batch in loader:
        for text in batch["text"]:
            counter.update(segment(text))
            n_utts += 1

    total = sum(counter.values())
    covered = sum(c for w, c in counter.items() if w in lexicon) if lexicon else None
    oov = [w for w, _ in counter.most_common() if lexicon and w not in lexicon][:50]
    stats = {
        "n_utts": n_utts,
        "n_tokens": total,
        "n_types": len(counter),
        "dict_size": len(lexicon),
        "dict_coverage": (covered / total) if covered is not None and total else None,
        "top_words": counter.most_common(20),
        "top_oov": oov,
    }
    with open(out_path, "w") as f:
        json.dump(stats, f, ensure_ascii=False, indent=2)
    print(json.dumps({k: v for k, v in stats.items() if k != "top_words"}, ensure_ascii=False))
    return stats


if __name__ == "__main__":
    main()
