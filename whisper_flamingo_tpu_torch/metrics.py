"""Evaluation metrics: word and character error rates, token accuracy.

A copy of ``whisper_flamingo_tpu/metrics.py`` (the port imports nothing of
the JAX package): ``wer_cer`` splits characters with the ``replace('', '
')`` trick and words on whitespace; ``fairseq_wer`` is the published 13a
protocol; ``token_accuracy`` masks every position after the first EOT.

:func:`edit_distance` takes the C helper (``native.edit_distance``) when it
builds and the two-row numpy DP otherwise, as the JAX package does.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance over hashed tokens: the C helper when it
    builds, else a two-row numpy DP."""
    from . import native

    if native.AVAILABLE:
        a_ids = np.array([hash(x) for x in a], dtype=np.int64)
        b_ids = np.array([hash(x) for x in b], dtype=np.int64)
        result = native.edit_distance(a_ids, b_ids)
        if result is not None:
            return result
    if len(a) < len(b):
        a, b = b, a
    if len(b) == 0:
        return len(a)
    b_arr = np.array([hash(x) for x in b], dtype=np.int64)
    prev = np.arange(len(b) + 1, dtype=np.int64)
    for i, x in enumerate(a, start=1):
        cur = np.empty(len(b) + 1, dtype=np.int64)
        cur[0] = i
        sub = prev[:-1] + (b_arr != hash(x))
        np.minimum(sub, prev[1:] + 1, out=sub)
        # insertions need a sequential scan along the row
        cur[1:] = sub
        running = cur[0]
        for j in range(1, len(b) + 1):
            running = min(running + 1, cur[j])
            cur[j] = running
        prev = cur
    return int(prev[-1])


def wer_cer(hypo: List[str], ref: List[str]) -> Tuple[float, float]:
    """Corpus-level (WER, CER). Parity: reference utils.py:657-670."""
    c_err, c_len, w_err, w_len = 0, 0, 0, 0
    for h, r in zip(hypo, ref):
        pred_words = h.split()
        pred_units = h.replace(" ", "|").replace("", " ").split()
        gt_words = r.split()
        gt_units = r.replace(" ", "|").replace("", " ").split()
        c_err += edit_distance(pred_units, gt_units)
        c_len += len(gt_units)
        w_err += edit_distance(pred_words, gt_words)
        w_len += len(gt_words)
    return w_err / max(w_len, 1), c_err / max(c_len, 1)


def fairseq_wer(hypos: List[str], refs: List[str]) -> float:
    """The published WER protocol (reference demo notebook cell 20:
    fairseq ``WerScorer(wer_tokenizer="13a", wer_remove_punct=True,
    wer_char_level=False, wer_lowercase=True)``), as a fraction.

    Order matters and follows fairseq's ``EvaluationTokenizer.tokenize``
    exactly: sacrebleu 13a tokenization FIRST, then drop every token
    whose characters are all Unicode-category-P punctuation (punctuation
    attached to a word — ``it's`` — survives tokenization and is kept),
    then lowercase. Stripping punctuation characters up front instead
    merges words across punctuation (``end.start`` -> 1 word instead of
    2) and mutates contractions (``it's`` -> ``its``) — a different
    protocol whose scores are not comparable.
    """
    import unicodedata

    try:
        from sacrebleu.tokenizers.tokenizer_13a import Tokenizer13a

        tok = Tokenizer13a()
    except ImportError:
        # degrading to whitespace tokenization changes the meaning of the
        # published protocol number — never do it silently
        import warnings

        warnings.warn(
            "sacrebleu is unavailable: fairseq_wer is falling back to "
            "whitespace tokenization, which is NOT the published 13a "
            "WER protocol — scores are not comparable",
            stacklevel=2,
        )
        tok = lambda s: s  # noqa: E731

    def prep(s: str) -> List[str]:
        return [
            t.lower()
            for t in tok(s).split()
            if not all(unicodedata.category(c).startswith("P") for c in t)
        ]

    err, total = 0, 0
    for h, r in zip(hypos, refs):
        h_words, r_words = prep(h), prep(r)
        err += edit_distance(h_words, r_words)
        total += len(r_words)
    return err / max(total, 1)


def token_accuracy(
    pred_tokens: np.ndarray, labels: np.ndarray, eot: int, label_pad: int = -100
) -> float:
    """Teacher-forced token accuracy with post-first-EOT masking.

    Parity: reference `whisper_ft_librispeech.py:162-179` — positions after
    the first EOT in the labels are excluded, as are label-pad positions.
    """
    labels = np.asarray(labels)
    pred_tokens = np.asarray(pred_tokens)
    mask = labels != label_pad
    # mask out everything after (and including positions following) the
    # first EOT per row
    for i in range(labels.shape[0]):
        eots = np.nonzero(labels[i] == eot)[0]
        if len(eots):
            mask[i, eots[0] + 1 :] = False
    total = mask.sum()
    if total == 0:
        return 0.0
    return float((pred_tokens[mask] == labels[mask]).mean())
