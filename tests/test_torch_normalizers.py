"""The port's copies of the text normalizers and the error-rate metrics give
the JAX package's outputs, exactly, on the strings of
tests/test_normalizers.py and a seeded fuzz of number phrases."""

import os
import random
import sys

import numpy as np
import pytest

from whisper_flamingo_tpu import metrics as jmetrics
from whisper_flamingo_tpu.normalizers import BasicTextNormalizer as JBasic
from whisper_flamingo_tpu.normalizers import EnglishTextNormalizer as JEnglish

from whisper_flamingo_tpu_torch import metrics
from whisper_flamingo_tpu_torch.normalizers import BasicTextNormalizer, EnglishTextNormalizer

from test_normalizers import CASES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("kw", [{}, {"remove_diacritics": True}, {"split_letters": True}])
def test_basic_normalizer_matches_jax(kw):
    ours, theirs = BasicTextNormalizer(**kw), JBasic(**kw)
    for case in CASES + ["hello 世界 abc", "กขค one two"]:
        assert ours(case) == theirs(case), (kw, case)


def test_english_normalizer_matches_jax():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from normalizer_fuzz import gen_case

    rng = random.Random(0)
    ours, theirs = EnglishTextNormalizer(), JEnglish()
    for case in CASES + [gen_case(rng) for _ in range(500)]:
        assert ours(case) == theirs(case), case


def test_edit_distance_and_wer_match_jax():
    rng = np.random.default_rng(0)
    vocab = ["a", "b", "c", "the", "cat", "sat"]
    for _ in range(50):
        a = list(rng.choice(vocab, rng.integers(0, 12)))
        b = list(rng.choice(vocab, rng.integers(0, 12)))
        assert metrics.edit_distance(a, b) == jmetrics.edit_distance(a, b), (a, b)
    hypos = ["the cat sat", "hello world", "", "a b c d"]
    refs = ["the cat sat on", "hello there world", "x", "a c d"]
    assert metrics.wer_cer(hypos, refs) == jmetrics.wer_cer(hypos, refs)
    assert metrics.fairseq_wer(hypos, refs) == jmetrics.fairseq_wer(hypos, refs)


def test_token_accuracy_matches_jax():
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 5, (4, 9))
    labels[0, 3] = 4  # an EOT mid-row
    labels[1, :2] = -100
    pred = rng.integers(0, 5, (4, 9))
    assert metrics.token_accuracy(pred, labels, eot=4) == jmetrics.token_accuracy(
        pred, labels, eot=4
    )
