"""Basic text normalizer for WER scoring.

A copy of ``whisper_flamingo_tpu/normalizers/basic.py`` (the port imports
nothing of the JAX package): lowercase, strip bracketed/parenthesized
spans, drop symbol/mark unicode categories (optionally after NFKD to
remove diacritics), collapse whitespace; optional grapheme splitting for
space-less scripts. ``tests/test_torch_normalizers.py`` holds it against
the JAX package's.

``ADDITIONAL_DIACRITICS`` is spec data: the non-ASCII letters whose
ASCII fallback NFKD cannot produce (no decomposition exists), with the
replacements the upstream eval protocol fixed.
"""

from __future__ import annotations

import re
import unicodedata

import regex

ADDITIONAL_DIACRITICS = {
    "œ": "oe", "Œ": "OE", "ø": "o", "Ø": "O", "æ": "ae", "Æ": "AE",
    "ß": "ss", "ẞ": "SS", "đ": "d", "Đ": "D", "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "th", "ł": "l", "Ł": "L",
}

_BRACKETED = re.compile(r"[<\[][^>\]]*[>\]]")  # <...> and [...] spans
_PARENTHESIZED = re.compile(r"\(([^)]+?)\)")
_WHITESPACE_RUN = re.compile(r"\s+")
_GRAPHEME = regex.compile(r"\X", regex.U)


def remove_symbols_and_diacritics(s: str, keep: str = "") -> str:
    """Replace markers/symbols/punctuation with a space, drop diacritics.

    Characters decompose under NFKD so combining marks (category Mn) can
    be dropped individually; the ``ADDITIONAL_DIACRITICS`` table covers
    letters with no decomposition. ``keep`` exempts characters entirely.
    """
    pieces = []
    for ch in unicodedata.normalize("NFKD", s):
        if ch in keep:
            pieces.append(ch)
        elif ch in ADDITIONAL_DIACRITICS:
            pieces.append(ADDITIONAL_DIACRITICS[ch])
        else:
            category = unicodedata.category(ch)
            if category == "Mn":
                continue  # combining mark: delete (this IS the de-diacritic)
            pieces.append(" " if category[0] in "MSP" else ch)
    return "".join(pieces)


def remove_symbols(s: str) -> str:
    """Replace markers/symbols/punctuation with a space, keep diacritics
    (NFKC keeps characters composed, so marks stay attached)."""
    pieces = []
    for ch in unicodedata.normalize("NFKC", s):
        pieces.append(" " if unicodedata.category(ch)[0] in "MSP" else ch)
    return "".join(pieces)


class BasicTextNormalizer:
    def __init__(self, remove_diacritics: bool = False, split_letters: bool = False):
        self.clean = (
            remove_symbols_and_diacritics if remove_diacritics else remove_symbols
        )
        self.split_letters = split_letters

    def __call__(self, s: str) -> str:
        s = _BRACKETED.sub("", s.lower())
        s = _PARENTHESIZED.sub("", s)
        s = self.clean(s).lower()
        if self.split_letters:
            s = " ".join(_GRAPHEME.findall(s))
        # any successive whitespace -> single space (note: the reference
        # does not strip leading/trailing space; kept for exact parity)
        return _WHITESPACE_RUN.sub(" ", s)
