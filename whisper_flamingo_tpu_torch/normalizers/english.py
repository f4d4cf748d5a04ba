"""English text normalizer for WER scoring.

A copy of ``whisper_flamingo_tpu/normalizers/english.py`` (the port
imports nothing of the JAX package): spelled-out number -> arabic-digit
conversion (with ordinal/plural suffixes, currency prefixes, percent
suffixes, decimal points, double/triple, "and a half"), UK->US spelling
mapping (``english.json``, the public tysto.com spelling-pair data file),
contraction expansion, filler-word removal, and symbol/diacritic
stripping keeping numeric symbols. ``tests/test_torch_normalizers.py``
holds it against the JAX package's.
"""

from __future__ import annotations

import json
import os
import re
from fractions import Fraction
from typing import List, Optional, Union

from .basic import remove_symbols_and_diacritics

_ONES_WORDS = [
    "one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
    "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen", "sixteen",
    "seventeen", "eighteen", "nineteen",
]
_TENS_WORDS = {
    "twenty": 20, "thirty": 30, "forty": 40, "fifty": 50,
    "sixty": 60, "seventy": 70, "eighty": 80, "ninety": 90,
}
_MULTIPLIER_WORDS = {
    "hundred": 10**2, "thousand": 10**3, "million": 10**6, "billion": 10**9,
    "trillion": 10**12, "quadrillion": 10**15, "quintillion": 10**18,
    "sextillion": 10**21, "septillion": 10**24, "octillion": 10**27,
    "nonillion": 10**30, "decillion": 10**33,
}

_NUMERIC_RE = re.compile(r"^\d+(\.\d+)?$")


def _irregular_ordinal(name: str, value: int) -> Optional[str]:
    special = {1: None, 2: None, 3: None, 5: "fifth", 12: "twelfth"}
    if value in special:
        return special[value]
    return name + ("h" if name.endswith("t") else "th")


class _Vocab:
    """Word tables for the number engine (data per the reference spec)."""

    def __init__(self):
        self.zeros = {"o", "oh", "zero"}
        self.ones = {w: i for i, w in enumerate(_ONES_WORDS, start=1)}
        self.ones_suffixed = {}
        for w, v in self.ones.items():
            plural = "sixes" if w == "six" else w + "s"
            self.ones_suffixed[plural] = (v, "s")
        self.ones_suffixed.update(
            {"zeroth": (0, "th"), "first": (1, "st"), "second": (2, "nd"),
             "third": (3, "rd"), "fifth": (5, "th"), "twelfth": (12, "th")}
        )
        for w, v in self.ones.items():
            if v > 3 and v not in (5, 12):
                self.ones_suffixed[w + ("h" if w.endswith("t") else "th")] = (v, "th")

        self.tens = dict(_TENS_WORDS)
        self.tens_suffixed = {}
        for w, v in self.tens.items():
            self.tens_suffixed[w.replace("y", "ies")] = (v, "s")
            self.tens_suffixed[w.replace("y", "ieth")] = (v, "th")

        self.multipliers = dict(_MULTIPLIER_WORDS)
        self.multipliers_suffixed = {}
        for w, v in self.multipliers.items():
            self.multipliers_suffixed[w + "s"] = (v, "s")
            self.multipliers_suffixed[w + "th"] = (v, "th")

        self.preceding_prefixers = {
            "minus": "-", "negative": "-", "plus": "+", "positive": "+",
        }
        self.following_prefixers = {
            "pound": "£", "pounds": "£", "euro": "€", "euros": "€",
            "dollar": "$", "dollars": "$", "cent": "¢", "cents": "¢",
        }
        self.prefixes = set(self.preceding_prefixers.values()) | set(
            self.following_prefixers.values()
        )
        self.suffixers = {"per": {"cent": "%"}, "percent": "%"}
        self.specials = {"and", "double", "triple", "point"}
        self.decimals = set(self.ones) | set(self.tens) | self.zeros

        self.words = set()
        for table in (
            self.zeros, self.ones, self.ones_suffixed, self.tens,
            self.tens_suffixed, self.multipliers, self.multipliers_suffixed,
            self.preceding_prefixers, self.following_prefixers,
            self.suffixers, self.specials,
        ):
            self.words.update(table)


class EnglishNumberNormalizer:
    """Convert spelled-out numbers to arabic digits.

    Handles comma removal, ordinal/plural suffixes (1960s, 274th, 32nd),
    currency symbol placement ($20 million -> 20000000 dollars), literal
    "one"/"ones", and nominal digit sequences ("one oh one" -> 101).
    """

    def __init__(self):
        self.v = _Vocab()

    # -- engine -------------------------------------------------------------

    def _emit(self, out: List[str], text: Union[str, int]):
        text = str(text)
        if self._prefix is not None:
            text = self._prefix + text
        self._prefix = None
        self._value = None
        out.append(text)

    def _flush(self, out: List[str]):
        if self._value is not None:
            self._emit(out, self._value)

    def process_words(self, words: List[str]) -> List[str]:
        v = self.v
        out: List[str] = []
        self._prefix: Optional[str] = None
        self._value: Optional[Union[str, int]] = None
        n = len(words)
        i = 0
        while i < n:
            cur = words[i]
            prev = words[i - 1] if i > 0 else None
            nxt = words[i + 1] if i + 1 < n else None
            i += 1

            next_is_numeric = nxt is not None and _NUMERIC_RE.match(nxt)
            has_prefix = cur[0] in v.prefixes
            bare = cur[1:] if has_prefix else cur

            if _NUMERIC_RE.match(bare):
                # arabic numbers, possibly signed / currency-prefixed
                if self._value is not None:
                    if isinstance(self._value, str) and self._value.endswith("."):
                        # decimal / ip-address continuation
                        self._value = str(self._value) + str(cur)
                        continue
                    self._flush(out)
                if has_prefix:
                    self._prefix = cur[0]
                frac = Fraction(bare)
                self._value = frac.numerator if frac.denominator == 1 else bare
            elif cur not in v.words:
                self._flush(out)
                self._emit(out, cur)
            elif cur in v.zeros:
                self._value = str(self._value or "") + "0"
            elif cur in v.ones:
                self._value = self._append_ones(prev, v.ones[cur])
            elif cur in v.ones_suffixed:
                ones, suffix = v.ones_suffixed[cur]
                self._emit(out, str(self._append_ones(prev, ones)) + suffix)
                self._value = None
            elif cur in v.tens:
                tens = v.tens[cur]
                if self._value is None:
                    self._value = tens
                elif isinstance(self._value, str):
                    self._value = str(self._value) + str(tens)
                elif self._value % 100 == 0:
                    self._value += tens
                else:
                    self._value = str(self._value) + str(tens)
            elif cur in v.tens_suffixed:
                tens, suffix = v.tens_suffixed[cur]
                if self._value is None:
                    self._emit(out, str(tens) + suffix)
                elif isinstance(self._value, str):
                    self._emit(out, str(self._value) + str(tens) + suffix)
                elif self._value % 100 == 0:
                    self._emit(out, str(self._value + tens) + suffix)
                else:
                    self._emit(out, str(self._value) + str(tens) + suffix)
            elif cur in v.multipliers:
                mult = v.multipliers[cur]
                if self._value is None:
                    self._value = mult
                elif isinstance(self._value, str) or self._value == 0:
                    frac = _to_fraction(self._value)
                    prod = frac * mult if frac is not None else None
                    if prod is not None and prod.denominator == 1:
                        self._value = prod.numerator
                    else:
                        self._flush(out)
                        self._value = mult
                else:
                    before = self._value // 1000 * 1000
                    residual = self._value % 1000
                    self._value = before + residual * mult
            elif cur in v.multipliers_suffixed:
                mult, suffix = v.multipliers_suffixed[cur]
                if self._value is None:
                    self._emit(out, str(mult) + suffix)
                elif isinstance(self._value, str):
                    frac = _to_fraction(self._value)
                    prod = frac * mult if frac is not None else None
                    if prod is not None and prod.denominator == 1:
                        self._emit(out, str(prod.numerator) + suffix)
                    else:
                        self._flush(out)
                        self._emit(out, str(mult) + suffix)
                else:
                    before = self._value // 1000 * 1000
                    residual = self._value % 1000
                    self._emit(out, str(before + residual * mult) + suffix)
                self._value = None
            elif cur in v.preceding_prefixers:
                # sign applies only when a number follows
                self._flush(out)
                if (nxt in v.words) or next_is_numeric:
                    self._prefix = v.preceding_prefixers[cur]
                else:
                    self._emit(out, cur)
            elif cur in v.following_prefixers:
                # currency symbol applies only after a number
                if self._value is not None:
                    self._prefix = v.following_prefixers[cur]
                    self._flush(out)
                else:
                    self._emit(out, cur)
            elif cur in v.suffixers:
                if self._value is not None:
                    suffix = v.suffixers[cur]
                    if isinstance(suffix, dict):
                        if nxt in suffix:
                            self._emit(out, str(self._value) + suffix[nxt])
                            i += 1  # consume the suffix word
                        else:
                            self._flush(out)
                            self._emit(out, cur)
                    else:
                        self._emit(out, str(self._value) + suffix)
                else:
                    self._emit(out, cur)
            elif cur in v.specials:
                if (nxt not in v.words) and not next_is_numeric:
                    self._flush(out)
                    self._emit(out, cur)
                elif cur == "and":
                    # swallow "and" after hundred/thousand/...
                    if prev not in v.multipliers:
                        self._flush(out)
                        self._emit(out, cur)
                elif cur in ("double", "triple"):
                    if nxt in v.ones or nxt in v.zeros:
                        repeats = 2 if cur == "double" else 3
                        digit = v.ones.get(nxt, 0)
                        self._value = str(self._value or "") + str(digit) * repeats
                        i += 1  # consume the repeated digit word
                    else:
                        self._flush(out)
                        self._emit(out, cur)
                elif cur == "point":
                    if nxt in v.decimals or next_is_numeric:
                        self._value = str(self._value or "") + "."
            else:  # pragma: no cover
                raise ValueError(f"Unexpected token: {cur}")

        self._flush(out)
        return out

    def _append_ones(self, prev: Optional[str], ones: int):
        """Fold a ones-word into the running value (nominal-sequence rules)."""
        v = self.v
        value = self._value
        if value is None:
            return ones
        if isinstance(value, str) or prev in v.ones:
            if prev in v.tens and ones < 10:
                assert str(value)[-1] == "0"
                return str(value)[:-1] + str(ones)
            return str(value) + str(ones)
        if ones < 10:
            return value + ones if value % 10 == 0 else str(value) + str(ones)
        # eleven..nineteen
        return value + ones if value % 100 == 0 else str(value) + str(ones)

    # -- pre/post -----------------------------------------------------------

    def preprocess(self, s: str) -> str:
        # "<number> and a half" -> "<number> point five" when it follows one
        pieces = []
        segments = re.split(r"\band\s+a\s+half\b", s)
        for i, segment in enumerate(segments):
            if len(segment.strip()) == 0:
                continue
            if i == len(segments) - 1:
                pieces.append(segment)
            else:
                pieces.append(segment)
                last_word = segment.rsplit(maxsplit=2)[-1]
                if last_word in self.v.decimals or last_word in self.v.multipliers:
                    pieces.append("point five")
                else:
                    pieces.append("and a half")
        s = " ".join(pieces)

        # space at number/letter boundaries, except ordinal/plural suffixes
        s = re.sub(r"([a-z])([0-9])", r"\1 \2", s)
        s = re.sub(r"([0-9])([a-z])", r"\1 \2", s)
        s = re.sub(r"([0-9])\s+(st|nd|rd|th|s)\b", r"\1\2", s)
        return s

    def postprocess(self, s: str) -> str:
        def combine_cents(m: re.Match) -> str:
            try:
                return f"{m.group(1)}{m.group(2)}.{int(m.group(3)):02d}"
            except ValueError:  # pragma: no cover
                return m.string

        def extract_cents(m: re.Match) -> str:
            try:
                return f"¢{int(m.group(1))}"
            except ValueError:  # pragma: no cover
                return m.string

        # "$2 and ¢7" -> "$2.07"; "$0.79" -> "¢79"
        s = re.sub(r"([€£$])([0-9]+) (?:and )?¢([0-9]{1,2})\b", combine_cents, s)
        s = re.sub(r"[€£$]0.([0-9]{1,2})\b", extract_cents, s)
        # keep literal "one(s)" readable
        s = re.sub(r"\b1(s?)\b", r"one\1", s)
        return s

    def __call__(self, s: str) -> str:
        s = self.preprocess(s)
        s = " ".join(w for w in self.process_words(s.split()) if w is not None)
        return self.postprocess(s)


def _to_fraction(s) -> Optional[Fraction]:
    try:
        return Fraction(s)
    except ValueError:
        return None


class EnglishSpellingNormalizer:
    """British -> American spelling mapping (tysto.com word-pair data)."""

    def __init__(self):
        mapping_path = os.path.join(os.path.dirname(__file__), "english.json")
        with open(mapping_path) as f:
            self.mapping = json.load(f)

    def __call__(self, s: str) -> str:
        return " ".join(self.mapping.get(word, word) for word in s.split())


class EnglishTextNormalizer:
    def __init__(self):
        self.ignore_patterns = r"\b(hmm|mm|mhm|mmm|uh|um)\b"
        self.replacers = {
            # common contractions
            r"\bwon't\b": "will not",
            r"\bcan't\b": "can not",
            r"\blet's\b": "let us",
            r"\bain't\b": "aint",
            r"\by'all\b": "you all",
            r"\bwanna\b": "want to",
            r"\bgotta\b": "got to",
            r"\bgonna\b": "going to",
            r"\bi'ma\b": "i am going to",
            r"\bimma\b": "i am going to",
            r"\bwoulda\b": "would have",
            r"\bcoulda\b": "could have",
            r"\bshoulda\b": "should have",
            r"\bma'am\b": "madam",
            # titles/prefixes
            r"\bmr\b": "mister ",
            r"\bmrs\b": "missus ",
            r"\bst\b": "saint ",
            r"\bdr\b": "doctor ",
            r"\bprof\b": "professor ",
            r"\bcapt\b": "captain ",
            r"\bgov\b": "governor ",
            r"\bald\b": "alderman ",
            r"\bgen\b": "general ",
            r"\bsen\b": "senator ",
            r"\brep\b": "representative ",
            r"\bpres\b": "president ",
            r"\brev\b": "reverend ",
            r"\bhon\b": "honorable ",
            r"\basst\b": "assistant ",
            r"\bassoc\b": "associate ",
            r"\blt\b": "lieutenant ",
            r"\bcol\b": "colonel ",
            r"\bjr\b": "junior ",
            r"\bsr\b": "senior ",
            r"\besq\b": "esquire ",
            # perfect tenses
            r"'d been\b": " had been",
            r"'s been\b": " has been",
            r"'d gone\b": " had gone",
            r"'s gone\b": " has gone",
            r"'d done\b": " had done",
            r"'s got\b": " has got",
            # general contractions
            r"n't\b": " not",
            r"'re\b": " are",
            r"'s\b": " is",
            r"'d\b": " would",
            r"'ll\b": " will",
            r"'t\b": " not",
            r"'ve\b": " have",
            r"'m\b": " am",
        }
        self.standardize_numbers = EnglishNumberNormalizer()
        self.standardize_spellings = EnglishSpellingNormalizer()

    def __call__(self, s: str) -> str:
        s = s.lower()

        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)  # remove words between brackets
        s = re.sub(r"\(([^)]+?)\)", "", s)  # remove words between parenthesis
        s = re.sub(self.ignore_patterns, "", s)
        s = re.sub(r"\s+'", "'", s)  # space before an apostrophe

        for pattern, replacement in self.replacers.items():
            s = re.sub(pattern, replacement, s)

        s = re.sub(r"(\d),(\d)", r"\1\2", s)  # commas between digits
        s = re.sub(r"\.([^0-9]|$)", r" \1", s)  # periods not followed by numbers
        s = remove_symbols_and_diacritics(s, keep=".%$¢€£")  # keep numeric symbols

        s = self.standardize_numbers(s)
        s = self.standardize_spellings(s)

        # prefix/suffix symbols not adjacent to numbers
        s = re.sub(r"[.$¢€£]([^0-9])", r" \1", s)
        s = re.sub(r"([^0-9])%", r"\1 ", s)

        s = re.sub(r"\s+", " ", s)
        return s
