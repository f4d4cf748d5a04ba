"""Translation lookup for conditioning streams.

Copy of ``whisper_flamingo_tpu/data/translations.py``: LibriSpeech-style
``*.trans.txt`` trees and per-split CSVs behind one ``lookup(utt_id)``
interface, and a source wrapper that attaches translations to any
:class:`~whisper_flamingo_tpu_torch.data.dataset.AsrSource`.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence


class TransTxtTreeLookup:
    """LibriSpeech-style lookup: utt id ``A-B-C`` lives in
    ``root/A/B/A-B.trans.txt`` as ``A-B-C <text>``. Chapters load lazily."""

    def __init__(self, base_dir: str):
        self.base_dir = base_dir
        self._cache: Dict[str, Dict[str, str]] = {}

    def __call__(self, utt_id: str) -> Optional[str]:
        parts = utt_id.split("-")
        if len(parts) < 3:
            return None
        speaker, chapter = parts[0], parts[1]
        key = f"{speaker}/{chapter}"
        if key not in self._cache:
            path = os.path.join(
                self.base_dir, speaker, chapter, f"{speaker}-{chapter}.trans.txt"
            )
            table: Dict[str, str] = {}
            if os.path.exists(path):
                with open(path) as f:
                    for line in f:
                        line = line.strip()
                        if line:
                            uid, _, text = line.partition(" ")
                            table[uid] = text
            self._cache[key] = table
        return self._cache[key].get(utt_id)


class CsvLookup:
    """CSV lookup keyed by an id column; value column configurable
    (``translation`` for MT CSVs, ``pseudo_text`` for pseudo-label CSVs)."""

    def __init__(self, csv_path: str, id_column: str = "id",
                 value_column: str = "translation"):
        self.table: Dict[str, str] = {}
        with open(csv_path, newline="") as f:
            for row in csv.DictReader(f):
                self.table[str(row[id_column])] = row.get(value_column, "")

    def __call__(self, utt_id: str) -> Optional[str]:
        return self.table.get(str(utt_id))


def build_lookups(
    translation_base_dirs: Sequence[str] = (),
    translation_csvs: Sequence[str] = (),
) -> List:
    """One lookup per conditioning language, in config order."""
    lookups: List = [TransTxtTreeLookup(d) for d in translation_base_dirs]
    lookups += [CsvLookup(p) for p in translation_csvs]
    return lookups


class TranslatedSource:
    """Wrap an AsrSource, attaching translations from the lookups.

    Utterances with an empty translation can be filtered out, matching
    the reference's kloka empty-translation filter
    (`whisper-flamingo_amis.py:47-77`).
    """

    def __init__(self, source, lookups: Sequence, drop_missing: bool = False):
        self.source = source
        self.lookups = list(lookups)
        if drop_missing:
            self._index = [
                i for i in range(len(source))
                if all(lk(source[i].id) for lk in self.lookups)
            ]
        else:
            self._index = list(range(len(source)))

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, idx: int):
        ex = self.source[self._index[idx]]
        ex.translations = [lk(ex.id) or "" for lk in self.lookups]
        return ex

    def lengths(self) -> List[int]:
        base = self.source.lengths()
        return [base[i] for i in self._index]
