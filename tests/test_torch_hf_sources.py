"""The port's ``HFAsrSource`` against the JAX package's over the in-memory
``datasets.Dataset`` fakes of ``test_hf_sources.py`` (real ``filter`` and
``concatenate_datasets``; only the hub fetch is stubbed): the same
``load_dataset`` calls, the same printed filter counts, and examples with
equal audio bits, text, ids, translations and prompts. Covers the kloka
"+"-concat with the empty-"chinese" filter and the language_dialect
prompt, the split remap (suffix appended, kept, or appended to another
split's suffix), the fleurs field map and an 8 kHz resample, and the
recipes' ``hf:<name>[:<config>]`` spec.
"""

import numpy as np
import pytest

datasets = pytest.importorskip("datasets")

from whisper_flamingo_tpu.data.dataset import HFAsrSource as JHFAsrSource

from whisper_flamingo_tpu_torch.config import TrainConfig
from whisper_flamingo_tpu_torch.data.dataset import HFAsrSource
from whisper_flamingo_tpu_torch.recipes import common

from test_hf_sources import _audio, _fake_kloka


def _fleurs():
    return datasets.Dataset.from_dict({
        "audio": [_audio(seed=7), _audio(seed=8)],
        "transcription": ["the fleurs text", "a second one"],
        "raw_transcription": ["The Fleurs Text.", "A second one."],
        "id": [42, 43],
    })


def _librispeech():
    return datasets.Dataset.from_dict({
        "audio": [_audio(n=800, sr=8000, seed=9), _audio(n=1234, sr=16000, seed=10)],
        "text": ["HELLO WORLD", "SECOND"],
        "id": ["1089-134686-0000", "1089-134686-0001"],
    })


def _loader(calls):
    def fake_load(name, config=None, split=None, **kw):
        calls.append((name, config, split))
        if name.startswith("formospeech/kloka"):
            return _fake_kloka(config)
        if name == "google/fleurs":
            return _fleurs()
        return _librispeech()

    return fake_load


def _both(monkeypatch, capsys, *args, **kwargs):
    """(port source, JAX source, port calls, JAX calls), each built with the
    same arguments; their printed output must be the same."""
    mine, theirs = [], []
    monkeypatch.setattr(datasets, "load_dataset", _loader(mine))
    src = HFAsrSource(*args, **kwargs)
    out_mine = capsys.readouterr().out
    monkeypatch.setattr(datasets, "load_dataset", _loader(theirs))
    ref = JHFAsrSource(*args, **kwargs)
    assert capsys.readouterr().out == out_mine
    return src, ref, mine, theirs


def _same_examples(src, ref):
    assert len(src) == len(ref)
    for i in range(len(ref)):
        a, b = src[i], ref[i]
        assert a.audio.dtype == b.audio.dtype == np.float32
        np.testing.assert_array_equal(a.audio, b.audio)
        assert (a.text, a.id, a.translations, a.prompt) == (b.text, b.id, b.translations, b.prompt)


CASES = {
    "kloka_concat_filter": (("formospeech/kloka_crawled_asr",),
                            dict(split="train", config="amis_a + amis_b")),
    "kloka_eval_remap": (("formospeech/kloka_crawled_asr",),
                         dict(split="validation", config="amis_a")),
    "kloka_suffix_kept": (("formospeech/kloka_crawled_asr_eval",),
                          dict(split="test", config="amis_b")),
    "kloka_other_suffix": (("formospeech/kloka_crawled_asr_train",),
                           dict(split="validation", config="amis_a")),
    "fleurs_field_map": (("google/fleurs",), dict(split="validation", config="en_us")),
    "librispeech_resample": (("librispeech_asr",), dict(split="train.clean.100")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hf_source_equals_jax(monkeypatch, capsys, case):
    args, kwargs = CASES[case]
    src, ref, mine, theirs = _both(monkeypatch, capsys, *args, **kwargs)
    assert mine == theirs
    _same_examples(src, ref)


def test_kloka_rows_and_fields(monkeypatch, capsys):
    """The kloka quirks themselves: 5 rows less the 2 empty-"chinese"
    rows, the chinese translation stream, the language_dialect prompt."""
    src, _, mine, _ = _both(monkeypatch, capsys, "formospeech/kloka_crawled_asr",
                            split="train", config="amis_a+amis_b")
    assert mine == [("formospeech/kloka_crawled_asr_train", "amis_a", "train"),
                    ("formospeech/kloka_crawled_asr_train", "amis_b", "train")]
    assert [src[i].text for i in range(len(src))] == ["a one", "a three", "b two"]
    assert src[0].translations == ["中文一"] and src[2].prompt == "阿美語_秀姑巒"
    lib = HFAsrSource("librispeech_asr", split="train")
    assert len(lib[0].audio) == 1600 and len(lib[1].audio) == 1234  # 8 kHz -> 16 kHz


def test_recipe_hf_spec_builds_the_source(monkeypatch):
    calls = []
    monkeypatch.setattr(datasets, "load_dataset", _loader(calls))
    cfg = TrainConfig(device="cpu")
    src = common.build_source("hf:formospeech/kloka_crawled_asr:amis_a+amis_b", "validation", cfg)
    assert isinstance(src, HFAsrSource) and len(src) == 3
    assert calls == [("formospeech/kloka_crawled_asr_eval", "amis_a", "train"),
                     ("formospeech/kloka_crawled_asr_eval", "amis_b", "train")]
    src = common.build_source("hf:google/fleurs:en_us", "test", cfg)
    assert src[1].text == "a second one" and src[1].id == "43"
