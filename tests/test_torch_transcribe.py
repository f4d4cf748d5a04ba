"""The port's long-form ``transcribe`` and result writers against the JAX
package's, on the CPU, in fp32, at debug dims with one set of weights in
both packages.

``transcribe``: identical text, segment tokens, seek, start and end, and
words (word, start and end identical, probabilities within 1e-5: fp32
softmaxes summed in another order). Both packages' ``transcribe`` keep the
newest power-of-two count of the chained prompt's tokens
(``bucket_prompt_lengths=True``), so the cases that chain prompts compare
them unpatched.

Writers: the same bytes as the JAX package's for every format and option.
"""

import importlib
import wave

import numpy as np
import pytest
import torch

from whisper_flamingo_tpu.models.dims import MODEL_DIMS as JMODEL_DIMS
from whisper_flamingo_tpu.models.whisper import Whisper as JWhisper
from whisper_flamingo_tpu.writers import get_writer as jget_writer

import whisper_flamingo_tpu_torch as wt
from whisper_flamingo_tpu_torch.models.dims import MODEL_DIMS
from whisper_flamingo_tpu_torch.writers import get_writer

from test_torch_model import port_from_jax
from test_transcribe import _rich_result

jtranscribe_mod = importlib.import_module("whisper_flamingo_tpu.transcribe")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The shapes are tiny: one thread each keeps the test workers that run
    side by side from contending for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    jp, tm = port_from_jax(MODEL_DIMS["debug"], seed=0)
    return JWhisper(dims=JMODEL_DIMS["debug"], params=jp), tm


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    """35 s of seeded int16 noise, as tests/test_transcribe.py writes it."""
    path = tmp_path_factory.mktemp("audio") / "x.wav"
    data = (np.random.default_rng(0).standard_normal(35 * 16000) * 1000).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(data.tobytes())
    return str(path)


CASES = [
    ("chained", dict(word_timestamps=False)),
    ("chained_words", dict(word_timestamps=True)),
    ("unconditioned_words", dict(word_timestamps=True, condition_on_previous_text=False)),
]


@pytest.mark.parametrize("name,opts", CASES, ids=[c[0] for c in CASES])
def test_transcribe_matches_jax(models, wav, name, opts):
    """Both packages bucket the chained prompt to a power of two."""
    jmodel, tmodel = models
    kw = dict(language="en", sample_len=12, fp16=False, temperature=0.0, **opts)
    ref = jtranscribe_mod.transcribe(jmodel, wav, **kw)
    got = wt.transcribe(tmodel, wav, **kw)
    assert got["text"] == ref["text"] and got["language"] == ref["language"]
    assert len(got["segments"]) == len(ref["segments"]) > 1
    assert len({s["seek"] for s in got["segments"]}) > 1  # more than one window
    fields = ("id", "seek", "start", "end", "text", "tokens", "temperature")
    for g, r in zip(got["segments"], ref["segments"]):
        assert {k: g[k] for k in fields} == {k: r[k] for k in fields}
        assert abs(g["avg_logprob"] - r["avg_logprob"]) < 1e-4
        assert ("words" in g) == ("words" in r) == opts["word_timestamps"]
        if opts["word_timestamps"]:
            strip = [{k: w[k] for k in ("word", "start", "end")} for w in g["words"]]
            assert strip == [{k: w[k] for k in ("word", "start", "end")} for w in r["words"]]
            np.testing.assert_allclose([w["probability"] for w in g["words"]],
                                       [w["probability"] for w in r["words"]],
                                       rtol=1e-5, atol=1e-7)
    if opts["word_timestamps"]:
        assert any(s["words"] for s in got["segments"])


def test_transcribe_bound_to_the_model_and_draft_model_raises(models, wav):
    """``transcribe`` is bound to the model; ``draft_model`` (ported now)
    speculates the greedy rung and gives the plain run's segments."""
    _, tmodel = models
    assert tmodel.transcribe.__func__ is wt.transcribe
    kw = dict(language="en", temperature=0.0, sample_len=8, fp16=False,
              condition_on_previous_text=False)
    plain = wt.transcribe(tmodel, wav, **kw)
    spec = wt.transcribe(tmodel, wav, draft_model=tmodel, draft_len=3, **kw)
    assert [s["tokens"] for s in spec["segments"]] == [s["tokens"] for s in plain["segments"]]
    assert spec["text"] == plain["text"]


def _simple_result(words: bool):
    seg = {
        "id": 0, "seek": 0, "start": 0.0, "end": 1.5, "text": " hello world",
        "tokens": [1, 2], "temperature": 0.0, "avg_logprob": -0.1,
        "compression_ratio": 1.0, "no_speech_prob": 0.01,
    }
    if words:
        seg["words"] = [
            {"word": " hello", "start": 0.0, "end": 0.7, "probability": 0.9},
            {"word": " world", "start": 0.7, "end": 1.5, "probability": 0.8},
        ]
    return {"text": "hello world", "language": "en", "segments": [seg]}


RESULTS = {
    "simple_words": lambda: _simple_result(True),
    "simple_wordless": lambda: _simple_result(False),
    "rich": _rich_result,
    "empty": lambda: {"text": "", "language": "en", "segments": []},
}
OPTIONS = [
    None,
    {"max_line_width": 6, "max_line_count": 1},
    {"max_line_width": 12, "max_line_count": 2},
    {"max_line_width": 10, "max_line_count": 3, "highlight_words": True},
    {"highlight_words": True},
    {"max_words_per_line": 2},
    {"max_words_per_line": 3, "max_line_width": 15, "max_line_count": 2},
]


@pytest.mark.parametrize("options", OPTIONS, ids=[str(o) for o in OPTIONS])
@pytest.mark.parametrize("fmt", ["txt", "vtt", "srt", "tsv", "json"])
@pytest.mark.parametrize("which", list(RESULTS))
def test_writers_match_jax(tmp_path, which, fmt, options):
    ours_dir, ref_dir = tmp_path / "ours", tmp_path / "ref"
    ours_dir.mkdir(), ref_dir.mkdir()
    get_writer(fmt, str(ours_dir))(RESULTS[which](), "a.wav", options)
    jget_writer(fmt, str(ref_dir))(RESULTS[which](), "a.wav", options)
    assert (ours_dir / f"a.{fmt}").read_bytes() == (ref_dir / f"a.{fmt}").read_bytes()


def test_writer_all_writes_every_format(tmp_path):
    get_writer("all", str(tmp_path))(_rich_result(), "b.wav", {"highlight_words": True})
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "b.json", "b.srt", "b.tsv", "b.txt", "b.vtt"
    ]
