"""The port's decode loop against the JAX package's, on the CPU, in fp32
(``fp16=False``), at debug dims with one set of weights in both packages.

Tokens must be identical; ``avg_logprob`` and ``no_speech_prob`` agree
within 1e-4 (fp32 sums in another order over a 51865-way log-softmax).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_flamingo_tpu.decoding import DecodingOptions as JOptions
from whisper_flamingo_tpu.decoding import DecodingTask as JTask
from whisper_flamingo_tpu.models.dims import MODEL_DIMS as JMODEL_DIMS
from whisper_flamingo_tpu.models.whisper import ModelExtras as JExtras
from whisper_flamingo_tpu.models.whisper import Whisper as JWhisper
from whisper_flamingo_tpu.tokenizer import get_tokenizer as jget_tokenizer

from whisper_flamingo_tpu_torch.decoding import DecodingOptions, DecodingTask
from whisper_flamingo_tpu_torch.models.dims import MODEL_DIMS
from whisper_flamingo_tpu_torch.tokenizer import get_tokenizer

from test_torch_model import port_from_jax

DIMS = MODEL_DIMS["debug"]
GATED = dict(add_gated_x_attn=1, num_langs=1, bert_dim=48)


@pytest.fixture(scope="module")
def models():
    jp, tm = port_from_jax(DIMS, seed=3)
    jp_g, tm_g = port_from_jax(DIMS, GATED, seed=4, gate=0.8)
    jdims = JMODEL_DIMS["debug"]
    jplain = JWhisper(dims=jdims, params=jp)
    jgated = JWhisper(dims=jdims, params=jp_g, extras=JExtras(**GATED))
    return {"plain": (jplain, tm), "gated": (jgated, tm_g)}


@pytest.fixture(scope="module")
def mel():
    rng = np.random.default_rng(11)
    return rng.standard_normal((2, 80, 3000)).astype(np.float32) * 0.5


CASES = [
    ("greedy", "plain", dict(language="en", without_timestamps=True)),
    ("greedy_timestamps", "plain", dict(language="en")),
    ("beam3", "plain", dict(language="en", beam_size=3, without_timestamps=True)),
    ("beam3_timestamps_patience", "plain",
     dict(language="en", beam_size=3, patience=2.0, length_penalty=0.5)),
    ("greedy_prompt_prefix", "plain",
     dict(language="en", prompt="hello there", prefix="so we", without_timestamps=True)),
    ("greedy_prompt_bucketed", "plain",
     dict(language="en", prompt=list(range(100, 111)), bucket_prompt_lengths=True,
          without_timestamps=True)),
    ("greedy_xt", "gated", dict(language="en", without_timestamps=True)),
    ("beam3_xt", "gated", dict(language="en", beam_size=3, without_timestamps=True)),
]


@pytest.mark.parametrize("name,which,opts", CASES, ids=[c[0] for c in CASES])
def test_decode_matches_jax(models, mel, name, which, opts):
    jmodel, tmodel = models[which]
    xt = None
    if which == "gated":
        xt = np.random.default_rng(5).standard_normal((1, 2, 7, GATED["bert_dim"]))
        xt = xt.astype(np.float32)
    common = dict(fp16=False, sample_len=10, **opts)
    ref = JTask(jmodel, JOptions(**common)).run(
        jnp.asarray(mel), xt=None if xt is None else jnp.asarray(xt)
    )
    got = DecodingTask(tmodel, DecodingOptions(**common)).run(
        torch.from_numpy(mel), xt=None if xt is None else torch.from_numpy(xt)
    )
    for r, g in zip(ref, got):
        assert g.tokens == r.tokens
        assert g.text == r.text
        assert g.language == r.language
        assert abs(g.avg_logprob - r.avg_logprob) < 1e-4
        assert abs(g.no_speech_prob - r.no_speech_prob) < 1e-4


def test_language_detection_matches_jax(models, mel):
    jmodel, tmodel = models["plain"]
    ref = JTask(jmodel, JOptions(fp16=False, task="lang_id")).run(jnp.asarray(mel))
    got = DecodingTask(tmodel, DecodingOptions(fp16=False, task="lang_id")).run(
        torch.from_numpy(mel)
    )
    for r, g in zip(ref, got):
        assert g.language == r.language
        for code, p in r.language_probs.items():
            assert abs(g.language_probs[code] - p) < 1e-5


def test_tokenizer_matches_jax():
    text = "Hello world, it's 3:45 -- naïve café ♪ ok"
    for multilingual in (True, False):
        kw = dict(language="fr", task="translate") if multilingual else {}
        ours = get_tokenizer(multilingual, **kw)
        ref = jget_tokenizer(multilingual, **kw)
        ids = ours.encode(text)
        assert ids == ref.encode(text)
        assert ours.decode(ids) == ref.decode(ids) == text
        assert ours.sot_sequence == ref.sot_sequence
        assert ours.non_speech_tokens == ref.non_speech_tokens
        assert ours.timestamp_begin == ref.timestamp_begin
        assert ours.all_language_codes == ref.all_language_codes


def test_sampling_is_seeded_and_single_segment_decode(models, mel):
    """Temperature sampling with best_of draws from the task's seeded
    generator (repeatable, and the seed matters); a 2-D mel decodes as one
    segment. (JAX's random bits differ from torch's: no parity here.)"""
    from whisper_flamingo_tpu_torch.decoding import decode

    _, tmodel = models["plain"]
    opts = dict(language="en", fp16=False, sample_len=6, temperature=1.0, best_of=2,
                without_timestamps=True)
    a = DecodingTask(tmodel, DecodingOptions(seed=1, **opts)).run(torch.from_numpy(mel))
    b = DecodingTask(tmodel, DecodingOptions(seed=1, **opts)).run(torch.from_numpy(mel))
    c = DecodingTask(tmodel, DecodingOptions(seed=2, **opts)).run(torch.from_numpy(mel))
    assert [r.tokens for r in a] == [r.tokens for r in b]
    assert [r.tokens for r in a] != [r.tokens for r in c]
    one = decode(tmodel, mel[0], DecodingOptions(language="en", fp16=False, sample_len=6))
    batch = decode(tmodel, mel, DecodingOptions(language="en", fp16=False, sample_len=6))
    assert one.tokens == batch[0].tokens


@pytest.mark.parametrize("n_prompt", [1, 5, 8, 11, 300])
def test_bucketed_prompt_tokens_match_jax(models, n_prompt):
    """``bucket_prompt_lengths`` keeps the newest power-of-two count of the
    prompt (after the n_ctx // 2 - 1 cut), as JAX does; off, the whole
    prompt."""
    jmodel, tmodel = models["plain"]
    prompt = [int(t) for t in np.random.default_rng(n_prompt).integers(100, 1000, n_prompt)]
    for bucket in (True, False):
        opts = dict(language="en", prompt=prompt, bucket_prompt_lengths=bucket)
        got = DecodingTask(tmodel, DecodingOptions(**opts)).initial_tokens
        assert got == JTask(jmodel, JOptions(**opts)).initial_tokens
        kept = len(got) - 1 - len(DecodingTask(tmodel, DecodingOptions(language="en"))
                                  .initial_tokens)
        cut = min(n_prompt, DIMS.n_text_ctx // 2 - 1)
        assert kept == (1 << (cut.bit_length() - 1) if bucket else cut)


def test_int8_modes_not_ported(models):
    """The int8 modes are ported (``tests/test_torch_quant.py`` holds them
    against JAX): both build a task, and another mode raises."""
    _, tmodel = models["plain"]
    for mode in ("int8", "int8kv"):
        task = DecodingTask(tmodel, DecodingOptions(language="en", beam_size=2, quantize=mode))
        assert task.params.decoder.blocks[0].mlp[0].w_q.dtype == torch.int8
    with pytest.raises(ValueError, match="quantize"):
        DecodingTask(tmodel, DecodingOptions(quantize="int4"))
