"""Speculative greedy decoding in the port, on the CPU, fp32.

The load-bearing property: the tokens equal plain greedy's whatever the
draft proposes, at both ends of acceptance (a random ``tiny`` draft, and
the verifier as its own draft, which accepts every token), with
timestamps, a prompt and the int8 modes; and they equal the JAX package's
``decode_speculative`` on the same weights. Also the per-row-offset
decoder the rounds run on.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_flamingo_tpu.decoding import DecodingOptions as JOptions
from whisper_flamingo_tpu.models.dims import MODEL_DIMS as JMODEL_DIMS
from whisper_flamingo_tpu.models.whisper import Whisper as JWhisper
from whisper_flamingo_tpu.speculative import decode_speculative as jdecode_speculative

from whisper_flamingo_tpu_torch.decoding import DecodingOptions, DecodingTask
from whisper_flamingo_tpu_torch.models import whisper as tw
from whisper_flamingo_tpu_torch.models.dims import MODEL_DIMS
from whisper_flamingo_tpu_torch.speculative import (
    SpeculativeDecodingTask,
    decode_speculative,
    make_spec_round,
)

from test_torch_model import port_from_jax

DIMS = MODEL_DIMS["debug"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    """(JAX verifier, JAX draft, port verifier, port draft): ``debug`` and
    ``tiny`` with random weights from seeds 0 and 1."""
    jv, tv = port_from_jax(DIMS, seed=0)
    jd, td = port_from_jax(MODEL_DIMS["tiny"], seed=1)
    return (JWhisper(dims=JMODEL_DIMS["debug"], params=jv),
            JWhisper(dims=JMODEL_DIMS["tiny"], params=jd), tv, td)


@pytest.fixture(scope="module")
def mel():
    return np.random.default_rng(1).standard_normal((2, 80, 3000)).astype(np.float32) * 0.4


def _opts(**kw):
    return DecodingOptions(**dict(dict(language="en", fp16=False, sample_len=10,
                                       without_timestamps=True), **kw))


def _same_as_greedy(model, draft, mel, opts, draft_len):
    base = DecodingTask(model, opts).run(torch.from_numpy(mel))
    task = SpeculativeDecodingTask(model, draft, opts, draft_len=draft_len)
    got = task.run(torch.from_numpy(mel))
    for b, g in zip(base, got):
        assert g.tokens == b.tokens
        assert abs(g.avg_logprob - b.avg_logprob) < 1e-4
        assert abs(g.no_speech_prob - b.no_speech_prob) < 1e-6
    return task.last_stats


@pytest.mark.parametrize("draft_len", [1, 4, 8])
def test_matches_greedy_random_draft(models, mel, draft_len):
    _, _, tv, td = models
    stats = _same_as_greedy(tv, td, mel, _opts(), draft_len)
    assert stats["rounds"] >= 1


@pytest.mark.parametrize("draft_len", [1, 4, 8])
def test_matches_greedy_full_acceptance(models, mel, draft_len):
    """The verifier as its own draft accepts every token: 11 tokens after
    the prefill's first at K + 1 per round (a row may stop earlier at
    EOT)."""
    _, _, tv, _ = models
    opts = _opts(sample_len=12, suppress_tokens="-1,50257")  # EOT suppressed: full length
    stats = _same_as_greedy(tv, tv, mel, opts, draft_len)
    assert stats["rounds"] == -(-11 // (draft_len + 1))
    assert stats["accepted_tokens"] == 2 * 11


@pytest.mark.parametrize("case", ["timestamps", "prompt", "int8", "int8kv"])
def test_matches_greedy_variants(models, mel, case):
    _, _, tv, td = models
    kw = {"timestamps": dict(without_timestamps=False),
          "prompt": dict(prompt=[21, 99, 7], sample_len=8),
          "int8": dict(quantize="int8", sample_len=8),
          "int8kv": dict(quantize="int8kv", sample_len=8)}[case]
    _same_as_greedy(tv, td, mel, _opts(**kw), 3)
    if case == "timestamps":  # acceptance through the timestamp rules
        _same_as_greedy(tv, tv, mel, _opts(**kw), 3)


@pytest.mark.parametrize("opts", [dict(), dict(quantize="int8", without_timestamps=True)],
                         ids=["timestamps", "int8"])
def test_matches_jax_decode_speculative(models, mel, opts):
    """Against JAX's own speculative decode. The int8 case runs without
    timestamps: the int8 slabs are quantized from activations that differ
    from JAX's by fp32 rounding, a few of their 768,000 values land one
    step apart, and with timestamps on that moves a near-tie at this
    seed (port and JAX greedy then differ the same way)."""
    jv, jd, tv, td = models
    common = dict(language="en", fp16=False, sample_len=8, **opts)
    ref = jdecode_speculative(jv, jd, jnp.asarray(mel), JOptions(**common), draft_len=2)
    got = decode_speculative(tv, td, torch.from_numpy(mel), DecodingOptions(**common),
                             draft_len=2)
    for r, g in zip(ref, got):
        assert g.tokens == r.tokens
        assert abs(g.avg_logprob - r.avg_logprob) < 1e-4


def test_per_row_offset_decoder_matches_scalar(models):
    """decoder_apply with a (B,) offset equals scalar-offset runs row by
    row: positions, masks and cache writes per row, for a two-token chunk
    (the plain path) and a one-token step (the decode-attention route)."""
    _, _, tv, _ = models
    rng = np.random.default_rng(0)
    B, L = 3, 16
    xa = torch.from_numpy(rng.standard_normal((B, DIMS.n_audio_ctx, DIMS.n_text_state))
                          .astype(np.float32))
    cache = tw.init_cache(tv, DIMS, xa, max_len=L)
    prefix = torch.from_numpy(rng.integers(0, DIMS.n_vocab, (B, 4)))
    tw.decoder_apply(tv, DIMS, prefix, cache=cache, offset=0)
    offsets = torch.tensor([4, 5, 6], dtype=torch.int32)
    for t in (2, 1):
        tok = torch.from_numpy(rng.integers(0, DIMS.n_vocab, (B, t)))
        rows = [{k: v[:, i:i + 1].clone() for k, v in cache.items()} for i in range(B)]
        got, cache = tw.decoder_apply(tv, DIMS, tok, cache=cache, offset=offsets)
        for i in range(B):
            ref, rc = tw.decoder_apply(tv, DIMS, tok[i:i + 1], cache=rows[i],
                                       offset=int(offsets[i]))
            torch.testing.assert_close(got[i], ref[0], atol=2e-5, rtol=0)
            torch.testing.assert_close(cache["k"][:, i], rc["k"][:, 0], atol=1e-6, rtol=0)
        offsets = offsets + t


def test_cap_finished_row_keeps_last_token(models):
    """A row at lens == caps == max_len (full budget, no EOT) beside a row
    still decoding keeps its final token: the round's (K+1)-wide EOT write
    for it lands past max_len."""
    _, _, tv, td = models
    task = DecodingTask(tv, _opts(sample_len=6))
    K, max_len = 3, task.max_len
    rng = np.random.default_rng(14)
    B = 2
    xa_v = torch.from_numpy(rng.standard_normal((B, DIMS.n_audio_ctx, DIMS.n_text_state))
                            .astype(np.float32))
    xa_d = torch.from_numpy(rng.standard_normal((B, 1500, td.dims.n_text_state))
                            .astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, 1000, (B, max_len + K + 1)))
    state = {
        "tokens": tokens.clone(),
        "lens": torch.tensor([max_len, max_len - 2]),
        "caps": torch.full((B,), max_len),
        "finished": torch.tensor([True, False]),
        "sum_logprobs": torch.zeros(B),
        "cache_v": tw.init_cache(tv, DIMS, xa_v, max_len=max_len + K),
        "cache_d": tw.init_cache(td, td.dims, xa_d, max_len=max_len + K),
    }
    round_fn = make_spec_round(DIMS, td.dims, task.filter_cfg, task.tokenizer.eot, K,
                               torch.float32)
    out = round_fn(tv, td, state)
    assert torch.equal(out["tokens"][0, :max_len], tokens[0, :max_len])
    assert int(out["lens"][0]) == max_len and int(out["lens"][1]) > max_len - 2


def test_validation(models, mel):
    _, _, tv, td = models
    with pytest.raises(ValueError, match="greedy-only"):
        SpeculativeDecodingTask(tv, td, _opts(beam_size=2))
    with pytest.raises(ValueError, match="temperature"):
        SpeculativeDecodingTask(tv, td, _opts(temperature=0.5))
    with pytest.raises(ValueError, match="draft_len"):
        SpeculativeDecodingTask(tv, td, _opts(), draft_len=0)
    task = SpeculativeDecodingTask(tv, td, _opts())
    feats = torch.zeros(1, DIMS.n_audio_ctx, DIMS.n_audio_state)
    with pytest.raises(ValueError, match="raw mel"):
        task.run(feats)
    one = decode_speculative(tv, td, torch.from_numpy(mel[0]), _opts(sample_len=4), draft_len=2)
    assert isinstance(one.tokens, list)
