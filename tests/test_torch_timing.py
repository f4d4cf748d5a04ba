"""The port's word-timing path against the JAX package, on the CPU, in fp32,
at debug dims with one set of weights in both packages.

- DTW: the plain wavefront's trace equals the JAX Pallas kernel's (in
  interpret mode) and the ``lax.scan`` wavefront's, and the path equals the
  numpy DP's, exactly (the same tie cascade and one fp32 add per cell);
- the median filter is a selection: exact;
- the cross-attention logits: atol 1e-4, as the logits of the model tests
  (fp32 sums taken in another order);
- the alignment matrix and token probabilities against the JAX package's
  eager order: rtol 2e-4 / atol 2e-5, the bound the JAX package holds its
  own fused program to;
- words end to end: identical words, tokens, start and end on the seeds
  used here (a near-tie in the DTW could flip a step on a 1e-6 difference
  of the matrix, so the seeds are chosen where none does), probabilities
  within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_flamingo_tpu.models import whisper as jw
from whisper_flamingo_tpu.models.dims import MODEL_DIMS as JMODEL_DIMS
from whisper_flamingo_tpu.ops import dtw as jdtw
from whisper_flamingo_tpu.ops.dtw_pallas import dtw_trace_pallas
from whisper_flamingo_tpu.ops.median import median_filter as jmedian_filter
from whisper_flamingo_tpu.timing import add_word_timestamps as jadd_word_timestamps
from whisper_flamingo_tpu.timing import find_alignment as jfind_alignment
from whisper_flamingo_tpu.tokenizer import get_tokenizer as jget_tokenizer

from whisper_flamingo_tpu_torch.models import whisper as tw
from whisper_flamingo_tpu_torch.models.dims import MODEL_DIMS
from whisper_flamingo_tpu_torch.ops import dtw as tdtw
from whisper_flamingo_tpu_torch.ops.median import median_filter
from whisper_flamingo_tpu_torch.timing import add_word_timestamps, alignment_matrix, find_alignment
from whisper_flamingo_tpu_torch.tokenizer import get_tokenizer

from test_torch_model import port_from_jax

DIMS = MODEL_DIMS["debug"]


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
    """(JAX Whisper, port model) from one JAX init_params(PRNGKey(0), debug)."""
    jp, tm = port_from_jax(DIMS, seed=0)
    return jw.Whisper(dims=JMODEL_DIMS["debug"], params=jp), tm


@pytest.fixture(scope="module")
def tokenizers():
    return (jget_tokenizer(True, language="en", task="transcribe"),
            get_tokenizer(True, language="en", task="transcribe"))


DTW_CASES = [
    ("randn", (9, 17)), ("randn", (33, 70)), ("randn", (64, 128)), ("randn", (65, 1500)),
    ("ints", (9, 17)), ("ints", (33, 70)), ("ints", (64, 128)),
    ("randn", (1, 40)), ("randn", (40, 1)), ("randn", (1, 1)),
]


@pytest.mark.parametrize("kind,shape", DTW_CASES, ids=[f"{k}{s}" for k, s in DTW_CASES])
def test_dtw_plain_matches_jax(kind, shape):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    if kind == "ints":  # tie-rich, as tests/test_timing.py
        x = rng.integers(0, 2, shape).astype(np.float32)
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    trace = tdtw.dtw_trace_plain(torch.from_numpy(x))
    assert trace.dtype == torch.int8 and trace.shape == (shape[0] + 1, shape[1] + 1)
    trace = trace.numpy()
    np.testing.assert_array_equal(trace, dtw_trace_pallas(x, interpret=True))
    np.testing.assert_array_equal(trace, jdtw.dtw_costs_jax(x)[1])
    expected = jdtw.dtw_np(x)
    np.testing.assert_array_equal(tdtw.dtw(x), expected)
    np.testing.assert_array_equal(tdtw.dtw(torch.from_numpy(x)), expected)
    np.testing.assert_array_equal(tdtw.dtw_np(x), expected)


@pytest.mark.parametrize("shape", [(0, 5), (5, 0)])
def test_dtw_empty_matches_jax(shape):
    x = np.zeros(shape, np.float32)
    for got in (tdtw.dtw(x), tdtw.dtw(torch.from_numpy(x))):
        assert got.shape == (2, 0)
        np.testing.assert_array_equal(got, jdtw.dtw(x))


@pytest.mark.parametrize("width,shape", [
    (3, (50,)), (7, (3, 20, 40)), (7, (2, 5)), (7, (4, 3)), (3, (6, 1)), (1, (2, 9)),
])
def test_median_filter_matches_jax(width, shape):
    """Widths 3 and 7 over a leading batch, and the pass-through of an input
    no wider than half the width ((4, 3) and (6, 1))."""
    x = np.random.default_rng(width).standard_normal(shape).astype(np.float32)
    x[..., ::3] = 0.5  # ties inside windows
    got = median_filter(torch.from_numpy(x), width).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmedian_filter(x, width)))


def _tokens(tok, text):
    return np.array([*tok.sot_sequence, tok.no_timestamps, *tok.encode(text), tok.eot], np.int64)


def test_return_cross_qk_matches_jax(models, tokenizers):
    jmodel, tmodel = models
    tokens = _tokens(tokenizers[1], " the quick brown fox")
    mel = np.random.default_rng(1).standard_normal((1, 80, 3000)).astype(np.float32)
    jfeats = jw.encoder_apply(jmodel.params, jmodel.dims, jnp.asarray(mel))
    jlogits, jqks = jw.decoder_apply(
        jmodel.params, jmodel.dims, jnp.asarray(tokens[None], jnp.int32), jfeats,
        return_cross_qk=True,
    )
    feats = tw.encoder_apply(tmodel, DIMS, torch.from_numpy(mel))
    logits, qks = tw.decoder_apply(
        tmodel, DIMS, torch.from_numpy(tokens[None]), feats, return_cross_qk=True
    )
    L, H = DIMS.n_text_layer, DIMS.n_text_head
    assert qks.dtype == torch.float32 and qks.shape == (L, 1, H, len(tokens), DIMS.n_audio_ctx)
    np.testing.assert_allclose(qks.numpy(), np.asarray(jqks), atol=1e-4, rtol=0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
    with pytest.raises(ValueError):  # the teacher-forced path only
        tw.decoder_apply(tmodel, DIMS, torch.from_numpy(tokens[None]), feats, cache={},
                         return_cross_qk=True)


def test_alignment_heads_match_jax(models):
    jmodel, tmodel = models
    np.testing.assert_array_equal(tmodel.get_alignment_heads(), jmodel.get_alignment_heads())
    from whisper_flamingo_tpu_torch.registry import ALIGNMENT_HEADS

    with torch.device("meta"):  # the bitmap needs the dims, not the weights
        small = tw.Whisper(MODEL_DIMS["small"])
    jsmall = jw.Whisper(dims=JMODEL_DIMS["small"], params=None)
    small.set_alignment_heads(ALIGNMENT_HEADS["small"])
    jsmall.set_alignment_heads(ALIGNMENT_HEADS["small"])
    np.testing.assert_array_equal(small.get_alignment_heads(), jsmall.get_alignment_heads())
    assert small.get_alignment_heads().sum() < small.get_alignment_heads().size


def _jax_eager_alignment(jmodel, tok, text_tokens, mel, num_frames):
    """The JAX package's eager reference order (tests/test_timing.py):
    slice -> softmax -> z-norm -> median filter -> mean over heads."""
    tokens = np.array([*tok.sot_sequence, tok.no_timestamps, *text_tokens, tok.eot], np.int32)
    n_sot = len(tok.sot_sequence)
    feats = jw.encoder_apply(jmodel.params, jmodel.dims, jnp.asarray(mel), dtype=jmodel.dtype)
    logits, qks = jw.decoder_apply(
        jmodel.params, jmodel.dims, jnp.asarray(tokens[None]), feats,
        dtype=jmodel.dtype, return_cross_qk=True,
    )
    sampled = np.asarray(logits[0, n_sot:, : tok.eot], np.float32)
    e = np.exp(sampled - sampled.max(-1, keepdims=True))
    probs = (e / e.sum(-1, keepdims=True))[np.arange(len(text_tokens)), np.asarray(text_tokens)]
    heads = np.argwhere(jmodel.get_alignment_heads())
    w = jnp.stack([qks[l, 0, h] for l, h in heads])[:, :, : num_frames // 2]
    w = jax.nn.softmax(w.astype(jnp.float32), axis=-1)
    mean = jnp.mean(w, axis=-2, keepdims=True)
    std = jnp.std(w, axis=-2, keepdims=True)
    w = jmedian_filter((w - mean) / std, 7)
    return probs, np.asarray(jnp.mean(w, axis=0))


@pytest.mark.parametrize("num_frames", [3000, 2998, 2500, 4])
def test_alignment_matrix_matches_jax_eager_order(models, tokenizers, num_frames):
    jmodel, tmodel = models
    jtok, tok = tokenizers
    text_tokens = tok.encode(" the quick brown fox")
    mel = np.random.default_rng(1).standard_normal((1, 80, 3000)).astype(np.float32)
    probs_ref, matrix_ref = _jax_eager_alignment(jmodel, jtok, text_tokens, mel, num_frames)
    probs, matrix = alignment_matrix(tmodel, tok, text_tokens, torch.from_numpy(mel), num_frames)
    assert matrix.shape == (len(text_tokens) + len(tok.sot_sequence) + 2, num_frames // 2)
    np.testing.assert_allclose(probs, probs_ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(matrix.numpy(), matrix_ref, rtol=2e-4, atol=2e-5)
    # the port's DTW on the JAX package's own matrix gives its path
    n_sot = len(tok.sot_sequence)
    cost = -matrix_ref[n_sot: n_sot + len(text_tokens) + 1]
    np.testing.assert_array_equal(tdtw.dtw(torch.from_numpy(np.ascontiguousarray(cost))),
                                  jdtw.dtw(cost))


def _assert_words_equal(got, ref):
    """Words, tokens, start and end identical; probabilities within 1e-5."""
    assert [(w.word, w.tokens, w.start, w.end) for w in got] == [
        (w.word, w.tokens, w.start, w.end) for w in ref
    ]
    np.testing.assert_allclose([w.probability for w in got], [w.probability for w in ref],
                               rtol=1e-5, atol=1e-7)


# seeds of the mel for which no near-tie of the DTW flips a step between the
# two packages' float orders
@pytest.mark.parametrize("seed,text,num_frames", [
    (0, " hello world, this is a test.", 1500),
    (1, " the quick brown fox jumps over the lazy dog", 3000),
    (2, " one two", 900),
])
def test_find_alignment_matches_jax(models, tokenizers, seed, text, num_frames):
    jmodel, tmodel = models
    jtok, tok = tokenizers
    text_tokens = tok.encode(text)
    mel = np.random.default_rng(seed).standard_normal((80, 3000)).astype(np.float32)
    ref = jfind_alignment(jmodel, jtok, text_tokens, mel, num_frames)
    got = find_alignment(tmodel, tok, text_tokens, torch.from_numpy(mel), num_frames)
    assert len(got) > 1
    _assert_words_equal(got, ref)
    assert find_alignment(tmodel, tok, [], torch.from_numpy(mel), num_frames) == []


def _assert_word_dicts_equal(got, ref):
    assert [{k: w[k] for k in ("word", "start", "end")} for w in got] == [
        {k: w[k] for k in ("word", "start", "end")} for w in ref
    ]
    np.testing.assert_allclose([w["probability"] for w in got],
                               [w["probability"] for w in ref], rtol=1e-5, atol=1e-7)


def test_add_word_timestamps_matches_jax(models, tokenizers):
    """The segments of tests/test_timing.py, and a two-segment window with
    punctuation to glue."""
    jmodel, tmodel = models
    jtok, tok = tokenizers
    mel = np.random.default_rng(0).standard_normal((80, 3000)).astype(np.float32)
    a, b = tok.encode(" hello world again"), tok.encode(' "well," she said. ok')
    cases = [
        [{"seek": 0, "start": 0.0, "end": 2.0, "tokens": a, "text": " hello world again"}],
        [{"seek": 100, "start": 1.0, "end": 5.0, "tokens": a, "text": " hello world again"},
         {"seek": 100, "start": 5.0, "end": 9.5, "tokens": b, "text": ' "well," she said. ok'}],
    ]
    for segments in cases:
        ref = [dict(s, tokens=list(s["tokens"])) for s in segments]
        got = [dict(s, tokens=list(s["tokens"])) for s in segments]
        jadd_word_timestamps(segments=ref, model=jmodel, tokenizer=jtok, mel=mel,
                             num_frames=1500, last_speech_timestamp=0.0)
        add_word_timestamps(segments=got, model=tmodel, tokenizer=tok,
                            mel=torch.from_numpy(mel), num_frames=1500,
                            last_speech_timestamp=0.0)
        for g, r in zip(got, ref):
            assert g["words"], g
            _assert_word_dicts_equal(g["words"], r["words"])
            assert (g["start"], g["end"]) == (r["start"], r["end"])
