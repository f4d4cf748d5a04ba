"""The port's serving layer on the CPU, fp32, debug dims: ``BatchTranscriber``
pads and unpads; ``ContinuousBatcher`` (polled, pipelined or not, with
requests arriving mid-flight, pooled with and without LPT admission,
per-request caps, speculative slots, int8) gives every request the tokens
of its own per-utterance ``decode``, and the JAX package's
``ContinuousBatcher`` tokens on the same weights and requests; the
batcher's slots and speculative decoding start from the task's prefill
set-up; the validation errors are JAX's.
"""

import numpy as np
import pytest
import torch

from whisper_flamingo_tpu.decoding import DecodingOptions as JOptions
from whisper_flamingo_tpu.models.dims import MODEL_DIMS as JMODEL_DIMS
from whisper_flamingo_tpu.models.whisper import Whisper as JWhisper
from whisper_flamingo_tpu.serving import ContinuousBatcher as JContinuousBatcher

from whisper_flamingo_tpu_torch import speculative
from whisper_flamingo_tpu_torch.audio import N_SAMPLES, log_mel_spectrogram, pad_or_trim
from whisper_flamingo_tpu_torch.decoding import DecodingOptions, DecodingTask, _features
from whisper_flamingo_tpu_torch.models.dims import MODEL_DIMS
from whisper_flamingo_tpu_torch.serving import BatchTranscriber, ContinuousBatcher

from test_torch_model import port_from_jax

DIMS = MODEL_DIMS["debug"]
EOT = 50257


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    jp, tm = port_from_jax(DIMS, seed=0)
    return JWhisper(dims=JMODEL_DIMS["debug"], params=jp), tm


def _opts(**kw):
    return DecodingOptions(**dict(dict(language="en", without_timestamps=True, sample_len=10,
                                       fp16=False), **kw))


def _waves(seed, n, scale=0.2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(16000 * (i % 3 + 1)).astype(np.float32) * scale
            for i in range(n)]


def _mel(w):
    return log_mel_spectrogram(np.asarray(pad_or_trim(w, N_SAMPLES)), n_mels=80, device="cpu")


def _refs(model, opts, waves):
    task = DecodingTask(model, opts)
    return [task.run(_mel(w)[None])[0] for w in waves]


def test_batch_transcriber_pads_unpads_and_speculates(models):
    _, model = models
    opts = _opts(sample_len=6)
    svc = BatchTranscriber(model, options=opts, batch_sizes=(2, 4))
    waves = _waves(0, 5, 0.05)
    results = svc.transcribe_segments(waves)
    assert len(results) == 5 and all(isinstance(r.text, str) for r in results)
    # another grouping of the same audio, and the verifier as its own draft
    assert svc.transcribe_segments(waves[:1])[0].tokens == results[0].tokens
    spec = BatchTranscriber(model, options=opts, batch_sizes=(4,), draft_model=model,
                            draft_len=2)
    assert [r.tokens for r in spec.transcribe_segments(waves)] == [r.tokens for r in results]
    assert [r.tokens for r in results] == [r.tokens for r in _refs(model, opts, waves)]
    assert isinstance(svc.transcribe_long(np.concatenate(waves * 4)), str)  # 3 windows


def _streaming(cb, waves):
    """Two requests up front, then one more after every poll."""
    arrivals = list(waves)
    ids = [cb.submit(arrivals.pop(0)), cb.submit(arrivals.pop(0))]
    got = {}
    while cb.pending or arrivals:
        got.update(cb.poll())
        if arrivals:
            ids.append(cb.submit(arrivals.pop(0)))
    return [got[i] for i in ids]


CB_CASES = {
    "poll": (dict(slots=3, chunk=4, pipeline=False), {}),
    "poll_pipelined_mels": (dict(slots=3, chunk=4, pipeline=True), dict(mels=True)),
    "poll_streaming": (dict(slots=2, chunk=3), dict(streaming=True)),
    "stop_on_finish": (dict(slots=2, chunk=3, stop_on_finish=True), dict(warmup=True)),
    "drain_chunk": (dict(slots=2, chunk=2, drain_chunk=16), dict(warmup=True)),
    "pooled_caps_lpt": (dict(slots=3), dict(pooled=True, caps=True)),
    "pooled_cap4_arrival": (dict(slots=3), dict(pooled=True, caps=True, pool_cap=4,
                                                 sort_admission=False)),
    "speculative": (dict(slots=2, chunk=6, draft_len=2), dict(draft=True)),
    "pooled_speculative": (dict(slots=2, draft_len=2), dict(draft=True, pooled=True)),
    "int8": (dict(slots=2, chunk=3), dict(quantize="int8", caps=True)),
}


@pytest.mark.parametrize("name", list(CB_CASES))
def test_continuous_batcher_matches_decode(models, name):
    """Every request's tokens equal its own greedy ``decode`` (cut at its
    cap), with 7 requests on 2 or 3 slots so slots refill mid-flight."""
    _, model = models
    cb_kw, how = CB_CASES[name]
    opts = _opts(quantize=how.get("quantize"))
    waves = _waves(5, 7)
    caps = [10, 3, 7, 10, 2, 10, 5] if how.get("caps") else None
    cb = ContinuousBatcher(model, options=opts, draft_model=model if how.get("draft") else None,
                           **cb_kw)
    if how.get("warmup"):
        cb.warmup()
        assert all(r < 0 for r in cb._slot_req), "warmup must not occupy slots"
    reqs = [_mel(w).numpy() if how.get("mels") and i % 2 else w for i, w in enumerate(waves)]
    if how.get("streaming"):
        got = _streaming(cb, reqs)
    elif "sort_admission" in how:
        ids = [cb.submit(w, caps[i]) for i, w in enumerate(reqs)]
        by_id = dict(cb.run_queued(pool_cap=how["pool_cap"], sort_admission=False))
        got = [by_id[i] for i in ids]
    else:
        got = cb.transcribe_segments(reqs, max_tokens=caps, pooled=how.get("pooled", False))
    refs = _refs(model, opts, waves)
    for i, (g, r) in enumerate(zip(got, refs)):
        want = r.tokens[:caps[i]] if caps else r.tokens
        assert g.tokens == want, (name, i)
        assert abs(g.no_speech_prob - r.no_speech_prob) < 1e-6
        if not caps:
            assert abs(g.avg_logprob - r.avg_logprob) < 1e-4


def _snapshot(state):
    return {k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v.clone()
            for k, v in state.items()}


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("loop", ["batcher", "speculative"])
def test_loops_start_from_the_task_setup(models, monkeypatch, loop, quantize):
    """The batcher's slots and speculative decoding start from the task's
    set-up: for the same mels their first tokens, log-probs, no-speech
    probabilities and verifier and draft cache slabs equal a plain task's
    prefill bit for bit, and the batcher steps with its task's decode copy."""
    _, model = models
    opts, K = _opts(quantize=quantize), 2
    mel = torch.stack([_mel(w) for w in _waves(5, 3)])
    ref = DecodingTask(model, opts)
    init = torch.tensor([ref.initial_tokens] * len(mel))
    feats = _features(model, mel, ref.compute_dtype)
    logits, cache_v = ref.prefill(ref.params, feats, init, extra_len=K)
    want = ref.first_tokens(logits, init, ref.max_len + K + 1,
                            torch.full((len(mel),), ref.max_len))
    want.update(cache_v=cache_v, no_speech_probs=ref.no_speech_probs(logits),
                cache_d=ref.prefill(speculative.draft_params(ref, model), feats, init,
                                    extra_len=K)[1])
    if loop == "batcher":
        cb = ContinuousBatcher(model, options=opts, slots=2, draft_model=model, draft_len=K)
        got = cb._prefill([(m.numpy(), None) for m in mel])
        used = []
        cb._round = lambda params_v, params_d, s: used.append((params_v, params_d))
        cb._step(cb._empty_state(2))
        assert used[0][0] is cb._task.params and used[0][1] is cb._params_d
    else:
        seen = []
        make_round = speculative.make_spec_round

        def spying(*args):
            round_fn = make_round(*args)

            def first(params_v, params_d, s):
                if not seen:
                    seen.append(_snapshot(s))
                return round_fn(params_v, params_d, s)
            return first

        monkeypatch.setattr(speculative, "make_spec_round", spying)
        task = speculative.SpeculativeDecodingTask(model, model, opts, draft_len=K)
        results = task.run(mel)
        got = dict(seen[0], no_speech_probs=torch.tensor([r.no_speech_prob for r in results]))
    for key, value in want.items():
        if isinstance(value, dict):
            assert got[key].keys() == value.keys(), key
            for name, slab in value.items():
                assert torch.equal(got[key][name], slab), (key, name)
        else:
            assert torch.equal(got[key], value.to(got[key].dtype)), key


def test_continuous_batcher_per_request_caps(models):
    """With EOT suppressed the length is the cap's."""
    _, model = models
    opts = _opts(sample_len=12, suppress_tokens=f"-1,{EOT}")
    caps = [2, 5, 9, 12]
    got = ContinuousBatcher(model, options=opts, slots=2, chunk=3).transcribe_segments(
        _waves(8, 4), max_tokens=caps)
    assert [len(r.tokens) for r in got] == caps


@pytest.mark.parametrize("pooled", [False, True], ids=["poll", "pooled"])
def test_continuous_batcher_matches_jax(models, pooled):
    jmodel, model = models
    common = dict(language="en", without_timestamps=True, sample_len=10, fp16=False)
    waves = _waves(11, 5)
    caps = [10, 3, 7, 2, 10]
    ref = JContinuousBatcher(jmodel, options=JOptions(**common), slots=2, chunk=3) \
        .transcribe_segments(waves, max_tokens=caps, pooled=pooled)
    got = ContinuousBatcher(model, options=DecodingOptions(**common), slots=2, chunk=3) \
        .transcribe_segments(waves, max_tokens=caps, pooled=pooled)
    for r, g in zip(ref, got):
        assert g.tokens == r.tokens
        assert abs(g.avg_logprob - r.avg_logprob) < 1e-4
        assert abs(g.no_speech_prob - r.no_speech_prob) < 1e-5


def test_continuous_batcher_validation(models):
    jmodel, model = models
    cases = [(dict(language="en", beam_size=2), "greedy-only"),
             (dict(), "language"),
             (dict(language="en", temperature=0.5), "temperature"),
             (dict(language="en", quantize="int8kv"), "int8kv")]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match) as jerr:
            JContinuousBatcher(jmodel, JOptions(**kw))
        with pytest.raises(ValueError, match=match) as terr:
            ContinuousBatcher(model, DecodingOptions(**kw))
        assert str(terr.value) == str(jerr.value)
