"""The port's span and counter recorder (``profiling.collect`` / ``span`` /
``record`` / ``count`` / ``stamp``) on the CPU: free with no sink installed,
parents per thread, one clock with ``torch.profiler``, and the spans the
decode loop, the continuous batcher and the train step open, with outputs
bit-equal with spans on and off."""

import copy
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from whisper_flamingo_tpu_torch import decoding, profiling
from whisper_flamingo_tpu_torch.decoding import DecodingOptions, DecodingTask
from whisper_flamingo_tpu_torch.models.dims import MODEL_DIMS
from whisper_flamingo_tpu_torch.models.whisper import init_params
from whisper_flamingo_tpu_torch.serving import ContinuousBatcher
from whisper_flamingo_tpu_torch.training import optim, steps

DIMS = MODEL_DIMS["debug"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    return init_params(torch.Generator().manual_seed(0), DIMS, device="cpu")


def _named(sink, name):
    return [s for s in sink.spans if s.name == name]


def _no_clock(monkeypatch):
    def refuse():
        raise AssertionError("the clock was read with no sink installed")

    monkeypatch.setattr(time, "time_ns", refuse)


def test_no_sink_shares_one_noop_and_reads_no_clock(monkeypatch):
    assert profiling._sink is None
    _no_clock(monkeypatch)
    first = profiling.span("decode.step")
    assert profiling.span("serve.queued", rid=3) is first
    with first as entered:
        assert entered is None
        with profiling.span("inner"):
            pass
    profiling.record("serve.queued", 1, 2, rid=0)
    profiling.count("serve.tokens", 5)
    assert profiling.stamp() is None


def test_no_sink_allocates_nothing():
    def hot(n):
        for i in range(n):
            with profiling.span("decode.step"):
                profiling.count("serve.slot_steps", 16)
            profiling.record("serve.queued", i, i + 1, rid=i)
            profiling.stamp()

    hot(10)  # warm any lazily made objects outside the measurement
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        hot(1000)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, profiling.__file__)]
    grown = after.filter_traces(only).compare_to(before.filter_traces(only), "lineno")
    assert not [d for d in grown if d.size_diff > 0 or d.count_diff > 0]


def test_parents_nest_per_thread_and_counters_add():
    def other():
        with profiling.span("other.outer"):
            with profiling.span("other.inner"):
                pass

    with profiling.collect() as sink:
        with profiling.span("main.outer", rid=7):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            with profiling.span("main.inner"):
                profiling.count("c")
                profiling.count("c", 4)
        profiling.record("serve.queued", 10, 20, rid=5)
        assert profiling.stamp() is not None
    assert profiling._sink is None and profiling.span("x") is profiling.span("y")
    by = {s.name: s for s in sink.spans}
    assert set(by) == {"main.outer", "main.inner", "other.outer", "other.inner",
                       "serve.queued"}
    assert by["main.outer"].parent is None and by["main.outer"].rid == 7
    assert by["main.inner"].parent == by["main.outer"].id
    # the other thread's outermost span has no parent, though main.outer was open
    assert by["other.outer"].parent is None
    assert by["other.inner"].parent == by["other.outer"].id
    assert by["other.outer"].thread != by["main.outer"].thread
    q = by["serve.queued"]
    assert (q.start_ns, q.end_ns, q.rid, q.parent) == (10, 20, 5, None)
    assert sink.counters["c"] == 5
    for s in sink.spans:
        assert s.start_ns <= s.end_ns
    outer, inner = by["main.outer"], by["main.inner"]
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert len({s.id for s in sink.spans}) == len(sink.spans)


def test_collect_restores_the_sink_after_an_error():
    with pytest.raises(ValueError):
        with profiling.collect():
            with profiling.span("raises"):
                raise ValueError("inside")
    assert profiling._sink is None


def test_spans_share_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.collect() as sink:
            with profiling.span("outer"):
                with record_function("inside_the_span"):
                    torch.ones(64).add_(1)
    (outer,) = _named(sink, "outer")
    marks = [e for e in prof.profiler.kineto_results.events() if e.name() == "inside_the_span"]
    assert marks
    for e in marks:
        assert outer.start_ns <= e.start_ns() <= e.end_ns() <= outer.end_ns


# -- the decode loop ------------------------------------------------------------------


def _decode(model, mel, **kw):
    opts = DecodingOptions(language="en", without_timestamps=True, sample_len=8, fp16=False,
                           **kw)
    res = DecodingTask(model, opts).run(mel)
    return [(list(r.tokens), r.avg_logprob, r.no_speech_prob) for r in res]


@pytest.mark.parametrize("kw", [{}, {"beam_size": 5}], ids=["greedy", "beam5"])
def test_decode_bit_equal_and_its_spans(model, kw, monkeypatch):
    mel = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 80, 3000))
                           .astype(np.float32) * 0.5)
    off = _decode(model, mel, **kw)
    iters = []
    filters = decoding._apply_filters

    def counted(*a):
        iters.append(1)
        return filters(*a)

    monkeypatch.setattr(decoding, "_apply_filters", counted)
    with profiling.collect() as sink:
        on = _decode(model, mel, **kw)
    assert on == off
    step = _named(sink, "decode.step")
    assert len(step) == len(iters) > 1
    ids = {s.id for s in step}
    for child in ("decode.forward", "decode.sync"):
        kids = _named(sink, child)
        assert kids and all(k.parent in ids for k in kids)
        assert len({k.parent for k in kids}) == len(kids)  # at most one per step
    # every step but the last runs the decoder; a forward follows its step's sync
    assert len(_named(sink, "decode.forward")) == len(step) - 1
    sync = {k.parent: k for k in _named(sink, "decode.sync")}
    for f in _named(sink, "decode.forward"):
        assert sync[f.parent].end_ns <= f.start_ns
    # on the CPU the step-graph holder leaves every forward to the eager step
    assert sink.counters["decode.eager_steps"] == len(_named(sink, "decode.forward"))
    assert sink.counters["decode.graph_steps"] == sink.counters["decode.graph_captures"] == 0
    assert not _named(sink, "decode.capture")


# -- the continuous batcher ---------------------------------------------------------------


def _batcher(model, **kw):
    return ContinuousBatcher(model, DecodingOptions(language="en", without_timestamps=True,
                                                    sample_len=8, fp16=False),
                             slots=2, chunk=2, **kw)


def _serve(model, waves, budgets, **kw):
    cb = _batcher(model, **kw)
    ids = [cb.submit(w, max_tokens=b) for w, b in zip(waves, budgets)]
    out = {}
    while cb.pending:
        out.update(cb.poll())
    return cb, {ids.index(rid): (list(r.tokens), r.avg_logprob) for rid, r in out.items()}, ids


def _waves(n):
    rng = np.random.default_rng(2)
    return [rng.standard_normal(16000 * (i + 1)).astype(np.float32) * 0.2 for i in range(n)]


def test_batcher_bit_equal_and_its_spans(model):
    waves = _waves(4)
    budgets = [3, 6, 2, 5]
    _, off, _ = _serve(model, waves, budgets)
    with profiling.collect() as sink:
        cb, on, ids = _serve(model, waves, budgets)
    assert on == off and len(on) == 4
    for name in ("serve.queued", "serve.in_slot"):
        got = _named(sink, name)
        assert sorted(s.rid for s in got) == sorted(ids), name
    queued = {s.rid: s for s in _named(sink, "serve.queued")}
    for s in _named(sink, "serve.in_slot"):
        assert queued[s.rid].end_ns == s.start_ns <= s.end_ns  # admitted, then in its slot
    assert sink.counters["serve.tokens"] == sum(len(t) for t, _ in on.values())
    assert sink.counters["serve.slot_steps"] == cb.slots * len(_named(sink, "serve.step"))
    polls = {s.id: s for s in _named(sink, "serve.poll")}
    assert polls and _named(sink, "serve.admit")
    for s in _named(sink, "serve.admit"):
        assert s.parent in polls
    assert not cb._submitted and not cb._admitted


def test_speculative_slot_steps_count_a_rounds_tokens(model):
    """With a draft model a step is a round that gives a slot up to
    ``draft_len + 1`` tokens: the slot-steps count them all, so the served
    tokens stay within them."""
    waves, budgets = _waves(3), [6, 2, 5]
    _, off, _ = _serve(model, waves, budgets, draft_model=model, draft_len=2)
    with profiling.collect() as sink:
        cb, on, _ = _serve(model, waves, budgets, draft_model=model, draft_len=2)
    assert on == off
    rounds = len(_named(sink, "serve.step"))
    assert sink.counters["serve.slot_steps"] == cb.slots * 3 * rounds
    assert 0 < sink.counters["serve.tokens"] <= sink.counters["serve.slot_steps"]


def test_run_queued_and_warmup_leave_no_stamps_or_slot_steps(model):
    """``run_queued`` drains the queue with no harvest, so it keeps no
    submit stamp and counts no slot-step; ``warmup``'s scratch step counts
    none either."""
    waves, budgets = _waves(3), [3, 6, 2]
    cb = _batcher(model)
    ids = [cb.submit(w, max_tokens=b) for w, b in zip(waves, budgets)]
    off = {rid: list(r.tokens) for rid, r in cb.run_queued()}
    with profiling.collect() as sink:
        cb = _batcher(model)
        cb.warmup()
        assert [cb.submit(w, max_tokens=b) for w, b in zip(waves, budgets)] == ids
        on = {rid: list(r.tokens) for rid, r in cb.run_queued()}
    assert on == off
    assert not cb._submitted and not cb._admitted
    assert _named(sink, "serve.step") and "serve.slot_steps" not in sink.counters
    assert "serve.tokens" not in sink.counters


# -- the train step ------------------------------------------------------------------------


def _ce_step(model):
    rng = np.random.default_rng(3)
    dec = rng.integers(0, 1000, size=(2, 8)).astype(np.int32)
    labels = np.roll(dec, -1, axis=1)
    labels[:, -1] = 50257
    batch = {"input_ids": rng.standard_normal((2, 80, 100)).astype(np.float32),
             "dec_input_ids": dec, "labels": labels}
    tx, _ = optim.whisper_optimizer(model, 1e-3)
    step = steps.make_ce_train_step(DIMS, dtype=torch.float32, remat=False)
    state, m = step(steps.TrainState.create(model, tx), batch)
    return float(m["loss"]), {k: v.detach().clone() for k, v in state.model.state_dict().items()}


def test_train_step_bit_equal_and_its_spans(model):
    loss_off, params_off = _ce_step(copy.deepcopy(model))
    with profiling.collect() as sink:
        loss_on, params_on = _ce_step(copy.deepcopy(model))
    assert loss_on == loss_off
    assert params_on.keys() == params_off.keys()
    assert all(torch.equal(params_on[k], params_off[k]) for k in params_on)
    (step,) = _named(sink, "train.step")
    (fwd,) = _named(sink, "train.forward")
    (bwd,) = _named(sink, "train.backward")
    assert fwd.parent == step.id and bwd.parent == step.id
    assert step.start_ns <= fwd.start_ns <= fwd.end_ns <= bwd.start_ns <= bwd.end_ns <= step.end_ns


@pytest.fixture(scope="module")
def av_model():
    from whisper_flamingo_tpu_torch.models import avhubert
    from whisper_flamingo_tpu_torch.models.whisper import ModelExtras

    cfg = avhubert.VIDEO_ENCODER_CONFIGS["debug"]
    whisper = init_params(torch.Generator().manual_seed(3), DIMS,
                          ModelExtras(add_gated_x_attn=1, num_langs=1, bert_dim=cfg.embed_dim),
                          device="cpu")
    trunk = avhubert.init_video_encoder(torch.Generator().manual_seed(4), cfg, device="cpu")
    return avhubert.AVWhisper(whisper=whisper, video=trunk)


def _lip_video(seed, b, t):
    return torch.randn((b, t, 16, 16), generator=torch.Generator().manual_seed(seed))


def test_av_trunk_spans_nest_and_frames_add_up(av_model):
    from whisper_flamingo_tpu_torch.models import avhubert

    with profiling.collect() as sink:
        avhubert.avhubert_encoder_apply(av_model.video, av_model.video_cfg,
                                        video=_lip_video(0, 3, 7), lengths=[7, 5, 2])
        avhubert.avhubert_encoder_apply(av_model.video, av_model.video_cfg,
                                        video=_lip_video(1, 2, 4))
    trunks = _named(sink, "av.trunk")
    assert len(trunks) == 2
    for name in ("av.frontend", "av.transformer"):
        inner = _named(sink, name)
        assert [s.parent for s in inner] == [t.id for t in trunks]
        for s, t in zip(inner, trunks):
            assert t.start_ns <= s.start_ns <= s.end_ns <= t.end_ns
    assert sink.counters["av.frames"] == 7 + 5 + 2 + 2 * 4
    assert sink.counters["av.frames"] + sink.counters["av.pad_frames"] == 3 * 7 + 2 * 4


def test_av_graph_captures_stop_once_the_lengths_are_seen(av_model):
    from whisper_flamingo_tpu_torch.models.whisper import StepGraphs

    opts = DecodingOptions(language="en", without_timestamps=True, beam_size=2, sample_len=5,
                           fp16=False)
    av_model._tasks.clear()
    av_model.task(opts).step_graphs = StepGraphs(capture=False)
    mel = torch.randn((2, 80, 3000), generator=torch.Generator().manual_seed(5)) * 0.5
    captures = []
    with profiling.collect() as sink:
        for _ in range(2):
            for frames in (3, 8, 5):
                av_model.decode(mel, opts, video=_lip_video(frames, 2, frames))
            captures.append(sink.counters["decode.graph_captures"])
    assert captures == [1, 1]  # one key for every length, none after the first pass
    assert sink.counters["decode.graph_steps"] > 0
    assert "decode.graph_evictions" not in sink.counters
