"""The decode loop's step-graph holder (``models.whisper.StepGraphs``) on the
CPU, with capture off: the same segments as on the card run eagerly over
the holder's static buffers (token, offset, slabs, attention outputs), so
every forward after a key's warm-up goes through the segmented step. Held
bit for bit against the unsegmented ``decoder_apply``, step by step, for
greedy and beam, a plain and a gated model, across batches whose slabs
differ; and the cases the holder must leave to the unsegmented step."""

import copy
import types

import numpy as np
import pytest
import torch

from whisper_flamingo_tpu_torch import decoding, profiling, serving
from whisper_flamingo_tpu_torch.decoding import DecodingOptions, DecodingTask
from whisper_flamingo_tpu_torch.models.dims import MODEL_DIMS
from whisper_flamingo_tpu_torch.models.whisper import ModelExtras, StepGraphs, init_params
from whisper_flamingo_tpu_torch.serving import ContinuousBatcher

DIMS = MODEL_DIMS["debug"]
BERT_DIM = 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    plain = init_params(torch.Generator().manual_seed(0), DIMS, device="cpu")
    gated = init_params(torch.Generator().manual_seed(1), DIMS,
                        ModelExtras(add_gated_x_attn=1, num_langs=1, bert_dim=BERT_DIM),
                        device="cpu")
    with torch.no_grad():  # open the gates: a zero gate would hide the streams
        for blk in gated.decoder.blocks:
            blk.ff_gate.fill_(0.5)
            for sub in blk.gated_x_attn_layers:
                sub.attn_gate.fill_(0.5)
    return {"plain": plain, "gated": gated}


def _inputs(seed, n=2, stream_len=6, gated=True):
    rng = np.random.default_rng(seed)
    mel = torch.from_numpy(rng.standard_normal((n, 80, 3000)).astype(np.float32) * 0.5)
    xt = None
    if gated:
        xt = torch.from_numpy(rng.standard_normal((1, n, stream_len, BERT_DIM))
                              .astype(np.float32))
    return mel, xt


def _options(beam, fp16=False, quantize=None, sample_len=8):
    return DecodingOptions(language="en", without_timestamps=True, sample_len=sample_len,
                           fp16=fp16, beam_size=beam, quantize=quantize)


def _loop(task, mel, xt, monkeypatch):
    """``_main_loop`` on ``mel``: its outputs, and the logits of every
    incremental forward, copied as they come."""
    steps = []
    apply = decoding.decoder_apply

    def recording(params, dims, tokens, *args, **kwargs):
        out = apply(params, dims, tokens, *args, **kwargs)
        if kwargs.get("cache") is not None and tokens.shape[-1] == 1:
            steps.append(out[0].clone())
        return out

    feats = decoding._features(task.model, mel, task.compute_dtype)
    init = torch.tensor([task.initial_tokens] * mel.shape[0])
    with monkeypatch.context() as m:
        m.setattr(decoding, "decoder_apply", recording)
        out = task._main_loop(feats, init, xt)
    return out, steps


def _same(a, b):
    (out_a, steps_a), (out_b, steps_b) = a, b
    assert out_a.keys() == out_b.keys()
    for k in out_a:
        assert torch.equal(out_a[k], out_b[k]), k
    assert len(steps_a) == len(steps_b) > 0
    for i, (x, y) in enumerate(zip(steps_a, steps_b)):
        assert torch.equal(x, y), f"step {i}"


def _segmented(model, options):
    task = DecodingTask(model, options)
    task.step_graphs = StepGraphs(capture=False)
    return task


@pytest.mark.parametrize("kind,beam,fp16,quantize", [
    ("plain", None, False, None),
    ("plain", 5, False, None),
    ("gated", None, False, None),
    ("gated", 5, False, None),
    ("gated", 5, True, None),
    ("plain", 5, False, "int8"),
], ids=["plain-greedy", "plain-beam5", "gated-greedy", "gated-beam5", "gated-beam5-bf16",
        "plain-beam5-int8"])
def test_segmented_step_bit_equal_to_unsegmented(models, monkeypatch, kind, beam, fp16, quantize):
    model = models[kind]
    mel, xt = _inputs(0, gated=kind == "gated")
    opts = _options(beam, fp16, quantize)
    eager = _loop(DecodingTask(model, opts), mel, xt, monkeypatch)
    task = _segmented(model, opts)
    with profiling.collect() as sink:
        got = _loop(task, mel, xt, monkeypatch)
    _same(got, eager)
    forwards = len(got[1])
    assert forwards > StepGraphs.WARMUP + 1
    assert sink.counters["decode.graph_captures"] == 1
    assert sink.counters["decode.eager_steps"] == StepGraphs.WARMUP
    assert sink.counters["decode.graph_steps"] == forwards - StepGraphs.WARMUP
    (capture,) = [s for s in sink.spans if s.name == "decode.capture"]
    assert capture.parent in {s.id for s in sink.spans if s.name == "decode.forward"}
    assert len(task.step_graphs._built) == 1


@pytest.mark.parametrize("kind", ["plain", "gated"])
def test_second_batch_refills_the_slabs(models, monkeypatch, kind):
    """One holder over two batches of other audio and streams at one key:
    the second batch's slabs are copied into the holder's and its steps
    equal the unsegmented step's; nothing is captured again."""
    model = models[kind]
    gated = kind == "gated"
    opts = _options(5)
    task = _segmented(model, opts)
    with profiling.collect() as sink:
        for seed in (0, 1):
            mel, xt = _inputs(seed, gated=gated)
            _same(_loop(task, mel, xt, monkeypatch),
                  _loop(DecodingTask(model, opts), mel, xt, monkeypatch))
    assert sink.counters["decode.graph_captures"] == 1
    assert len(task.step_graphs._built) == 1
    (built,) = task.step_graphs._built.values()
    mel, xt = _inputs(1, gated=gated)
    cache = decoding.init_cache(task.params, DIMS, decoding._features(model, mel, torch.float32),
                                xt=xt, max_len=task.max_len)
    for name, slab in built.slabs.items():  # holds the last batch's values
        assert torch.equal(slab, cache[name]), name


def test_new_stream_length_makes_a_new_key(models, monkeypatch):
    model = models["gated"]
    opts = _options(None)
    task = _segmented(model, opts)
    with profiling.collect() as sink:
        for length in (6, 9, 6):
            mel, xt = _inputs(2, stream_len=length)
            _same(_loop(task, mel, xt, monkeypatch),
                  _loop(DecodingTask(model, opts), mel, xt, monkeypatch))
    assert sink.counters["decode.graph_captures"] == 2
    lengths = sorted(b.slabs["xt_k"].shape[-2] for b in task.step_graphs._built.values())
    assert lengths == [6, 9]


def test_decode_shorter_than_the_warmup_builds_no_key(models, monkeypatch):
    model = models["plain"]
    opts = _options(5, sample_len=StepGraphs.WARMUP + 1)
    mel, _ = _inputs(3, gated=False)
    task = _segmented(model, opts)
    with profiling.collect() as sink:
        got = _loop(task, mel, None, monkeypatch)
    _same(got, _loop(DecodingTask(model, opts), mel, None, monkeypatch))
    assert len(got[1]) == StepGraphs.WARMUP
    assert not task.step_graphs._built
    assert sink.counters["decode.eager_steps"] == StepGraphs.WARMUP
    assert "decode.graph_steps" not in sink.counters
    assert "decode.graph_captures" not in sink.counters


def _split(model):
    """A copy whose decoder MLPs carry a mesh, as ``shard_params`` marks a
    split module; one model rank, so its collectives are the identity."""
    model = copy.deepcopy(model)
    for blk in model.decoder.blocks:
        blk.mlp.tp = types.SimpleNamespace(n_model=1)
    return model


@pytest.mark.parametrize("case", ["int8kv", "tp_split"])
def test_holder_declines_int8kv_and_a_split_decoder(models, monkeypatch, case):
    model = models["plain"]
    if case == "tp_split":
        model, opts = _split(model), _options(5)
    else:
        opts = _options(5, quantize="int8kv")
    mel, _ = _inputs(4, gated=False)
    task = _segmented(model, opts)
    with profiling.collect() as sink:
        got = _loop(task, mel, None, monkeypatch)
    _same(got, _loop(DecodingTask(model, opts), mel, None, monkeypatch))
    assert not task.step_graphs._built and not task.step_graphs._seen
    assert sink.counters["decode.eager_steps"] == len(got[1])
    assert "decode.graph_steps" not in sink.counters


def test_continuous_batcher_step_takes_no_holder(models, monkeypatch):
    calls = []
    apply = serving.decoder_apply

    def recording(*args, **kwargs):
        calls.append(kwargs.get("step_graphs"))
        return apply(*args, **kwargs)

    monkeypatch.setattr(serving, "decoder_apply", recording)
    cb = ContinuousBatcher(models["plain"], _options(None), slots=2, chunk=2)
    rng = np.random.default_rng(5)
    with profiling.collect() as sink:
        for n in (1, 2, 3):
            cb.submit(rng.standard_normal(16000 * n).astype(np.float32) * 0.2, max_tokens=4)
        while cb.pending:
            cb.poll()
    assert calls and all(c is None for c in calls)
    assert not any(k.startswith("decode.") for k in sink.counters)
