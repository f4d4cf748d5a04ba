"""The audio-visual Whisper-Flamingo path against the benchmark's plain
reference (``perfbench/reference/avhubert_ref.py`` with ``whisper_ref``), on
the CPU at a small size, on the benchmark's seeded weights.

The trunk is the ``debug`` one (the published ResNet-18 front end, a 64-wide
transformer), the Whisper a gated one of width 128, so that its
``xt_projection`` (64 -> 128) runs. Tolerances, each the largest
difference over the largest magnitude of the reference:

- fp32 against the fp32 reference: 1e-4. The two sum in other orders
  (attention scaled as q k^T / sqrt(d) in the reference, q and k each by
  d^-1/4 in the port; other convolution algorithms), which gives
  differences of ~1e-6; bf16 rounds at 2^-8 ~ 4e-3 a value, and the tests
  show a bf16 trunk reads above the tolerance;
- the held task against a fresh one: the same tokens, exactly.

And the decode entry's one held task: its step graphs keep one key, with
slabs of one shape, however many video lengths its batches bring.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import weights  # noqa: E402
from perfbench.reference import avhubert_ref, whisper_ref  # noqa: E402

from whisper_flamingo_tpu_torch import decoding, profiling  # noqa: E402
from whisper_flamingo_tpu_torch.decoding import DecodingOptions, DecodingTask  # noqa: E402
from whisper_flamingo_tpu_torch.models import avhubert  # noqa: E402
from whisper_flamingo_tpu_torch.models.dims import ModelDimensions  # noqa: E402
from whisper_flamingo_tpu_torch.models.whisper import (  # noqa: E402
    ModelExtras,
    StepGraphs,
    Whisper,
    decoder_apply,
    encoder_apply,
    init_cache,
)

REL = 1e-4
SEED = 2 ** 31 + 19
DIMS = {"n_mels": 80, "n_audio_ctx": 1500, "n_audio_state": 128, "n_audio_head": 2,
        "n_audio_layer": 2, "n_vocab": 51865, "n_text_ctx": 448, "n_text_head": 2,
        "n_text_state": 128, "n_text_layer": 2}
TRUNK_CFG = avhubert.VIDEO_ENCODER_CONFIGS["debug"]
TRUNK = {"embed_dim": TRUNK_CFG.embed_dim, "n_layers": TRUNK_CFG.n_layers,
         "n_heads": TRUNK_CFG.n_heads, "ffn_dim": TRUNK_CFG.ffn_dim,
         "conv_pos": TRUNK_CFG.conv_pos, "conv_pos_groups": TRUNK_CFG.conv_pos_groups,
         "frontend_dim": TRUNK_CFG.frontend_dim}
EXTRAS = {"add_gated_x_attn": 1, "num_langs": 1, "bert_dim": TRUNK_CFG.embed_dim}
INIT = [50258, 50259, 50359, 50363]
SIDE = 24  # lip crops of 24 x 24: the front end's shapes at a CPU test's cost


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def states():
    spec = weights.whisper_spec(DIMS, EXTRAS, gate_value=1.0)
    return (weights.make_state(spec, SEED, "cpu"),
            weights.make_state(avhubert_ref.trunk_spec(TRUNK), SEED, "cpu", 2))


@pytest.fixture(scope="module")
def av(states):
    wsd, tsd = states
    whisper = Whisper(ModelDimensions(**DIMS), ModelExtras(**EXTRAS))
    whisper.load_state_dict(wsd, strict=True)
    trunk = avhubert.VideoEncoder(TRUNK_CFG)
    missing, unexpected = trunk.load_state_dict(tsd, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return avhubert.AVWhisper(whisper=whisper.eval(), video=trunk.eval())


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def _video(seed, b, t):
    gen = torch.Generator().manual_seed(seed)
    pixels = torch.randint(0, 256, (b, t, SIDE, SIDE), generator=gen)
    return (pixels.float() / 255.0 - 0.421) / 0.165


def _mel(seed, b):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((b, 80, 3000), generator=gen) * 0.5


def test_trunk_features_match_the_reference(av, states):
    video = _video(1, 2, 7)
    with torch.no_grad():
        got = avhubert.avhubert_encoder_apply(av.video, TRUNK_CFG, video=video)
        low = avhubert.avhubert_encoder_apply(av.video, TRUNK_CFG, video=video,
                                              dtype=torch.bfloat16)
        ref = avhubert_ref.trunk(states[1], TRUNK, video)
    assert got.shape == ref.shape == (2, 7, TRUNK_CFG.embed_dim)
    assert _rel(got, ref) < REL
    assert _rel(low.float(), ref) > REL  # bf16 in place of fp32 fails the tolerance


def test_full_forward_logits_match_the_reference(av, states):
    wsd, tsd = states
    mel, video = _mel(2, 2), _video(3, 2, 9)
    tokens = torch.tensor([INIT + [440, 1002, 7, 31], INIT + [9, 80, 2048, 5]])
    with torch.no_grad():
        feats = encoder_apply(av.whisper, av.dims, mel)
        vf = avhubert.avhubert_encoder_apply(av.video, TRUNK_CFG, video=video)
        got = decoder_apply(av.whisper, av.dims, tokens, feats, xt=vf[None])[0]
        ref_vf = avhubert_ref.trunk(tsd, TRUNK, video)
        ref = whisper_ref.decoder_logits(wsd, DIMS, tokens, whisper_ref.encoder(wsd, DIMS, mel),
                                         whisper_ref.prepare_streams(wsd, ref_vf[None]))
    assert "decoder.xt_projection.weight" in wsd
    assert _rel(got, ref) < REL


def test_cached_steps_through_the_holder_match_the_full_forward(av, states):
    """Prefill, then every later token one at a time through the step
    holder (its segments run eagerly), the gated slabs held at the stream
    cap and masked past the video's frames: each step's logits are the
    reference's full forward at that position."""
    wsd, tsd = states
    mel, video = _mel(4, 2), _video(5, 2, 6)
    seq = torch.tensor([INIT + [440, 1002, 7, 31, 12, 900, 3], INIT + [9, 80, 2048, 5, 6, 7, 8]])
    holder = StepGraphs(capture=False)
    with torch.no_grad():
        feats = encoder_apply(av.whisper, av.dims, mel)
        vf = avhubert.avhubert_encoder_apply(av.video, TRUNK_CFG, video=video)
        cache = init_cache(av.whisper, av.dims, feats, xt=vf[None], max_len=seq.shape[1],
                           xt_at_ctx=True)
        assert cache["xt_k"].shape[-2] == DIMS["n_text_ctx"]
        n = len(INIT)
        steps = [decoder_apply(av.whisper, av.dims, seq[:, :n], cache=cache, offset=0)[0]]
        for t in range(n, seq.shape[1]):
            steps.append(decoder_apply(av.whisper, av.dims, seq[:, t: t + 1], cache=cache,
                                       offset=t, step_graphs=holder)[0].clone())
        got = torch.cat(steps, dim=1)
        ref = whisper_ref.decoder_logits(
            wsd, DIMS, seq, whisper_ref.encoder(wsd, DIMS, mel),
            whisper_ref.prepare_streams(wsd, avhubert_ref.trunk(tsd, TRUNK, video)[None]))
    assert len(holder._built) == 1  # the later steps went through the segments
    assert _rel(got, ref) < REL


def _options():
    return DecodingOptions(language="en", without_timestamps=True, beam_size=3, sample_len=5,
                           fp16=False, suppress_tokens=[50257])


def _segmented(av):
    task = av.task(_options())
    if not isinstance(task.step_graphs, StepGraphs) or task.step_graphs.capture:
        task.step_graphs = StepGraphs(capture=False)
    return task


def test_held_task_gives_a_fresh_tasks_tokens_over_video_lengths(av):
    """Batches whose videos differ in length through the one held task
    (its step graphs engaged) give the tokens a fresh ``AVWhisper`` gives
    each batch, and those of the per-batch ``decode`` path, which holds the
    slabs at each video's own length."""
    av._tasks.clear()
    task = _segmented(av)
    for i, frames in enumerate((4, 9, 6)):
        mel, video = _mel(10 + i, 2), _video(20 + i, 2, frames)
        held = av.decode(mel, _options(), video=video)
        fresh_av = avhubert.AVWhisper(whisper=av.whisper, video=av.video)
        _segmented(fresh_av)
        fresh = fresh_av.decode(mel, _options(), video=video)
        vf = avhubert.avhubert_encoder_apply(av.video, TRUNK_CFG, video=video)
        plain = decoding.decode(av.whisper, mel, _options(), xt=vf[None])
        assert [r.tokens for r in held] == [r.tokens for r in fresh] == [r.tokens for r in plain]
        assert [r.avg_logprob for r in held] == [r.avg_logprob for r in fresh]
        np.testing.assert_allclose([r.avg_logprob for r in held],
                                   [r.avg_logprob for r in plain], rtol=1e-5)
    assert av.task(_options()) is task
    assert len(task.step_graphs._built) == 1


def test_holder_stays_bounded_over_twelve_video_lengths(av):
    av._tasks.clear()
    task = _segmented(av)
    lengths = list(range(3, 15))
    with profiling.collect() as sink:
        for i, frames in enumerate(lengths):
            av.decode(_mel(40 + i, 2), _options(), video=_video(60 + i, 2, frames),
                      video_lengths=[frames, frames - 1])
    (built,) = task.step_graphs._built.values()
    assert built.slabs["xt_k"].shape[-2] == DIMS["n_text_ctx"]
    assert built.slabs["xt_mask"].shape == (2, 1, 1, DIMS["n_text_ctx"])
    assert sink.counters["decode.graph_captures"] == 1
    assert sink.counters["av.frames"] == sum(2 * n - 1 for n in lengths)
    assert sink.counters["av.pad_frames"] == len(lengths)
    assert len(av._tasks) == 1


def test_other_options_replace_the_held_task(av):
    av._tasks.clear()
    first = av.task(_options())
    assert av.task(_options()) is first
    other = av.task(DecodingOptions(language="en", without_timestamps=True, sample_len=5,
                                    fp16=False))
    assert other is not first and len(av._tasks) == 1
    assert other.streams_at_ctx


def test_masked_capacity_gives_the_stream_lengths_attention(av):
    """One cached forward over slabs held at the cap equals one over slabs
    at the stream's own length, to fp32 rounding."""
    mel, video = _mel(7, 2), _video(8, 2, 5)
    toks = torch.tensor([INIT, INIT])
    with torch.no_grad():
        feats = encoder_apply(av.whisper, av.dims, mel)
        vf = avhubert.avhubert_encoder_apply(av.video, TRUNK_CFG, video=video)[None]
        outs = []
        for at_ctx in (False, True):
            cache = init_cache(av.whisper, av.dims, feats, xt=vf, max_len=8, xt_at_ctx=at_ctx)
            outs.append(decoder_apply(av.whisper, av.dims, toks, cache=cache, offset=0)[0])
    assert "xt_mask" not in init_cache(av.whisper, av.dims, feats, xt=vf, max_len=8)
    assert _rel(outs[1], outs[0]) < 1e-6
    too_long = vf[:, :, :1].expand(-1, -1, DIMS["n_text_ctx"] + 1, -1)
    with pytest.raises(ValueError, match="exceeds n_text_ctx"):
        init_cache(av.whisper, av.dims, feats, xt=too_long, max_len=8, xt_at_ctx=True)
