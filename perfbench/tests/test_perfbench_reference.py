"""The plain reference against the port at the debug widths, in float32 on
the CPU, on the same seeded weights and inputs: the mel, the BERT stream,
the encoder, the gated decoder (teacher-forced and through the cache) and
one AdamW step. So the ``correct`` check is trusted before a chip run."""

import numpy as np
import pytest
import torch

from perfbench.drivers import common
from perfbench.reference import bert_ref, mel_ref, train_ref, whisper_ref

from .conftest import small_config

SEED = 2 ** 31 + 12345


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def flamingo():
    cfg = small_config("flamingo-small-text")
    model = common.build_whisper(cfg, SEED, "cpu")
    return cfg, model, common.whisper_state(cfg, SEED, "cpu")


def test_mel():
    from whisper_flamingo_tpu_torch.audio import log_mel_spectrogram

    audio = torch.randn(2, 16000 * 7 + 80, generator=torch.Generator().manual_seed(1)) * 0.05
    got = log_mel_spectrogram(audio, device="cpu")
    ref = mel_ref.log_mel(audio)
    assert got.shape == ref.shape
    assert _rel(got, ref) < 1e-5


def test_bert_stream():
    cfg = small_config("flamingo-small-text")
    cond = common.build_conditioner(cfg, SEED, "cpu")
    rng = np.random.default_rng(3)
    texts = [common.texts_of_lengths(rng, [32, 77, 128, 40])]
    got = cond.encode_multi(texts)
    sd = common.bert_state(cfg, SEED, "cpu")
    ref = bert_ref.encode_streams(sd, cfg["bert"], texts, cfg["bert_max_length"],
                                  cfg["bert_pad_multiple"], "cpu")
    assert got.shape == ref.shape == (1, 4, 128, cfg["bert"]["hidden_size"])
    assert _rel(got, ref) < 1e-5


def test_encoder_and_gated_decoder(flamingo):
    from whisper_flamingo_tpu_torch.models.whisper import decoder_apply, encoder_apply

    cfg, model, sd = flamingo
    dims = cfg["dims"]
    gen = torch.Generator().manual_seed(5)
    mel = torch.randn(2, 80, 3000, generator=gen)
    xt = torch.randn(1, 2, 32, cfg["extras"]["bert_dim"], generator=gen)
    tokens = torch.randint(0, 50000, (2, 20), generator=gen)
    with torch.no_grad():
        feats = encoder_apply(model, model.dims, mel)
        ref_feats = whisper_ref.encoder(sd, dims, mel)
        assert _rel(feats, ref_feats) < 1e-4
        got = decoder_apply(model, model.dims, tokens, feats, xt=xt)[0]
        ref = whisper_ref.decoder_logits(sd, dims, tokens, ref_feats,
                                         whisper_ref.prepare_streams(sd, xt))
    assert _rel(got, ref) < 1e-4


def test_gated_decode_through_the_cache(flamingo):
    """fp32 greedy tokens of ``DecodingTask`` (prefill, then the cached
    steps) equal the reference's greedy choice at every position."""
    from whisper_flamingo_tpu_torch.decoding import DecodingOptions, DecodingTask

    cfg, model, sd = flamingo
    tok = cfg["tokens"]
    gen = torch.Generator().manual_seed(9)
    mel = torch.randn(2, 80, 3000, generator=gen)
    xt = torch.randn(1, 2, 16, cfg["extras"]["bert_dim"], generator=gen)
    opts = DecodingOptions(language="en", without_timestamps=True, sample_len=12, fp16=False,
                           suppress_tokens=tok["always_suppressed"])
    res = DecodingTask(model, opts).run(mel, xt=xt)
    init = list(tok["sot_sequence_notimestamps"])
    with torch.no_grad():
        feats = whisper_ref.encoder(sd, cfg["dims"], mel)
        streams = whisper_ref.prepare_streams(sd, xt)
        for r, out in enumerate(res):
            assert len(out.tokens) == 12
            seq = torch.tensor([init + out.tokens[:-1]])
            logits = whisper_ref.decoder_logits(sd, cfg["dims"], seq, feats[r: r + 1],
                                                streams[:, r: r + 1])[:, len(init) - 1:]
            lp = whisper_ref.filtered_logprobs(logits, tok["always_suppressed"], tok["blank"], 0)
            assert lp[0].argmax(-1).tolist() == out.tokens
            assert lp[0].gather(1, torch.tensor(out.tokens)[:, None]).sum().item() == \
                pytest.approx(out.avg_logprob * 13, abs=1e-3)


def test_one_adamw_step():
    from whisper_flamingo_tpu_torch.models.dims import ModelDimensions
    from whisper_flamingo_tpu_torch.training.optim import whisper_optimizer
    from whisper_flamingo_tpu_torch.training.steps import TrainState, make_ce_train_step

    cfg = small_config("whisper-large-v2")
    tr = dict(cfg["train"], warmup_steps=0, learning_rate=1e-3)
    model = common.build_whisper(cfg, SEED, "cpu")
    sd = common.whisper_state(cfg, SEED, "cpu")
    tx, _ = whisper_optimizer(model, tr["learning_rate"], weight_decay=tr["weight_decay"],
                              adam_epsilon=tr["adam_epsilon"], warmup_steps=0,
                              total_steps=tr["num_train_steps"])
    state = TrainState.create(model, tx)
    step = make_ce_train_step(ModelDimensions(**cfg["dims"]), dtype=torch.float32, remat=False)
    gen = torch.Generator().manual_seed(11)
    mel = torch.randn(2, 80, 400, generator=gen)
    dec = torch.randint(0, 50000, (2, 16), generator=gen)
    labels = torch.cat([dec[:, 1:], torch.full((2, 1), -100)], 1)
    state, metrics = step(state, {"input_ids": mel, "dec_input_ids": dec, "labels": labels})
    got_grad = {n: float(m.double().norm()) / (1 - tx.b1) for n, m in zip(tx.names, tx.mu)}
    got_change = {n: float((p.detach() - sd[n]).double().norm())
                  for n, p in model.named_parameters()}
    batch = {"mel": mel, "frames": torch.tensor([400, 400]),
             "draws": torch.zeros((2, 0, 3), dtype=torch.int64), "n_freq_mask": 0,
             "dec_input_ids": dec, "labels": labels}
    ref = train_ref.train_steps(sd, cfg["dims"], [batch], tr)
    assert float(metrics["loss"]) == pytest.approx(ref["losses"][0], rel=1e-5)
    for name, value in ref["first_grad"].items():
        assert got_grad[name] == pytest.approx(value, rel=1e-3, abs=1e-9), name
    for name, value in ref["change"].items():
        assert got_change[name] == pytest.approx(value, rel=1e-3, abs=1e-9), name


def test_spec_augment_masks_agree():
    from whisper_flamingo_tpu_torch.ops.spec_augment import spec_augment_apply, spec_augment_draws

    gen = torch.Generator().manual_seed(4)
    mel = torch.randn(3, 80, 500, generator=gen)
    frames = torch.tensor([500, 320, 200])
    draws = spec_augment_draws(gen, frames, 80, 27, 2, 100, 2)
    got = spec_augment_apply(mel.transpose(1, 2), frames, draws, 2).transpose(1, 2)
    assert torch.equal(got, train_ref.spec_augment(mel, frames, draws, 2))
