"""The port's audio-visual modules against the JAX package, on the CPU, in fp32.

The same numpy-seeded inputs and the same weights (carried across by
``convert.video_params_from_jax`` and ``port_from_jax``) go through both
packages. Tolerances:

- the visual frontend and the AV-HuBERT trunk: 1e-4 of the largest
  magnitude (fp32 convolutions and matmuls summed in another order);
- ``stacked_fbank_features``: bit-equal (the same numpy code);
- decode tokens: identical, greedy and beam 2, under ``asr``, ``vsr`` and
  ``avsr``;
- the committed fairseq-keyed golden ``tests/golden/avhubert_debug_golden.npz``:
  1e-4, as the JAX package's own golden test.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_flamingo_tpu.decoding import DecodingOptions as JOptions
from whisper_flamingo_tpu.models import avhubert as ja
from whisper_flamingo_tpu.models import visual as jv
from whisper_flamingo_tpu.models.dims import MODEL_DIMS as JMODEL_DIMS
from whisper_flamingo_tpu.models.whisper import ModelExtras as JExtras
from whisper_flamingo_tpu.models.whisper import Whisper as JWhisper

from whisper_flamingo_tpu_torch.convert import video_params_from_jax, visual_frontend_from_jax
from whisper_flamingo_tpu_torch.decoding import DecodingOptions
from whisper_flamingo_tpu_torch.models import avhubert as ta
from whisper_flamingo_tpu_torch.models import visual as tv
from whisper_flamingo_tpu_torch.models.dims import MODEL_DIMS
from whisper_flamingo_tpu_torch.training import steps as tsteps

from test_torch_model import port_from_jax

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
REL = 1e-4

# the trunks held: debug (pre-LN, video only), debug-av (concat and add
# fusion) and a base-style post-LN trunk at debug width
SMALL = dict(embed_dim=64, n_layers=2, n_heads=2, ffn_dim=128, conv_pos=8, conv_pos_groups=2)
TRUNKS = {
    "debug": dict(SMALL),
    "debug_av_concat": dict(SMALL, audio_feat_dim=8),
    "debug_av_add": dict(SMALL, audio_feat_dim=8, modality_fuse="add"),
    "post_ln": dict(SMALL, layer_norm_first=False),
    "post_ln_av": dict(SMALL, layer_norm_first=False, audio_feat_dim=8),
}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, (err, scale)


def _random_bn_stats(tree, rng):
    """Non-trivial BatchNorm statistics and shifts in a JAX frontend tree
    (numpy), so that inference BatchNorm is exercised."""
    def bn(p):
        c = p["mean"].shape[0]
        p["mean"] = rng.normal(0, 0.5, c).astype(np.float32)
        p["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        p["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        p["bias"] = rng.normal(0, 0.3, c).astype(np.float32)

    bn(tree["bn3d"])
    for stage in ("layer1", "layer2", "layer3", "layer4"):
        for blk in tree[stage]:
            bn(blk["bn1"]), bn(blk["bn2"])
            if "downsample" in blk:
                bn(blk["downsample"]["bn"])
    return tree


def trunk_pair(cfg_kw, seed=1):
    """The same random trunk in both packages: (JAX cfg, JAX params, port trunk)."""
    jcfg, cfg = ja.VideoEncoderConfig(**cfg_kw), ta.VideoEncoderConfig(**cfg_kw)
    jp = jax.tree.map(np.asarray, ja.init_video_encoder(jax.random.PRNGKey(seed), jcfg))
    _random_bn_stats(jp["frontend"], np.random.default_rng(seed))
    trunk = ta.VideoEncoder(cfg)
    trunk.load_state_dict(video_params_from_jax(jp, cfg), strict=True)
    return jcfg, jax.tree.map(jnp.asarray, jp), trunk.eval()


# -- the visual frontend -------------------------------------------------------

@pytest.mark.parametrize("hw", [(48, 48), (47, 53), (88, 88)], ids=["48", "odd_47x53", "88"])
def test_visual_frontend_matches_jax(hw):
    rng = np.random.default_rng(0)
    jp = jax.tree.map(np.asarray, jv.init_visual_frontend(jax.random.PRNGKey(0)))
    _random_bn_stats(jp, rng)
    front = tv.VisualFrontend()
    front.load_state_dict(visual_frontend_from_jax(jp), strict=True)
    frames = rng.standard_normal((2, 3, *hw)).astype(np.float32)
    ref = jv.visual_frontend_apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(frames))
    got = tv.visual_frontend_apply(front, torch.from_numpy(frames))
    assert got.shape == (2, 3, 512)
    _close(got, ref)


def test_frontend_batch_norm_ignores_module_mode():
    """``.train()`` does not switch BatchNorm to batch statistics: the
    frontend always reads the stored ones."""
    rng = np.random.default_rng(2)
    jp = _random_bn_stats(jax.tree.map(np.asarray, jv.init_visual_frontend(jax.random.PRNGKey(2))),
                          rng)
    front = tv.VisualFrontend()
    front.load_state_dict(visual_frontend_from_jax(jp))
    frames = torch.from_numpy(rng.standard_normal((1, 2, 48, 48)).astype(np.float32))
    evaluated = tv.visual_frontend_apply(front.eval(), frames)
    trained = tv.visual_frontend_apply(front.train(), frames)
    assert torch.equal(evaluated, trained)
    assert torch.equal(front.frontend3D[1].running_mean,
                       torch.from_numpy(jp["bn3d"]["mean"]))


def test_visual_frontend_init_and_torch_keys():
    """The init's distributions, and a reference-keyed state (the module's
    own) loads by key; a missing weight raises."""
    front = tv.init_visual_frontend(torch.Generator().manual_seed(0), device="cpu")
    jp = jv.init_visual_frontend(jax.random.PRNGKey(0))
    sd = front.state_dict()
    ref = visual_frontend_from_jax(jax.tree.map(np.asarray, jp))
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert sd[k].shape == v.shape, k
        if k.endswith("relu1.weight"):
            assert torch.all(sd[k] == 0.25)
    w = sd["layer2.0.conv1.weight"]  # He: std sqrt(2 / (3 * 3 * 128))
    assert abs(w.std().item() / np.sqrt(2 / (9 * 128)) - 1) < 0.05
    loaded = tv.load_visual_frontend_torch({k: v.numpy() for k, v in sd.items()}, device="cpu")
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k
    partial = {k: v for k, v in sd.items() if k != "layer4.1.bn2.running_var"}
    with pytest.raises(KeyError, match="layer4.1.bn2.running_var"):
        tv.load_visual_frontend_torch(partial, device="cpu")


# -- the AV-HuBERT trunk -----------------------------------------------------

@pytest.mark.parametrize("name", list(TRUNKS))
def test_trunk_matches_jax(name):
    """Each modality the trunk takes: both, video only and (with an audio
    trunk) audio only."""
    jcfg, jp, trunk = trunk_pair(TRUNKS[name])
    rng = np.random.default_rng(3)
    video = rng.standard_normal((2, 6, 48, 48)).astype(np.float32)
    audio = rng.standard_normal((2, 6, 8)).astype(np.float32)
    cases = [(video, None)]
    if jcfg.audio_feat_dim is not None:
        cases += [(video, audio), (None, audio)]
    for v, a in cases:
        ref = ja.avhubert_encoder_apply(jp, jcfg, video=None if v is None else jnp.asarray(v),
                                        audio=None if a is None else jnp.asarray(a))
        got = ta.avhubert_encoder_apply(
            trunk, trunk.cfg, video=None if v is None else torch.from_numpy(v),
            audio=None if a is None else torch.from_numpy(a))
        assert got.shape == (2, 6, 64)
        _close(got, ref)
    got = ta.video_encoder_apply(trunk, trunk.cfg, torch.from_numpy(video))
    _close(got, ja.video_encoder_apply(jp, jcfg, jnp.asarray(video)))


def test_trunk_needs_a_modality():
    _, _, trunk = trunk_pair(TRUNKS["debug"])
    with pytest.raises(ValueError, match="at least one"):
        ta.avhubert_encoder_apply(trunk, trunk.cfg)
    with pytest.raises(ValueError, match="needs video"):
        ta.avhubert_encoder_apply(trunk, trunk.cfg, audio=torch.zeros(1, 2, 8))


def test_mixed_modality_rows_mask_stream_features():
    """A mixed batch (row 0 both streams, row 1 fbank only, row 2 nothing):
    the port's ``_apply_av_encoder`` equals JAX's; the fbank-only row equals
    an audio-only encode of it and the empty row is exactly zero."""
    from whisper_flamingo_tpu.training.steps import _apply_av_encoder as japply

    jcfg, jp, trunk = trunk_pair(TRUNKS["debug_av_concat"])
    rng = np.random.default_rng(7)
    video = rng.standard_normal((3, 6, 48, 48)).astype(np.float32)
    fbank = rng.standard_normal((3, 6, 8)).astype(np.float32)
    video[1:] = 0.0
    fbank[2] = 0.0
    lens = {"video_lens": np.asarray([6, 0, 0], np.int32),
            "fbank_lens": np.asarray([6, 6, 0], np.int32)}
    jbatch = {"video": jnp.asarray(video), "fbank": jnp.asarray(fbank),
              **{k: jnp.asarray(v) for k, v in lens.items()}}
    ref = japply(ja.avhubert_encoder_apply, jp, jcfg, jbatch, jnp.float32)
    batch = tsteps.to_device({"video": video, "fbank": fbank, **lens}, torch.device("cpu"))
    got = tsteps._apply_av_encoder(trunk, batch, torch.float32)
    _close(got, ref)
    assert torch.all(got[2] == 0)
    a_only = ta.avhubert_encoder_apply(trunk, trunk.cfg, audio=torch.from_numpy(fbank[1:2]))
    torch.testing.assert_close(got[1], a_only[0], atol=1e-5, rtol=0)
    unmasked = ta.avhubert_encoder_apply(trunk, trunk.cfg, video=batch["video"],
                                         audio=batch["fbank"])
    assert (unmasked[1] - a_only[0]).abs().max().item() > 1e-3


@pytest.mark.parametrize("n", [16000, 16123, 401, 0], ids=["1s", "ragged", "short", "empty"])
def test_stacked_fbank_features_bit_equal(n):
    wav = np.random.default_rng(n).standard_normal(n).astype(np.float32) * 0.1
    ref = ja.stacked_fbank_features(wav)
    got = ta.stacked_fbank_features(wav)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(ta.stacked_fbank_features(wav, normalize=False),
                                  ja.stacked_fbank_features(wav, normalize=False))


def test_video_encoder_configs_match_jax():
    assert set(ta.VIDEO_ENCODER_CONFIGS) == set(ja.VIDEO_ENCODER_CONFIGS)
    for name, cfg in ja.VIDEO_ENCODER_CONFIGS.items():
        ours = ta.VIDEO_ENCODER_CONFIGS[name]
        assert vars(ours) == vars(cfg) and ours.fused_dim == cfg.fused_dim, name


def test_init_video_encoder_matches_jax_layout():
    """The init's tree holds exactly the keys and shapes of a JAX init
    carried across, with JAX's LayerNorm and bias values."""
    for name in ("debug", "debug-av", "base"):
        cfg = ta.VIDEO_ENCODER_CONFIGS[name]
        trunk = ta.init_video_encoder(torch.Generator().manual_seed(0), cfg, device="cpu")
        jp = jax.tree.map(np.asarray, ja.init_video_encoder(jax.random.PRNGKey(0),
                                                             ja.VIDEO_ENCODER_CONFIGS[name]))
        ref = video_params_from_jax(jp, cfg)
        sd = trunk.state_dict()
        assert set(sd) == set(ref), name
        for k, v in ref.items():
            assert sd[k].shape == v.shape, (name, k)
            if k.endswith(("layer_norm.weight", "proj.bias", "fc1.bias")):
                assert torch.equal(sd[k], v), (name, k)
        assert not any(p.requires_grad for p in trunk.parameters())


# -- load_avhubert_torch ----------------------------------------------------

def _fairseq_state(cfg_kw, seed, frontend=None):
    """A fairseq-keyed state from a random JAX trunk: the weight-normed
    pos conv (weight_g, weight_v) and, with ``frontend`` (a port frontend
    state), ``feature_extractor_video.resnet.{frontend3D, trunk.layer*}``."""
    _, jp, _ = trunk_pair(cfg_kw, seed)
    cfg = ta.VideoEncoderConfig(**cfg_kw)
    sd = {k: v.numpy() for k, v in video_params_from_jax(jax.tree.map(np.asarray, jp),
                                                         cfg).items()
          if not k.startswith("feature_extractor_video.resnet.")}
    rng = np.random.default_rng(seed)
    w = sd.pop("encoder.pos_conv.0.weight")
    sd["encoder.pos_conv.0.weight_v"] = w * 3.0
    sd["encoder.pos_conv.0.weight_g"] = (0.5 + rng.random((1, 1, cfg.conv_pos))).astype(np.float32)
    if frontend is not None:
        for k, v in frontend.items():
            key = k if k.startswith("frontend3D.") else f"trunk.{k}"
            sd[f"feature_extractor_video.resnet.{key}"] = v.numpy()
    return sd


@pytest.mark.parametrize("name", ["debug", "debug_av_concat", "post_ln_av"])
def test_load_avhubert_torch_matches_jax_loader(name):
    """One fairseq-keyed state (weight norm, the resnet/trunk key surgery)
    through both loaders: the port's trunk holds the JAX loader's tree, and
    both encode alike."""
    cfg_kw = TRUNKS[name]
    front = tv.init_visual_frontend(torch.Generator().manual_seed(5), device="cpu")
    with torch.no_grad():
        front.frontend3D[1].running_mean.normal_(0, 0.5)
    state = _fairseq_state(cfg_kw, 4, {k: v for k, v in front.state_dict().items()
                                        if not k.endswith("num_batches_tracked")})
    jcfg, cfg = ja.VideoEncoderConfig(**cfg_kw), ta.VideoEncoderConfig(**cfg_kw)
    jparams = jax.tree.map(np.asarray, ja.load_avhubert_torch(state, jcfg))
    trunk = ta.load_avhubert_torch(state, cfg, device="cpu")
    ref = video_params_from_jax(jparams, cfg)
    got = trunk.state_dict()
    for k, v in ref.items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(got[k], v, atol=1e-6, rtol=1e-6, msg=k)
    rng = np.random.default_rng(6)
    video = rng.standard_normal((1, 4, 48, 48)).astype(np.float32)
    audio = rng.standard_normal((1, 4, 8)).astype(np.float32) if cfg.audio_feat_dim else None
    _close(ta.avhubert_encoder_apply(trunk, cfg, video=torch.from_numpy(video),
                                     audio=None if audio is None else torch.from_numpy(audio)),
           ja.avhubert_encoder_apply(jax.tree.map(jnp.asarray, jparams), jcfg,
                                     video=jnp.asarray(video),
                                     audio=None if audio is None else jnp.asarray(audio)))


def test_load_avhubert_torch_reproduces_the_golden():
    """The committed fairseq-keyed golden (no frontend keys: its frontend is
    the JAX seed-0 init's, carried across)."""
    g = np.load(os.path.join(GOLDEN, "avhubert_debug_golden.npz"))
    state = {k[len("state::"):]: g[k] for k in g.files if k.startswith("state::")}
    cfg = ta.VIDEO_ENCODER_CONFIGS["debug"]
    base = ta.VideoEncoder(cfg)
    jinit = ja.init_video_encoder(jax.random.PRNGKey(0), ja.VIDEO_ENCODER_CONFIGS["debug"])
    base.load_state_dict(video_params_from_jax(jax.tree.map(np.asarray, jinit), cfg))
    trunk = ta.load_avhubert_torch(state, cfg, trunk=base)
    feats = ta.video_encoder_apply(trunk, cfg, torch.from_numpy(g["frames"]))
    np.testing.assert_allclose(feats.numpy(), g["feats"], atol=1e-4, rtol=1e-4)
    assert torch.equal(trunk.encoder.pos_conv[0].weight,
                       torch.from_numpy(state["encoder.pos_conv.0.weight"]))


def test_load_avhubert_torch_refuses_a_mismatched_audio_trunk():
    video_only = _fairseq_state(TRUNKS["debug"], 8)
    with_audio = _fairseq_state(TRUNKS["debug_av_concat"], 8)
    for jcfg_kw, state in ((TRUNKS["debug_av_concat"], video_only),
                           (TRUNKS["debug"], with_audio)):
        with pytest.raises(ValueError, match="feature_extractor_audio"):
            ja.load_avhubert_torch(state, ja.VideoEncoderConfig(**jcfg_kw))
        with pytest.raises(ValueError, match="feature_extractor_audio"):
            ta.load_avhubert_torch(state, ta.VideoEncoderConfig(**jcfg_kw), device="cpu")


# -- AVWhisper ---------------------------------------------------------------

DIMS = MODEL_DIMS["debug"]
# a 96-wide trunk, so the decoder projects the stream (xt_projection 96 -> 64)
WIDE = dict(SMALL, embed_dim=96)


def av_pair(cfg_kw, gate=1.0, seed=0):
    """(JAX AVWhisper, port AVWhisper) with the same weights, gates open."""
    jcfg, jvp, trunk = trunk_pair(cfg_kw, seed + 1)
    extras = dict(add_gated_x_attn=1, num_langs=1, bert_dim=cfg_kw["embed_dim"])
    jparams, model = port_from_jax(DIMS, extras, seed=seed, gate=gate)
    jwhisper = JWhisper(dims=JMODEL_DIMS["debug"], params=jparams, extras=JExtras(**extras))
    return (ja.AVWhisper(whisper=jwhisper, video_params=jvp, video_cfg=jcfg),
            ta.AVWhisper(whisper=model, video=trunk))


@pytest.fixture(scope="module")
def av_inputs():
    rng = np.random.default_rng(4)
    mel = rng.standard_normal((2, 80, 3000)).astype(np.float32) * 0.5
    video = rng.standard_normal((2, 8, 48, 48)).astype(np.float32)
    fbank = ta.stacked_fbank_features(rng.standard_normal(16000).astype(np.float32) * 0.1)
    fbank = np.stack([fbank[:8, :8], fbank[8:16, :8]])
    return mel, video, fbank


def test_av_encode_masks_match_jax(av_inputs):
    mel, video, fbank = av_inputs
    jav, av = av_pair(TRUNKS["debug_av_concat"])
    for kw in ({}, {"test_a": True}, {"test_v": True}):
        ja_feats, jv_feats = jav.encode(mel, video, fbank, **kw)
        a_feats, v_feats = av.encode(mel, video, fbank, **kw)
        for got, ref in ((a_feats, ja_feats), (v_feats, jv_feats)):
            if float(jnp.abs(ref).max()) == 0:  # a dropped modality: exact zeros
                assert got.shape == ref.shape and got.abs().max().item() == 0
            else:
                _close(got, ref)
    # asr with nothing loaded: a present-but-zero one-frame stream
    _, v_feats = av.encode(mel, test_a=True)
    assert v_feats.shape == (2, 1, 64) and v_feats.abs().max().item() == 0


def test_av_encode_modality_draw():
    """Training draws one u from the generator: both if u < prob_av, audio
    only (zero video features) if u < prob_av + prob_a, video only (zero
    encoder features) otherwise."""
    _, av = av_pair(TRUNKS["debug"])
    rng = np.random.default_rng(9)
    mel = rng.standard_normal((1, 80, 200)).astype(np.float32)
    video = rng.standard_normal((1, 4, 48, 48)).astype(np.float32)
    seen = set()
    for seed in range(12):
        u = float(torch.rand((), generator=torch.Generator().manual_seed(seed)))
        a, v = av.encode(mel, video, training=True,
                         generator=torch.Generator().manual_seed(seed))
        kept = (a.abs().max().item() > 0, v.abs().max().item() > 0)
        want = (True, True) if u < 0.5 else (True, False) if u < 0.75 else (False, True)
        assert kept == want, (seed, u, kept)
        seen.add(kept)
    assert len(seen) == 3


def _decode_args(modality, mel, video, fbank):
    if modality == "asr":
        return dict(test_a=True)
    if modality == "vsr":
        return dict(video=video, test_v=True)
    return dict(video=video, audio=fbank)


@pytest.mark.parametrize("beam", [None, 2], ids=["greedy", "beam2"])
@pytest.mark.parametrize("modality", ["asr", "vsr", "avsr"])
def test_av_decode_tokens_match_jax(modality, beam, av_inputs):
    mel, video, fbank = av_inputs
    cfg_kw = dict(WIDE, audio_feat_dim=8) if modality == "avsr" else WIDE
    jav, av = av_pair(cfg_kw, gate=1.5)
    opts = dict(language="en", fp16=False, sample_len=8, without_timestamps=True,
                beam_size=beam)
    kw = _decode_args(modality, mel, video, fbank)
    ref = jav.decode(mel, JOptions(**opts), **kw)
    got = av.decode(mel, DecodingOptions(**opts), **kw)
    assert [r.tokens for r in got] == [r.tokens for r in ref]
    assert all(len(r.tokens) > 0 for r in got)
    for g, r in zip(got, ref):
        assert abs(g.avg_logprob - r.avg_logprob) <= 1e-4


def test_av_decode_condition_matters(av_inputs):
    """With the gates open each modality decodes differently: the stream is
    read."""
    mel, video, fbank = av_inputs
    _, av = av_pair(dict(WIDE, audio_feat_dim=8), gate=1.5)
    opts = DecodingOptions(language="en", fp16=False, sample_len=8, without_timestamps=True)
    lp = {m: [r.avg_logprob for r in av.decode(mel, opts, **_decode_args(m, mel, video, fbank))]
          for m in ("asr", "vsr", "avsr")}
    assert lp["asr"] != lp["avsr"] != lp["vsr"]


def test_stream_cap_raises_in_both_packages():
    """A clip longer than n_text_ctx (448) frames: the stream takes the
    decoder positional embedding, so both packages raise (450 frames: a
    448-frame clip padded to a multiple of 50 by the collator)."""
    jav, av = av_pair(TRUNKS["debug"])
    rng = np.random.default_rng(5)
    mel = rng.standard_normal((1, 80, 200)).astype(np.float32)
    video = rng.standard_normal((1, 450, 16, 16)).astype(np.float32)
    opts = dict(language="en", fp16=False, sample_len=2, without_timestamps=True)
    with pytest.raises(ValueError, match="n_text_ctx"):
        jav.decode(mel, JOptions(**opts), video=video)
    with pytest.raises(ValueError, match="n_text_ctx"):
        av.decode(mel, DecodingOptions(**opts), video=video)
