"""The port's data pipeline against the JAX package's, on the CPU.

Items, collated batches and sampler orders are compared exactly (token
ids, lengths, orders) and the mels to 1e-5 (fp32 on both sides: the JAX
frontend is a matmul DFT, the port an FFT). SpecAugment and the noise mix
are bit-equal from the same rng: the noise mix both on each package's
default path (the C helper of ``native/`` wherever ``cc`` builds it, as
here) and with both helpers switched off (the numpy mix). The on-device
SpecAugment, given the draws that replay JAX's key splits, equals
``spec_augment_jax`` bit for bit.
"""

import json
import wave

import numpy as np
import pytest

from whisper_flamingo_tpu import native as jnative
from whisper_flamingo_tpu.data import collator as jcollator
from whisper_flamingo_tpu.data import dataset as jdataset
from whisper_flamingo_tpu.data import noise as jnoise
from whisper_flamingo_tpu.data import samplers as jsamplers
from whisper_flamingo_tpu.data import translations as jtranslations
from whisper_flamingo_tpu.ops import spec_augment as jspec
from whisper_flamingo_tpu.tokenizer import get_tokenizer as jget_tokenizer

import jax
import torch

from whisper_flamingo_tpu_torch import metrics, native
from whisper_flamingo_tpu_torch.data import collator, dataset, noise, samplers, translations
from whisper_flamingo_tpu_torch.ops import spec_augment
from whisper_flamingo_tpu_torch.tokenizer import get_tokenizer

MEL_TOL = 1e-5


@pytest.fixture
def numpy_noise(monkeypatch):
    """Both packages' C helpers switched off: both take the numpy mix."""
    monkeypatch.setattr(jnative, "AVAILABLE", False)
    monkeypatch.setattr(native, "AVAILABLE", False)


def _noise_wavs(rng):
    return [rng.standard_normal(n).astype(np.float32) * 3000 for n in (7000, 40000)]


def _datasets(**kw):
    src = dict(n=6, seed=2, max_sec=3.0)
    tok = get_tokenizer(True, language="en", task="transcribe")
    jtok = jget_tokenizer(True, language="en", task="transcribe")
    mine = dataset.SpeechDataset(source=dataset.SyntheticAsrSource(**src), tokenizer=tok, **kw)
    ref = jdataset.SpeechDataset(source=jdataset.SyntheticAsrSource(**src), tokenizer=jtok, **kw)
    return mine, ref


def _same_item(a, b):
    assert set(a) == set(b)
    for k in a:
        if k == "input_ids":
            np.testing.assert_allclose(a[k], np.asarray(b[k]), atol=MEL_TOL, rtol=0)
        else:
            assert a[k] == b[k], k


def test_items_equal_jax_on_the_default_noise_path():
    """Noisy, augmented items with each package's default mix (the C helper)."""
    assert native.AVAILABLE and jnative.AVAILABLE
    kw = dict(spec_augment="ls-double", noise_prob=1.0,
              noise_wavs=_noise_wavs(np.random.default_rng(0)), noise_snr=(0, 10))
    mine, ref = _datasets(**kw)
    for i in range(len(mine)):
        _same_item(mine[i], ref[i])


@pytest.mark.parametrize("augment", [False, True])
def test_items_equal_jax(numpy_noise, augment):
    """Plain items, and items with noise (every draw) and ls-double
    SpecAugment over two epochs: the per-example rng is the JAX package's."""
    kw = {}
    if augment:
        kw = dict(spec_augment="ls-double", noise_prob=1.0,
                  noise_wavs=_noise_wavs(np.random.default_rng(0)), noise_snr=(0, 10))
    mine, ref = _datasets(**kw)
    for epoch in ((0, 1) if augment else (0,)):
        mine.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(mine)):
            _same_item(mine[i], ref[i])
    assert mine.mel_lengths() == ref.mel_lengths()


def test_collated_batches_equal_jax():
    mine, ref = _datasets(prompt_use=False)
    feats = [mine[i] for i in range(4)]
    rfeats = [ref[i] for i in range(4)]
    feats[1]["prompt_lens"] = rfeats[1]["prompt_lens"] = 3  # a mixed batch's passthrough
    got = collator.WhisperCollator()(feats)
    want = jcollator.WhisperCollator()(rfeats)
    assert set(got) == set(want)
    assert got["input_ids"].shape[-1] % 100 == 0
    for k in got:
        if k == "input_ids":
            np.testing.assert_allclose(got[k], want[k], atol=MEL_TOL, rtol=0)
        elif isinstance(got[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k], k


def test_sampler_orders_across_epochs_equal_jax():
    lengths = list(np.random.default_rng(4).integers(50, 3000, 37))
    pairs = [
        (samplers.SortedBatchSampler(5, lengths), jsamplers.SortedBatchSampler(5, lengths)),
        (samplers.LengthBatchSampler(4000, lengths, min_batch_size=2),
         jsamplers.LengthBatchSampler(4000, lengths, min_batch_size=2)),
    ]
    pairs.append((samplers.ShuffledBatchSampler(samplers.SortedBatchSampler(5, lengths), seed=9),
                  jsamplers.ShuffledBatchSampler(jsamplers.SortedBatchSampler(5, lengths), seed=9)))
    pairs.append((samplers.DistributedBatchSampler(pairs[-1][0], 3, 1),
                  jsamplers.DistributedBatchSampler(pairs[-1][1], 3, 1)))
    for a, b in pairs:
        for epoch in range(3):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            assert [list(x) for x in a] == [list(x) for x in b]


def test_spec_augment_and_noise_bit_equal(numpy_noise):
    x = np.random.default_rng(1).standard_normal((300, 80)).astype(np.float32)
    for preset in spec_augment.PRESETS:
        got = spec_augment.spec_augment_np(x, 250, rng=np.random.default_rng(5),
                                           **spec_augment.PRESETS[preset])
        want = jspec.spec_augment_np(x, 250, rng=np.random.default_rng(5), **jspec.PRESETS[preset])
        np.testing.assert_array_equal(got, want)
    clean = np.random.default_rng(2).standard_normal(20000).astype(np.float32) * 3000
    wavs = _noise_wavs(np.random.default_rng(3))
    for snr in (0, 5.0, (0, 10)):
        got = noise.add_noise(clean, wavs, snr, np.random.default_rng(6))
        want = jnoise.add_noise(clean, wavs, snr, np.random.default_rng(6))
        assert got.dtype == np.int16
        np.testing.assert_array_equal(got, want)


def test_loaders_yield_the_same_batches():
    """DataLoader and PrefetchLoader over the port's dataset give the JAX
    DataLoader's batches."""
    mine, ref = _datasets()
    sampler = samplers.SortedBatchSampler(2, mine.mel_lengths())
    loader = dataset.DataLoader(mine, sampler, collator.WhisperCollator())
    jloader = jdataset.DataLoader(ref, jsamplers.SortedBatchSampler(2, ref.mel_lengths()),
                                  jcollator.WhisperCollator())
    want = list(jloader)
    for got in (list(loader), list(dataset.PrefetchLoader(loader))):
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_allclose(g["input_ids"], w["input_ids"], atol=MEL_TOL, rtol=0)
            np.testing.assert_array_equal(g["labels"], w["labels"])
            np.testing.assert_array_equal(g["dec_input_ids"], w["dec_input_ids"])


def test_hf_source_is_not_ported_yet(monkeypatch):
    """``HFAsrSource`` is ported (``test_torch_hf_sources.py`` holds it
    against JAX's): it loads through ``datasets`` and serves 16 kHz rows."""
    hf = pytest.importorskip("datasets")
    monkeypatch.setattr(hf, "load_dataset", lambda name, config=None, split=None, **kw:
                        hf.Dataset.from_dict({"audio": [{"array": np.ones(800, np.float32),
                                                         "sampling_rate": 8000}],
                                              "text": ["HELLO"]}))
    src = dataset.HFAsrSource("librispeech_asr", split="train")
    assert len(src) == 1 and src[0].text == "HELLO" and len(src[0].audio) == 1600


def _write_wav(path, n, seed):
    pcm = (np.random.default_rng(seed).standard_normal(n) * 2000).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())


def test_file_sources_and_translations_equal_jax(tmp_path):
    """Manifest and JSON sources over WAV files, with translations from a
    CSV and a LibriSpeech-style trans.txt tree attached."""
    for i in range(2):
        _write_wav(tmp_path / f"u{i}.wav", 9000 + 3000 * i, i)
    (tmp_path / "m.tsv").write_text(
        "id\twav_path\ttext\ttranslation_1\n1-2-0\tu0.wav\thello world\tbonjour\n"
        "1-2-1\tu1.wav\tspeech model\t\n")
    (tmp_path / "m.json").write_text(json.dumps(
        [{"wav_path": "u0.wav", "text": "a b", "id": "x"}, {"wav_path": "u1.wav", "text": "c"}]))
    (tmp_path / "t.csv").write_text("id,translation\n1-2-0,hallo welt\n")
    tree = tmp_path / "tree" / "1" / "2"
    tree.mkdir(parents=True)
    (tree / "1-2.trans.txt").write_text("1-2-1 HOLA\n")
    root = str(tmp_path)
    pairs = [
        (dataset.ManifestAsrSource(f"{root}/m.tsv", audio_root=root),
         jdataset.ManifestAsrSource(f"{root}/m.tsv", audio_root=root)),
        (dataset.JsonAsrSource(f"{root}/m.json", audio_root=root),
         jdataset.JsonAsrSource(f"{root}/m.json", audio_root=root)),
    ]
    lookups = ([f"{root}/tree"], [f"{root}/t.csv"])
    pairs.append((
        translations.TranslatedSource(pairs[0][0], translations.build_lookups(*lookups)),
        jtranslations.TranslatedSource(pairs[0][1], jtranslations.build_lookups(*lookups)),
    ))
    for mine, ref in pairs:
        assert len(mine) == len(ref) and mine.lengths() == ref.lengths()
        for i in range(len(mine)):
            a, b = mine[i], ref[i]
            np.testing.assert_array_equal(a.audio, b.audio)
            assert (a.text, a.id, a.translations, a.prompt) == (b.text, b.id, b.translations, b.prompt)
    assert pairs[2][0][1].translations == ["HOLA", ""]


# -- the native helpers --------------------------------------------------------

def _clips(n, seed=0):
    """n seeded 3 s clips at int16 scale, noise of other lengths, SNRs in -5..10 dB."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(48000).astype(np.float32) * rng.uniform(500, 8000),
             [rng.standard_normal(int(rng.integers(8000, 60000))).astype(np.float32) * 3000],
             float(rng.uniform(-5, 10)), int(rng.integers(0, 2**31)))
            for _ in range(n)]


@pytest.mark.parametrize("path", ["default", "numpy"])
def test_add_noise_bit_equal_jax_over_200_clips(monkeypatch, path):
    """The default path mixes through the C helper in double precision in
    both packages (it used to differ from the port's fp32 numpy mix in 1 of
    ~8,000 samples); forced to numpy, both take the numpy mix."""
    if path == "numpy":
        monkeypatch.setattr(jnative, "AVAILABLE", False)
        monkeypatch.setattr(native, "AVAILABLE", False)
    else:
        assert native.AVAILABLE and jnative.AVAILABLE
    for clean, wavs, snr, seed in _clips(200):
        got = noise.add_noise(clean, wavs, snr, np.random.default_rng(seed))
        want = jnoise.add_noise(clean, wavs, snr, np.random.default_rng(seed))
        assert got.dtype == np.int16
        np.testing.assert_array_equal(got, want)


def test_native_helpers_match_their_python_paths():
    """The C edit distance equals the numpy DP; the C resampler equals
    np.interp within fp32 rounding; the library builds under build/."""
    assert native.lib_path().startswith(native.BUILD_DIR)
    rng = np.random.default_rng(4)
    for _ in range(20):
        a = rng.integers(0, 5, size=int(rng.integers(0, 30))).tolist()
        b = rng.integers(0, 5, size=int(rng.integers(0, 30))).tolist()
        got = metrics.edit_distance(a, b)
        native_ok = native.AVAILABLE
        try:
            native.AVAILABLE = False
            want = metrics.edit_distance(a, b)
        finally:
            native.AVAILABLE = native_ok
        assert got == want
    x = rng.standard_normal(8000).astype(np.float32)
    from whisper_flamingo_tpu_torch.audio import resample_linear

    np.testing.assert_allclose(native.resample_linear(x, 8000, 16000),
                               resample_linear(x, 8000, 16000), atol=1e-6)
    assert native.mix_noise(np.zeros(0, np.float32), x, 0.0) is None  # rc != 0


# -- SpecAugment on the device -------------------------------------------------

def _jax_draws(key, b, n_mels, frames, p):
    """spec_augment_jax's integers, replayed from its key splits."""
    n_f, n_t = p["n_freq_mask"], p["n_time_mask"]
    out = np.zeros((b, n_f + n_t, 3), np.int64)
    for row, k in enumerate(jax.random.split(key, b)):
        kf = jax.random.split(k, n_f + n_t)
        for i in range(n_f + n_t):
            k1, k2, k3 = jax.random.split(kf[i], 3)
            max_w = p["max_freq_width"] if i < n_f else p["max_time_width"]
            w = int(jax.random.randint(k1, (), 0, max_w))
            end = int(jax.random.randint(k2, (), 0, max_w))
            high = n_mels - w if i < n_f else int(frames[row]) - w
            out[row, i] = (w, end, int(jax.random.randint(k3, (), 0, max(high, 1))))
    return out


@pytest.mark.parametrize("preset", sorted(spec_augment.PRESETS))
def test_spec_augment_apply_equals_spec_augment_jax(preset):
    """Rows whose frames fall below the mask widths (0, 3, 20, 90) take
    JAX's degenerate ranges and gates."""
    p = spec_augment.PRESETS[preset]
    frames = np.array([0, 3, 20, 90, 250, 300], np.int32)
    x = np.random.default_rng(6).standard_normal((6, 300, 80)).astype(np.float32)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jspec.spec_augment_jax(key, x, frames, **p))
        draws = torch.from_numpy(_jax_draws(key, 6, 80, frames, p))
        got = spec_augment.spec_augment_apply(
            torch.from_numpy(x), torch.from_numpy(frames), draws, p["n_freq_mask"])
        np.testing.assert_array_equal(got.numpy(), want)


def test_spec_augment_draws_cover_jaxs_ranges():
    """The draws lie in JAX's ranges (per-row highs included, at least 1),
    reach their ends, and repeat from one generator seed."""
    p = spec_augment.PRESETS["ls-double"]
    frames = torch.tensor([0, 5, 40, 99, 100, 101, 3000] * 300)
    g = torch.Generator().manual_seed(0)
    d = spec_augment.spec_augment_draws(g, frames, 80, **p)
    assert d.shape == (len(frames), 4, 3) and d.dtype == torch.int64
    w, start = d[..., 0], d[..., 2]
    assert int(d[:, :2, :2].max()) == 26 and int(d[:, 2:, :2].max()) == 99 and int(d.min()) == 0
    assert bool((start[:, :2] < torch.clamp(80 - w[:, :2], min=1)).all())
    assert bool((start[:, 2:] < torch.clamp(frames[:, None] - w[:, 2:], min=1)).all())
    assert int(start[frames == 3000][:, 2:].max()) > 2800
    again = spec_augment.spec_augment_draws(torch.Generator().manual_seed(0), frames, 80, **p)
    assert torch.equal(d, again)
    x = torch.randn(7, 300, 80)
    out = spec_augment.spec_augment_torch(torch.Generator().manual_seed(1), x, frames[:7], **p)
    assert out.shape == x.shape and bool(((out == x) | (out == 0)).all())
