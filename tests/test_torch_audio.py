"""The port's audio frontend against the JAX package's, on the CPU.

Tolerance 2e-5 on the log-mel: both sides are fp32; the JAX side is a
matmul DFT at HIGHEST precision, the port an FFT, so the power spectra
differ by ~1e-7 relative, and log10 / 4 shrinks that further.
"""

import wave

import numpy as np
import pytest
import torch

from whisper_flamingo_tpu import audio as jaudio

from whisper_flamingo_tpu_torch import audio as taudio


@pytest.mark.parametrize("shape", [(2, 48000), (16000,)])
def test_log_mel_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    x[..., 4000:4400] = 0.0  # a silent patch exercises the clamp
    ref = np.asarray(jaudio.log_mel_spectrogram(x))
    got = taudio.log_mel_spectrogram(x, device="cpu")
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)


def test_mel_filters_and_passthrough():
    np.testing.assert_array_equal(taudio.mel_filters_np(80), jaudio.mel_filters_np(80))
    np.testing.assert_array_equal(taudio.mel_filters_np(128), jaudio.mel_filters_np(128))
    mel = np.zeros((80, 3000), np.float32)
    assert taudio.log_mel_spectrogram(mel, device="cpu") is mel


def test_pad_or_trim_and_load_audio(tmp_path):
    a = np.arange(10, dtype=np.float32)
    for length in (4, 10, 15):
        ref = jaudio.pad_or_trim(a, length)
        np.testing.assert_array_equal(taudio.pad_or_trim(a, length), ref)
        np.testing.assert_array_equal(taudio.pad_or_trim(torch.from_numpy(a), length).numpy(), ref)
    b = np.ones((2, 3, 5), np.float32)
    assert taudio.pad_or_trim(torch.from_numpy(b), 7, axis=1).shape == (2, 7, 5)

    tone = (np.sin(np.arange(8000) / 5.0) * 8000).astype(np.int16)
    path = str(tmp_path / "tone.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes(tone.tobytes())
    np.testing.assert_allclose(taudio.load_audio(path), jaudio.load_audio(path), atol=1e-7)
