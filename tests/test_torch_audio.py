"""The port's audio frontend against the JAX package's, on the CPU.

Tolerance 2e-5 on the log-mel: both sides are fp32; the JAX side is a
matmul DFT at HIGHEST precision, the port an FFT, so the power spectra
differ by ~1e-7 relative, and log10 / 4 shrinks that further.

``load_audio``'s ffmpeg fallback runs against a fake ``ffmpeg`` script put
on PATH (it decodes a raw test container), with JAX's ``load_audio`` on the
same file as the reference: the samples must be equal.
"""

import os
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


FAKE_FFMPEG = """#!{python}
# Decodes the test's raw container: float32 samples after a 4-byte magic;
# answers the ffmpeg command line load_audio builds with s16le mono PCM.
import sys
import numpy as np
args = sys.argv[1:]
assert args[args.index("-f") + 1] == "s16le" and args[args.index("-ac") + 1] == "1"
assert args[-1] == "-" and args[args.index("-ar") + 1] == "16000"
raw = open(args[args.index("-i") + 1], "rb").read()
if raw[:4] != b"FAKE":
    sys.stderr.write("Invalid data found when processing input")
    sys.exit(1)
x = np.frombuffer(raw[4:], np.float32)
sys.stdout.buffer.write((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
"""


@pytest.fixture
def fake_ffmpeg(tmp_path, monkeypatch):
    """An ``ffmpeg`` on PATH that decodes a raw test container (the image
    has no ffmpeg)."""
    import sys

    bindir = tmp_path / "bin"
    bindir.mkdir()
    exe = bindir / "ffmpeg"
    exe.write_text(FAKE_FFMPEG.format(python=sys.executable))
    exe.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ.get('PATH', '')}")
    return exe


def _fake_container(path, seed):
    x = (np.random.default_rng(seed).standard_normal(3200) * 0.2).astype(np.float32)
    with open(path, "wb") as f:
        f.write(b"FAKE" + x.tobytes())


@pytest.mark.parametrize("name", ["clip.mp3", "clip.flac", "float.wav"])
def test_load_audio_falls_back_to_ffmpeg(tmp_path, fake_ffmpeg, name):
    """A non-WAV path, and a ``.wav`` the native reader refuses (here not
    RIFF at all), decode through ffmpeg, equal to JAX's ``load_audio``."""
    path = str(tmp_path / name)
    _fake_container(path, seed=len(name))
    got = taudio.load_audio(path)
    assert got.dtype == np.float32 and got.shape == (3200,)
    np.testing.assert_array_equal(got, jaudio.load_audio(path))


def test_load_audio_ffmpeg_errors(tmp_path, fake_ffmpeg, monkeypatch):
    """An ffmpeg failure raises ``RuntimeError`` with its message; so does a
    non-WAV file with no ffmpeg on PATH, as in JAX."""
    bad = str(tmp_path / "bad.mp3")
    with open(bad, "wb") as f:
        f.write(b"not audio")
    with pytest.raises(RuntimeError, match="Invalid data"):
        taudio.load_audio(bad)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    for mod in (taudio, jaudio):
        with pytest.raises(RuntimeError, match="ffmpeg is unavailable"):
            mod.load_audio(bad)


def test_load_audio_24bit_wav_goes_to_ffmpeg(tmp_path, monkeypatch):
    """A 24-bit PCM WAV is refused by the native reader (``wave.Error``, as
    in JAX) and so needs ffmpeg: without it, ``RuntimeError``."""
    path = str(tmp_path / "deep.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(3)
        w.setframerate(16000)
        w.writeframes(b"\x00\x01\x02" * 100)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="ffmpeg is unavailable"):
        taudio.load_audio(path)
