"""Audio frontend: WAV reading, padding, and the log-Mel spectrogram.

Port of ``whisper_flamingo_tpu/audio.py``: 16 kHz, N_FFT 400, hop 160,
30 s chunks of 3000 mel frames. ``log_mel_spectrogram`` is Hann-window
``torch.stft`` (``center=True``, reflect padding, last frame dropped) ->
power -> the generated Slaney mel filterbank -> log10 -> clamp at
(row max - 8) -> (x + 4) / 4, with the fork's passthrough when the input
already is a spectrogram (any dim of 80).

``load_audio`` reads PCM WAV natively and decodes every other file (and
a ``.wav`` the native reader refuses) through the ffmpeg CLI, as JAX does.

Left out: the pad-to-8 batch guard (a TPU miscompile workaround) and the
matmul-DFT formulation (``torch.stft`` is the FFT).
"""

from __future__ import annotations

import shutil
import struct
import subprocess
import wave
from functools import lru_cache
from typing import Optional, Union

import numpy as np
import torch

from .utils import resolve_device

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000 samples in a 30-second chunk
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000 frames in a mel spectrogram input

N_SAMPLES_PER_TOKEN = HOP_LENGTH * 2  # initial convs have stride 2
FRAMES_PER_SECOND = SAMPLE_RATE // HOP_LENGTH  # 10 ms per audio frame
TOKENS_PER_SECOND = SAMPLE_RATE // N_SAMPLES_PER_TOKEN  # 20 ms per audio token


def load_audio(file: str, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Read an audio file as a mono float32 waveform at ``sr``.

    A ``.wav`` path is read natively first; any other file, or a ``.wav``
    the native reader refuses (not PCM, an unsupported sample width), is
    decoded by the ``ffmpeg`` CLI to 16-bit mono at ``sr``. Without ffmpeg
    on PATH that raises ``RuntimeError``."""
    if file.lower().endswith(".wav"):
        try:
            return _load_wav(file, sr)
        except (wave.Error, struct.error):
            pass  # not a plain PCM WAV: ffmpeg below
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(f"cannot decode {file!r}: not a PCM WAV and ffmpeg is unavailable")
    cmd = ["ffmpeg", "-nostdin", "-threads", "0", "-i", file,
           "-f", "s16le", "-ac", "1", "-acodec", "pcm_s16le", "-ar", str(sr), "-"]
    try:
        out = subprocess.run(cmd, capture_output=True, check=True).stdout
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"Failed to load audio: {e.stderr.decode()}") from e
    return np.frombuffer(out, np.int16).flatten().astype(np.float32) / 32768.0


def _load_wav(file: str, sr: int) -> np.ndarray:
    with wave.open(file, "rb") as w:
        n_channels = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        frames = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(frames, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(frames, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(frames, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise wave.Error(f"unsupported sample width: {width}")
    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    if rate != sr:
        data = resample_linear(data, rate, sr)
    return data


def resample_linear(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Linear-interpolation resampler (host-side, for file IO only)."""
    if orig_sr == target_sr:
        return x
    n_out = int(round(x.shape[0] / orig_sr * target_sr))
    t_out = np.arange(n_out) / target_sr
    t_in = np.arange(x.shape[0]) / orig_sr
    return np.interp(t_out, t_in, x).astype(np.float32)


def pad_or_trim(array, length: int = N_SAMPLES, *, axis: int = -1):
    """Pad with zeros or trim to ``length`` along ``axis`` (numpy or torch)."""
    if isinstance(array, torch.Tensor):
        if array.shape[axis] > length:
            array = array.narrow(axis, 0, length)
        if array.shape[axis] < length:
            pad = [0] * (2 * array.dim())
            pad[2 * (array.dim() - 1 - axis % array.dim()) + 1] = length - array.shape[axis]
            array = torch.nn.functional.pad(array, pad)
        return array
    if array.shape[axis] > length:
        array = np.take(array, np.arange(length), axis=axis)
    if array.shape[axis] < length:
        pad_widths = [(0, 0)] * array.ndim
        pad_widths[axis] = (0, length - array.shape[axis])
        array = np.pad(array, pad_widths)
    return array


def _hz_to_mel(freq) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )


def _mel_to_hz(mels) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs
    )


@lru_cache(maxsize=None)
def mel_filters_np(n_mels: int = 80, sr: int = SAMPLE_RATE, n_fft: int = N_FFT) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, (n_mels, 1 + n_fft // 2)."""
    if n_mels not in (80, 128):
        raise ValueError(f"Unsupported n_mels: {n_mels}")
    n_freqs = 1 + n_fft // 2
    fftfreqs = np.linspace(0, sr / 2, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def log_mel_spectrogram(
    audio: Union[str, np.ndarray, torch.Tensor],
    n_mels: int = 80,
    padding: int = 0,
    device: Optional[Union[str, torch.device]] = None,
):
    """Log-Mel spectrogram of 16 kHz audio, computed on ``device`` (the
    card unless the caller names another).

    Accepts a path, a 1-D waveform or a batch (B, T); returns
    (n_mels, T // 160) or (B, n_mels, T // 160) as a float32 tensor. An
    input that already is a spectrogram (any dim == 80) is returned
    unchanged."""
    if isinstance(audio, str):
        audio = load_audio(audio)
    if 80 in tuple(audio.shape):
        return audio
    dev = resolve_device(device)
    x = torch.as_tensor(audio, dtype=torch.float32).to(dev)
    single = x.dim() == 1
    if single:
        x = x[None]
    if padding > 0:
        x = torch.nn.functional.pad(x, (0, padding))
    window = torch.hann_window(N_FFT, device=dev)
    stft = torch.stft(x, N_FFT, HOP_LENGTH, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    stft = stft[..., :-1]
    power = stft.real ** 2 + stft.imag ** 2  # (B, n_freqs, n_frames)
    filters = torch.from_numpy(mel_filters_np(n_mels)).to(dev)
    mel = torch.matmul(filters, power)  # (B, n_mels, n_frames)
    log_spec = torch.clamp(mel, min=1e-10).log10()
    row_max = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, row_max - 8.0)
    out = (log_spec + 4.0) / 4.0
    return out[0] if single else out
