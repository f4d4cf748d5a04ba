"""Plain log-Mel spectrogram: 16 kHz audio, 400-point Hann frames every 160
samples (the signal reflect-padded by 200 on each side, the last frame
dropped), the power spectrum by ``rfft``, the Slaney-normalised mel
filterbank (librosa's formula), log10 clamped at 1e-10, floored at the
clip's maximum less 8, then (x + 4) / 4. Computed in float64."""

from __future__ import annotations

import numpy as np
import torch

SAMPLE_RATE, N_FFT, HOP = 16000, 400, 160


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


def mel_filters(n_mels: int = 80) -> np.ndarray:
    """(n_mels, 201) Slaney-normalised triangular filters, float64."""
    freqs = np.linspace(0, SAMPLE_RATE / 2, 1 + N_FFT // 2)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2.0), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    return w * (2.0 / (hz[2: n_mels + 2] - hz[:n_mels]))[:, None]


def log_mel(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """(B, N) audio -> (B, n_mels, N // 160) float32."""
    x = audio.double()
    x = torch.nn.functional.pad(x[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP)[:, :-1]  # (B, n_frames, 400)
    n = torch.arange(N_FFT, dtype=torch.float64, device=x.device)
    window = 0.5 - 0.5 * torch.cos(2 * np.pi * n / N_FFT)  # periodic Hann
    power = torch.fft.rfft(frames * window, dim=-1).abs() ** 2  # (B, n_frames, 201)
    filt = torch.from_numpy(mel_filters(n_mels)).to(x.device)
    mel = torch.einsum("mf,btf->bmt", filt, power)
    log_spec = torch.clamp(mel, min=1e-10).log10()
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return ((log_spec + 4.0) / 4.0).float()
