"""Noise augmentation: RMS-matched SNR mixing.

Port of ``whisper_flamingo_tpu/data/noise.py`` (the reference's
``select_noise`` / ``add_noise``): a random noise pick from a list, an
integer-or-range SNR, the noise tiled or cropped to the clean length,
RMS-matched scaling, the int16 clipping guard, int16 output. As in the
JAX package, the mix goes through the C helper (``native.mix_noise``,
double precision) whenever it builds, and through numpy in fp32 otherwise.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np


def select_noise(noise_wavs: Sequence, rng: np.random.Generator) -> np.ndarray:
    """Pick one noise waveform: a path (read as int16-scale samples) or an
    array."""
    idx = int(rng.integers(0, len(noise_wavs)))
    noise = noise_wavs[idx]
    if isinstance(noise, str):
        from ..audio import load_audio

        # the reference reads raw int16 samples; load_audio normalizes to
        # [-1, 1], so undo that to keep the same scale
        noise = load_audio(noise) * 32768.0
    return np.asarray(noise, dtype=np.float32)


def add_noise(
    clean_wav: np.ndarray,
    noise_wavs: Sequence,
    noise_snr: Union[int, float, Tuple[int, int]] = 0,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Mix noise into ``clean_wav`` at the given SNR (dB). Returns int16."""
    rng = rng or np.random.default_rng()
    clean_wav = np.asarray(clean_wav, dtype=np.float32)
    noise_wav = select_noise(noise_wavs, rng)

    if isinstance(noise_snr, (int, float)):
        snr = noise_snr
    elif isinstance(noise_snr, tuple):
        snr = int(rng.integers(noise_snr[0], noise_snr[1] + 1))
    else:
        raise TypeError(f"unsupported noise_snr: {noise_snr!r}")

    from .. import native

    if native.AVAILABLE:
        mixed = native.mix_noise(clean_wav, noise_wav, snr)
        if mixed is not None:
            return mixed.astype(np.int16)

    clean_rms = np.sqrt(np.mean(np.square(clean_wav), axis=-1))
    if len(clean_wav) > len(noise_wav):
        ratio = int(np.ceil(len(clean_wav) / len(noise_wav)))
        noise_wav = np.concatenate([noise_wav for _ in range(ratio)])
    if len(clean_wav) < len(noise_wav):
        noise_wav = noise_wav[: len(clean_wav)]
    noise_rms = np.sqrt(np.mean(np.square(noise_wav), axis=-1))
    adjusted_noise_rms = clean_rms / (10 ** (snr / 20))
    mixed = clean_wav + noise_wav * (adjusted_noise_rms / max(noise_rms, 1e-12))

    # avoid clipping outside the int16 range
    max_int16 = np.iinfo(np.int16).max
    min_int16 = np.iinfo(np.int16).min
    if mixed.max(axis=0) > max_int16 or mixed.min(axis=0) < min_int16:
        if mixed.max(axis=0) >= abs(mixed.min(axis=0)):
            reduction_rate = max_int16 / mixed.max(axis=0)
        else:
            reduction_rate = min_int16 / mixed.min(axis=0)
        mixed = mixed * reduction_rate
    return mixed.astype(np.int16)
