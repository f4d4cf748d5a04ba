"""SpecAugment: frequency and time masking restricted to real (unpadded)
audio frames, on the host in numpy.

Copy of the numpy half of ``whisper_flamingo_tpu/ops/spec_augment.py``
(``PRESETS``, ``freq_mask_np``, ``time_mask_np``, ``spec_augment_np``):
masks only touch ``[:audio_frames]`` rows, widths drawn as
``randint(0, F)`` / ``randint(0, T)`` per mask with the same
degenerate-range skips, so the same numpy rng gives the same masks.
``spec_augment_jax``, the batched on-device version the JAX package kept
to hold augmentation on the TPU, is not ported.
"""

from __future__ import annotations

import numpy as np

PRESETS = {
    "ls-double": dict(n_freq_mask=2, n_time_mask=2, max_freq_width=27, max_time_width=100),
    "ls-basic": dict(n_freq_mask=1, n_time_mask=1, max_freq_width=27, max_time_width=100),
}


def freq_mask_np(x, audio_frames, F=30, n_mask=2, replace_with_zero=True, rng=None):
    """x: (time, freq) numpy array; masks only the first ``audio_frames`` rows."""
    rng = rng or np.random.default_rng()
    cloned = x.copy()
    num_mel_channels = cloned.shape[1]
    fs = rng.integers(0, F, size=(n_mask, 2))
    for f, mask_end in fs:
        f_zero = int(rng.integers(0, num_mel_channels - f)) if num_mel_channels - f > 0 else 0
        if f_zero == f_zero + f:
            continue
        mask_end = int(mask_end) + f_zero
        fill = 0 if replace_with_zero else cloned.mean()
        cloned[:audio_frames, f_zero:mask_end] = fill
    return cloned


def time_mask_np(spec, audio_frames, T=40, n_mask=2, replace_with_zero=True, rng=None):
    rng = rng or np.random.default_rng()
    cloned = spec.copy()
    len_spectro = audio_frames
    ts = rng.integers(0, T, size=(n_mask, 2))
    for t, mask_end in ts:
        if len_spectro - t <= 0:
            continue
        t_zero = int(rng.integers(0, len_spectro - t))
        if t_zero == t_zero + t:
            continue
        mask_end = int(mask_end) + t_zero
        fill = 0 if replace_with_zero else cloned.mean()
        cloned[t_zero:mask_end] = fill
    return cloned


def spec_augment_np(
    x: np.ndarray,
    audio_frames: int,
    max_freq_width: int = 27,
    n_freq_mask: int = 2,
    max_time_width: int = 100,
    n_time_mask: int = 2,
    replace_with_zero: bool = True,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Host-side SpecAugment over (time, freq), time-warp removed as in
    the reference."""
    assert x.ndim == 2
    rng = rng or np.random.default_rng()
    x = freq_mask_np(x, audio_frames, max_freq_width, n_freq_mask,
                     replace_with_zero=replace_with_zero, rng=rng)
    x = time_mask_np(x, audio_frames, max_time_width, n_time_mask,
                     replace_with_zero=replace_with_zero, rng=rng)
    return x
