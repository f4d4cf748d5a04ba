"""SpecAugment: frequency and time masking restricted to real (unpadded)
audio frames.

Port of ``whisper_flamingo_tpu/ops/spec_augment.py``, in two forms:

- the host-side numpy version (``PRESETS``, ``freq_mask_np``,
  ``time_mask_np``, ``spec_augment_np``), a copy: masks only touch
  ``[:audio_frames]`` rows, widths drawn as ``randint(0, F)`` /
  ``randint(0, T)`` per mask with the same degenerate-range skips, so the
  same numpy rng gives the same masks; the data pipeline uses it;
- the batched version on the tensor's device (``spec_augment_jax`` there),
  split in two: :func:`spec_augment_draws` draws each row's integers from
  an explicit ``torch.Generator`` over JAX's ranges, and
  :func:`spec_augment_apply` builds the zero-fill mask from them, so given
  the draws that replay JAX's key splits it equals ``spec_augment_jax``
  bit for bit. As in the JAX package, no pipeline calls it.
"""

from __future__ import annotations

import numpy as np
import torch

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


def spec_augment_draws(
    generator: torch.Generator,
    frames: torch.Tensor,
    n_mels: int,
    max_freq_width: int = 27,
    n_freq_mask: int = 2,
    max_time_width: int = 100,
    n_time_mask: int = 2,
) -> torch.Tensor:
    """Each row's mask geometry, drawn on ``frames``' device (``generator``
    must live there): an int64 (B, n_freq_mask + n_time_mask, 3) tensor of
    ``(w, mask_end, start)``, frequency masks first. As in
    ``spec_augment_jax``: ``w`` and ``mask_end`` from ``randint(0, max
    width)``; ``start`` from ``randint(0, max(n_mels - w, 1))`` for a
    frequency mask and ``randint(0, max(frames - w, 1))`` for a time mask,
    whose high differs per row (so it is drawn as ``floor(u * high)`` of a
    uniform ``u``, not from one ``randint`` with a scalar high)."""
    frames = frames.to(torch.int64)
    b, dev = frames.shape[0], frames.device
    widths = []
    for n, max_w in ((n_freq_mask, max_freq_width), (n_time_mask, max_time_width)):
        widths.append(torch.randint(0, max_w, (b, n, 2), generator=generator, device=dev))
    wf, wt = widths
    high = torch.cat([
        torch.clamp(n_mels - wf[..., 0], min=1),
        torch.clamp(frames[:, None] - wt[..., 0], min=1),
    ], dim=1)
    u = torch.rand(high.shape, generator=generator, device=dev, dtype=torch.float64)
    start = torch.minimum((u * high).floor().to(torch.int64), high - 1)
    return torch.cat([torch.cat([wf, wt], dim=1), start[..., None]], dim=-1)


def spec_augment_apply(
    x: torch.Tensor, frames: torch.Tensor, draws: torch.Tensor, n_freq_mask: int = 2
) -> torch.Tensor:
    """Zero-fill SpecAugment of ``x`` (B, time, freq) from ``draws``
    (:func:`spec_augment_draws`' layout) with JAX's gates: a frequency mask
    covers ``[start, start + mask_end)`` on rows ``< frames`` and only when
    ``w > 0``; a time mask covers ``[start, start + mask_end)`` only when
    ``w > 0`` and ``frames - w > 0``. ``frames`` (B,) are the true lengths."""
    b, t, f = x.shape
    dev = x.device
    frames = frames.to(device=dev, dtype=torch.int64).view(b, 1, 1)
    draws = draws.to(dev)
    t_pos = torch.arange(t, device=dev).view(1, t, 1)
    f_pos = torch.arange(f, device=dev).view(1, 1, f)
    mask = torch.zeros((b, t, f), dtype=torch.bool, device=dev)
    for i in range(draws.shape[1]):
        w, width, start = (draws[:, i, k].view(b, 1, 1) for k in range(3))
        if i < n_freq_mask:
            mask |= (w > 0) & (f_pos >= start) & (f_pos < start + width) & (t_pos < frames)
        else:
            valid = (frames - w > 0) & (w > 0)
            mask |= valid & (t_pos >= start) & (t_pos < start + width)
    return torch.where(mask, torch.zeros((), dtype=x.dtype, device=dev), x)


def spec_augment_torch(
    generator: torch.Generator,
    x: torch.Tensor,
    frames: torch.Tensor,
    max_freq_width: int = 27,
    n_freq_mask: int = 2,
    max_time_width: int = 100,
    n_time_mask: int = 2,
) -> torch.Tensor:
    """Batched SpecAugment on ``x``'s device: the draws, then the mask."""
    draws = spec_augment_draws(generator, frames.to(x.device), x.shape[2], max_freq_width,
                               n_freq_mask, max_time_width, n_time_mask)
    return spec_augment_apply(x, frames, draws, n_freq_mask)
