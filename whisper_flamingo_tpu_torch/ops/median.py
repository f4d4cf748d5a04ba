"""Median filter along the last axis, in plain PyTorch.

Port of ``whisper_flamingo_tpu/ops/median.py`` (which the JAX package
computes outside Pallas): reflect-pad by half the width, unfold the
sliding windows, sort each window and take the middle value. An input no
wider than half the filter width passes through unfiltered, as in the
reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def median_filter(x: torch.Tensor, filter_width: int) -> torch.Tensor:
    """Median filter of odd width along the last axis (any leading dims)."""
    assert filter_width > 0 and filter_width % 2 == 1, "`filter_width` should be an odd number"
    pad_width = filter_width // 2
    if x.shape[-1] <= pad_width:
        return x
    lead = x.shape[:-1]
    flat = x.reshape(-1, 1, x.shape[-1])  # F.pad's reflect mode wants (N, C, W)
    padded = F.pad(flat, (pad_width, pad_width), mode="reflect").reshape(*lead, -1)
    windows = padded.unfold(-1, filter_width, 1)  # (..., W, filter_width)
    return windows.sort(dim=-1).values[..., pad_width]
