"""Small shared helpers: the part of ``whisper_flamingo_tpu/utils.py`` the
decode path needs, and the port's device rule."""

from __future__ import annotations

import zlib
from typing import Optional, Union

import torch


def compression_ratio(text: str) -> float:
    """gzip repetition proxy: UTF-8 bytes over compressed bytes."""
    text_bytes = text.encode("utf-8")
    return len(text_bytes) / len(zlib.compress(text_bytes))


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. With no card and no device named this raises; the port never
    carries on silently on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
