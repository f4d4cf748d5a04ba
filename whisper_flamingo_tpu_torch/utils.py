"""Small shared helpers: a copy of ``whisper_flamingo_tpu/utils.py`` (the
CLI's argument parsers, ``compression_ratio``, the timestamp format) and
the port's device rule."""

from __future__ import annotations

import sys
import zlib
from typing import Optional, Union

import torch


def exact_div(x: int, y: int) -> int:
    assert x % y == 0
    return x // y


def str2bool(string: str) -> bool:
    str2val = {"True": True, "False": False}
    if string in str2val:
        return str2val[string]
    raise ValueError(f"Expected one of {set(str2val.keys())}, got {string}")


def optional_int(string: str) -> Optional[int]:
    return None if string == "None" else int(string)


def optional_float(string: str) -> Optional[float]:
    return None if string == "None" else float(string)


def optional_str(string: str) -> Optional[str]:
    return None if string == "None" else string


def compression_ratio(text: str) -> float:
    """gzip repetition proxy: UTF-8 bytes over compressed bytes."""
    text_bytes = text.encode("utf-8")
    return len(text_bytes) / len(zlib.compress(text_bytes))


def format_timestamp(
    seconds: float, always_include_hours: bool = False, decimal_marker: str = "."
) -> str:
    assert seconds >= 0, "non-negative timestamp expected"
    milliseconds = round(seconds * 1000.0)

    hours = milliseconds // 3_600_000
    milliseconds -= hours * 3_600_000
    minutes = milliseconds // 60_000
    milliseconds -= minutes * 60_000
    secs = milliseconds // 1_000
    milliseconds -= secs * 1_000

    hours_marker = f"{hours:02d}:" if always_include_hours or hours > 0 else ""
    return f"{hours_marker}{minutes:02d}:{secs:02d}{decimal_marker}{milliseconds:03d}"


def make_safe(string: str) -> str:
    """Replace characters the system encoding can't represent."""
    system_encoding = sys.getdefaultencoding()
    if system_encoding != "utf-8":
        return string.encode(system_encoding, errors="replace").decode(system_encoding)
    return string


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. With no card, a device that is not named or is a CUDA device
    raises; the port never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
