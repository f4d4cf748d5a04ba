"""Checkpoint lookup and the published per-model word-alignment heads.

Port of the part of ``whisper_flamingo_tpu/registry.py`` the decode path
uses. The alignment-head bitmaps are OpenAI's public data: base85-encoded
gzipped boolean arrays of shape (n_text_layer, n_text_head).

There is no download: :func:`checkpoint_path` finds ``<name>.pt`` in an
explicit ``download_root`` only, and ``load_model`` warns and falls back
to random weights when it is not there.
"""

from __future__ import annotations

import base64
import gzip
import os
from typing import Optional

import numpy as np

ALIGNMENT_HEADS = {
    "tiny.en": b"ABzY8J1N>@0{>%R00Bk>$p{7v037`oCl~+#00",
    "tiny": b"ABzY8bu8Lr0{>%RKn9Fp%m@SkK7Kt=7ytkO",
    "base.en": b"ABzY8;40c<0{>%RzzG;p*o+Vo09|#PsxSZm00",
    "base": b"ABzY8KQ!870{>%RzyTQH3`Q^yNP!>##QT-<FaQ7m",
    "small.en": b"ABzY8>?_)10{>%RpeA61k&I|OI3I$65C{;;pbCHh0B{qLQ;+}v00",
    "small": b"ABzY8DmU6=0{>%Rpa?J`kvJ6qF(V^F86#Xh7JUGMK}P<N0000",
    "medium.en": b"ABzY8usPae0{>%R7<zz_OvQ{)4kMa0BMw6u5rT}kRKX;$NfYBv00*Hl@qhsU00",
    "medium": b"ABzY8B0Jh+0{>%R7}kK1fFL7w6%<-Pf*t^=N)Qr&0RR9",
    "large-v1": b"ABzY8r9j$a0{>%R7#4sLmoOs{s)o3~84-RPdcFk!JR<kSfC2yj",
    "large-v2": b"ABzY8zd+h!0{>%R7=D0pU<_bnWW*tkYAhobTNnu$jnkEkXqp)j;w1Tzk)UH3X%SZd&fFZ2fC2yj",
    "large-v3": b"ABzY8gWO1E0{>%R7(9S+Kn!D~%ngiGaR?*L!iJG9p-nab0JQ=-{D1-g00",
    "large": b"ABzY8gWO1E0{>%R7(9S+Kn!D~%ngiGaR?*L!iJG9p-nab0JQ=-{D1-g00",
}


def decode_alignment_heads(dump: bytes, n_text_layer: int, n_text_head: int) -> np.ndarray:
    """base85 -> gzip -> bool bitmap of shape (n_text_layer, n_text_head)."""
    array = np.frombuffer(gzip.decompress(base64.b85decode(dump)), dtype=bool).copy()
    return array.reshape(n_text_layer, n_text_head)


def alignment_heads_for(name: str, n_text_layer: int, n_text_head: int) -> Optional[np.ndarray]:
    if name in ALIGNMENT_HEADS:
        return decode_alignment_heads(ALIGNMENT_HEADS[name], n_text_layer, n_text_head)
    return None


def checkpoint_path(name: str, download_root: Optional[str]) -> Optional[str]:
    """``<download_root>/<name>.pt`` if that file exists, else None."""
    if not download_root:
        return None
    candidate = os.path.join(download_root, f"{name}.pt")
    return candidate if os.path.isfile(candidate) else None
