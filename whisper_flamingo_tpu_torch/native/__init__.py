"""Native (C) host helpers: the port's copy of the JAX package's
``native/`` (``wf_mix_noise``, ``wf_resample_linear``, ``wf_edit_distance``
in ``wf_native.c``, with the same ctypes signatures).

Nothing is built when this module is imported. The first use (a helper
call, or reading ``AVAILABLE``) compiles ``wf_native.c`` with ``cc -O3
-shared -fPIC`` into ``build/wf_torch_native/`` beside the package (the
name hashes the source) and loads it. The JAX package's rule holds: the C
path when the library builds, the numpy path otherwise; ``AVAILABLE``
says which, and each helper returns ``None`` when it is not available.
This is the reference's semantics (its ``add_noise`` mixes in double
precision through the helper wherever a compiler exists), not a fallback
of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "wf_native.c")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(SRC))), "build", "wf_torch_native"
)

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()


def lib_path() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"wf_native_{digest}.so")


def _build_and_load() -> Optional[ctypes.CDLL]:
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        return None
    target = lib_path()
    if not os.path.exists(target):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{target}.{os.getpid()}.tmp"
        try:
            subprocess.run([cc, "-O3", "-shared", "-fPIC", "-o", tmp, SRC, "-lm"],
                           check=True, capture_output=True)
            os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
        except (subprocess.CalledProcessError, OSError):
            if os.path.exists(tmp):
                os.unlink(tmp)
            return None
    try:
        lib = ctypes.CDLL(target)
    except OSError:
        return None

    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.wf_mix_noise.argtypes = [f32p, ctypes.c_int64, f32p, ctypes.c_int64, ctypes.c_double, f32p]
    lib.wf_mix_noise.restype = ctypes.c_int
    lib.wf_resample_linear.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_double, f32p, ctypes.c_int64, ctypes.c_double
    ]
    lib.wf_resample_linear.restype = ctypes.c_int
    lib.wf_edit_distance.argtypes = [i64p, ctypes.c_int64, i64p, ctypes.c_int64]
    lib.wf_edit_distance.restype = ctypes.c_int64
    return lib


def _lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call (``None`` when no
    compiler builds it)."""
    global _LIB, _TRIED
    if not _TRIED:
        with _LOCK:
            if not _TRIED:
                _LIB = _build_and_load()
                _TRIED = True
    return _LIB


def __getattr__(name: str):
    if name == "AVAILABLE":  # builds on first read, as JAX's builds on import
        return _lib() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def mix_noise(clean: np.ndarray, noise: np.ndarray, snr_db: float) -> Optional[np.ndarray]:
    """RMS-matched SNR mix (int16-valued float output); None if unavailable."""
    lib = _lib()
    if lib is None:
        return None
    clean = np.ascontiguousarray(clean, np.float32)
    noise = np.ascontiguousarray(noise, np.float32)
    out = np.empty_like(clean)
    rc = lib.wf_mix_noise(clean, clean.shape[0], noise, noise.shape[0], float(snr_db), out)
    return out if rc == 0 else None


def resample_linear(x: np.ndarray, orig_sr: float, target_sr: float) -> Optional[np.ndarray]:
    lib = _lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    n_out = int(round(x.shape[0] / orig_sr * target_sr))
    out = np.empty((n_out,), np.float32)
    rc = lib.wf_resample_linear(x, x.shape[0], float(orig_sr), out, n_out, float(target_sr))
    return out if rc == 0 else None


def edit_distance(a: np.ndarray, b: np.ndarray) -> Optional[int]:
    lib = _lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, np.int64)
    b = np.ascontiguousarray(b, np.int64)
    result = lib.wf_edit_distance(a, a.shape[0], b, b.shape[0])
    return int(result) if result >= 0 else None
