"""Build the port's CUDA kernels from ``csrc/`` and load them with ctypes.

Each source ``csrc/<name>.cu`` has a plain C interface and compiles, with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``,
into ``build/wf_torch_kernels/lib<name>-<hash>.so`` beside the package
(the hash is of the source and of every shared header ``csrc/*.cuh``, so
an edited source or header builds anew). Nothing is built when a module is
imported: :func:`load` builds at first use, and :func:`build_all` starts
one ``nvcc`` per source at once; nvcc's output (with ptxas's registers and
spills of each kernel) is kept beside each library, :func:`build_log`. A
failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Sequence

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(CSRC)), "build", "wf_torch_kernels"
)
KERNELS = ("flash64_fwd", "flash64_bwd", "decode_attn", "decode_mlp", "dtw",
           "flash64_fwd_probe", "mma_pair")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str, csrc: Optional[str] = None) -> str:
    csrc = csrc or CSRC
    digest = hashlib.sha256()
    for path in [os.path.join(csrc, f"{name}.cu"), *sorted(glob.glob(os.path.join(csrc, "*.cuh")))]:
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build_all(names: Sequence[str] = KERNELS, csrc: Optional[str] = None) -> List[str]:
    """Build every kernel that is not built yet, with one nvcc per source,
    all started together; returns the libraries' paths. ``csrc`` may be
    another checkout's source directory: the hash names keep its libraries
    apart from this one's."""
    csrc = csrc or CSRC
    targets = [_lib_path(n, csrc) for n in names]
    jobs = []
    for name, target in zip(names, targets):
        if os.path.isfile(target):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(csrc, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, target))
    logs = [proc.communicate()[0] for _, proc, _, _ in jobs]  # wait for every nvcc
    for (name, proc, tmp, target), log in zip(jobs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {os.path.join(csrc, name)}.cu:\n{log}")
        with open(f"{target[:-3]}.log", "w") as f:
            f.write(log)
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    return targets


def build_log(name: str) -> str:
    """nvcc's output for the built library ``name`` ("" if it is not built)."""
    path = f"{_lib_path(name)[:-3]}.log"
    if not os.path.isfile(path):
        return ""
    with open(path) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if it is not there yet."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            (target,) = build_all([name])
            _LIBS[name] = ctypes.CDLL(target)
        return _LIBS[name]


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as a pointer argument."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(dtype: torch.dtype, what: str) -> int:
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {dtype}")
    return DTYPE_CODES[dtype]
