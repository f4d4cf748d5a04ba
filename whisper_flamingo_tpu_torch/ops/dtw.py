"""Dynamic time warping for word-timestamp alignment: the CUDA wavefront
kernel, its plain version and the host backtrace.

Port of ``whisper_flamingo_tpu/ops/dtw.py`` and of the Pallas kernel
``ops/dtw_pallas.py``. The DP is the reference's (``dtw_np``): the cost
and the trace follow the same tie cascade, the propagated cost included
(on the tie c0 == c1 < c2 it carries c2, not min()), and each cell is one
fp32 add, so the kernel, the plain version and the numpy DP give the same
trace bit for bit.

- :func:`dtw_trace` fills the (N+1, M+1) int8 trace matrix: the kernel
  (``csrc/dtw.cu``) for a CUDA tensor, :func:`dtw_trace_plain` for a CPU
  tensor. The kernel is a wavefront bound by its chain of N + M dependent
  diagonals: one row per lane, the lanes skewed by a column, each taking
  the cost above from the lane before with a shuffle, warps chained
  through a shared ring; x is read into registers a block of 16 steps
  ahead, the trace leaves in 16-byte spans. :func:`chain_floor_ns` times
  the dependent step alone;
- :func:`backtrace_np` walks it back on the host (sequential, O(N+M));
- :func:`dtw` is the path: an empty matrix gives ``zeros((2, 0))``, a CPU
  tensor or a numpy array the plain version, a CUDA tensor the kernel, at
  any size.

Left out: the skewed (N+M, n_pad) input layout and the 8-diagonal grid
tiles of the Pallas kernel (TPU layout; the kernel writes the trace in
place), the ``lax.scan`` wavefront, and the dispatch of small inputs to
the numpy DP and of Pallas failures to the scan (on the card every input
goes to the kernel, which launches or raises). :func:`dtw_np` stays as
the test oracle.
"""

from __future__ import annotations

import ctypes
from typing import Union

import numpy as np
import torch

from . import cuda_build

INF = np.float32(np.inf)
MAX_ROWS = 1024  # N + 1 rows of the trace: one thread per row, one block


def backtrace_np(trace: np.ndarray) -> np.ndarray:
    """Walk the trace matrix back from (N, M); (2, path length) indices."""
    i = trace.shape[0] - 1
    j = trace.shape[1] - 1
    trace = trace.copy()
    trace[0, :] = 2
    trace[:, 0] = 1

    result = []
    while i > 0 or j > 0:
        result.append((i - 1, j - 1))
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        elif t == 2:
            j -= 1
        else:
            raise ValueError("Unexpected trace[i, j]")
    result = np.array(result)
    return result[::-1, :].T


def dtw_np(x: np.ndarray) -> np.ndarray:
    """The reference DP on the host, cell by cell: the test oracle."""
    n, m = x.shape
    cost = np.full((n + 1, m + 1), INF, np.float32)
    trace = -np.ones((n + 1, m + 1), np.float32)
    cost[0, 0] = 0.0
    for j in range(1, m + 1):
        for i in range(1, n + 1):
            c0 = cost[i - 1, j - 1]
            c1 = cost[i - 1, j]
            c2 = cost[i, j - 1]
            if c0 < c1 and c0 < c2:
                c, t = c0, 0
            elif c1 < c0 and c1 < c2:
                c, t = c1, 1
            else:
                c, t = c2, 2
            cost[i, j] = x[i - 1, j - 1] + c
            trace[i, j] = t
    return backtrace_np(trace)


def dtw_trace_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a loop over the diagonals
    d = 1 .. N+M of vector ops on the row axis i in [0, N] (cell
    (i, d - i)); returns the (N+1, M+1) int8 trace, -1 off the DP."""
    n, m = x.shape
    dev = x.device
    x = x.float()
    i_idx = torch.arange(n + 1, device=dev)
    d_idx = torch.arange(1, n + m + 1, device=dev)[:, None]
    j_idx = d_idx - i_idx  # (N+M, N+1)
    valid = (i_idx >= 1) & (j_idx >= 1) & (j_idx <= m)
    # the input skewed so that diagonal d is row d-1: x[i-1, d-i-1]
    flat = ((i_idx - 1).clamp(0, n - 1) * m + (j_idx - 1).clamp(0, m - 1))
    x_skew = x.reshape(-1)[flat]

    inf = torch.full((1,), float("inf"), device=dev)
    prev2 = torch.full((n + 1,), float("inf"), device=dev)  # diagonal d-2
    prev1 = prev2.clone()
    prev1[0] = 0.0  # diagonal 0: cost[0, 0]
    t_skew = torch.empty((n + m, n + 1), dtype=torch.int8, device=dev)
    for d in range(n + m):
        c0 = torch.cat([inf, prev2[:-1]])  # cost[i-1, j-1]
        c1 = torch.cat([inf, prev1[:-1]])  # cost[i-1, j]
        c2 = prev1  # cost[i, j-1]
        is0 = (c0 < c1) & (c0 < c2)
        is1 = ~is0 & (c1 < c0) & (c1 < c2)
        c = torch.where(is0, c0, torch.where(is1, c1, c2))
        t_skew[d] = torch.where(is0, 0, torch.where(is1, 1, 2))
        cur = torch.where(valid[d], x_skew[d] + c, inf)
        prev2, prev1 = prev1, cur

    trace = torch.full((n + 1, m + 1), -1, dtype=torch.int8, device=dev)
    trace.view(-1)[(i_idx * (m + 1) + j_idx)[valid]] = t_skew[valid]
    return trace


def _lib():
    lib = cuda_build.load("dtw")
    if lib.wf_dtw_trace.argtypes is None:
        lib.wf_dtw_trace.restype = ctypes.c_int
        lib.wf_dtw_trace.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
        lib.wf_dtw_chain_floor.restype = ctypes.c_int
        lib.wf_dtw_chain_floor.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return lib


def dtw_trace(x: torch.Tensor) -> torch.Tensor:
    """(N, M) fp32 cost -> (N+1, M+1) int8 trace on ``x``'s device.

    A CPU tensor takes :func:`dtw_trace_plain`; a CUDA tensor, which must
    be contiguous fp32 with 1 <= N <= 1023 and M >= 1, launches the kernel
    on the current stream or raises."""
    if x.device.type == "cpu":
        return dtw_trace_plain(x)
    if x.device.type != "cuda":
        raise RuntimeError(f"dtw_trace: no kernel for device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"dtw_trace takes an (N, M) matrix, got shape {tuple(x.shape)}")
    n, m = x.shape
    if n + 1 > MAX_ROWS or n < 1 or m < 1:
        raise ValueError(f"dtw_trace: N + 1 must be in [2, {MAX_ROWS}] and M >= 1, got {(n, m)}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("dtw_trace: the cost must be a contiguous float32 tensor")
    trace = torch.empty((n + 1, m + 1), dtype=torch.int8, device=x.device)
    err = _lib().wf_dtw_trace(x.data_ptr(), trace.data_ptr(), n, m, cuda_build.stream_ptr(x))
    cuda_build.check(err, "dtw_trace")
    dtw_trace.launches += 1
    return trace


def chain_floor_ns(iters: int = 100_000) -> float:
    """Device ns per dependent step of the wavefront alone (one warp: the
    shuffle, the cascade and the add, ``iters`` times), from CUDA events
    around one launch after a warm-up; needs a card."""
    lib = _lib()
    out = torch.empty(32, device="cuda")
    stream = cuda_build.stream_ptr(out)
    cuda_build.check(lib.wf_dtw_chain_floor(out.data_ptr(), 1000, stream), "dtw_chain_floor")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    cuda_build.check(lib.wf_dtw_chain_floor(out.data_ptr(), iters, stream), "dtw_chain_floor")
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e6 / iters


dtw_trace.launches = 0


def dtw(x: Union[np.ndarray, torch.Tensor]) -> np.ndarray:
    """Monotonic alignment path (2, path length) for an (N_text, M_frames)
    cost matrix: the trace on ``x``'s device (a numpy array on the CPU),
    the backtrace on the host."""
    if min(x.shape) == 0:
        return np.zeros((2, 0), np.int64)
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return backtrace_np(dtw_trace(x).cpu().numpy())
