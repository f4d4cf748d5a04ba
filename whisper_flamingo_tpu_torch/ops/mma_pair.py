"""The attention matmul pair looped on the tensor cores: the kernel, its
plain version and the helpers of the rate probe.

Port of the kernel of ``tools/packed_probe2.py`` (``make_kernel`` /
``kernel``), the JAX package's probe of the matrix unit's rate at flash
attention's tile shapes. The function, ``iters`` times over w (R, n)::

    o = bf16(0.01 * (w @ v))    # v (n, d), fp32 sum
    w = bf16(0.01 * (o @ u))    # u (d, n), fp32 sum

returns the last w. It is the probe's, with R free: the probe's R is 512
(its q tile); the kernel takes any multiple of :data:`ROW_TILE` (the rows
are independent), so a larger R fills the card.

At the probe's scales (w ~ N(0, 1), v and u ~ 0.1 N(0, 1)) w shrinks
about 10^3-fold per iteration, so after a dozen or so iterations every
operand is zero: a long run measures the rate on zero operands.
:func:`first_zero_iteration` finds the iteration.

:func:`pair_chain` runs the plain version for CPU tensors and the kernel
of ``csrc/mma_pair.cu`` (bf16, d in 64 / 128 / 256, n a multiple of 64)
for CUDA tensors; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

ROW_TILE = 128  # rows of w per block of the kernel
N_TILE = 64  # columns of n per shared-memory tile
HEAD_WIDTHS = (64, 128, 256)
_ptr = ctypes.c_void_p


def pair_flops(rows: int, n: int, d: int, iters: int) -> float:
    """Operations of the loop: two products of 2 * rows * n * d per
    iteration."""
    return 4.0 * rows * n * d * iters


def pair_chain_plain(w: torch.Tensor, v: torch.Tensor, u: torch.Tensor, iters: int) -> torch.Tensor:
    """The loop in plain PyTorch: fp32 products of the operands, the 0.01
    scale in fp32, and the cast to w's dtype after each product."""
    dt = w.dtype
    v32, u32 = v.float(), u.float()
    for _ in range(iters):
        o = (torch.matmul(w.float(), v32) * 0.01).to(dt)
        w = (torch.matmul(o.float(), u32) * 0.01).to(dt)
    return w


def first_zero_iteration(w: torch.Tensor, v: torch.Tensor, u: torch.Tensor, max_iters: int,
                         chain=pair_chain_plain):
    """The first iteration count after which ``chain`` leaves w all zero,
    or None within ``max_iters``."""
    for i in range(1, max_iters + 1):
        w = chain(w, v, u, 1)
        if not bool(w.any()):
            return i
    return None


def _lib():
    fn = cuda_build.load("mma_pair").wf_mma_pair
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [_ptr] * 4 + [ctypes.c_int] * 4 + [_ptr]
    return fn


def pair_chain(w: torch.Tensor, v: torch.Tensor, u: torch.Tensor, iters: int) -> torch.Tensor:
    """w (R, n), v (n, d), u (d, n) -> w after ``iters`` iterations of the
    pair (the plain version for CPU tensors, the kernel for CUDA ones)."""
    if w.device.type == "cpu":
        return pair_chain_plain(w, v, u, iters)
    if w.device.type != "cuda":
        raise RuntimeError(f"pair_chain: no kernel for device {w.device}")
    rows, n = w.shape
    d = v.shape[1]
    if v.shape != (n, d) or u.shape != (d, n):
        raise ValueError(f"pair_chain: shapes w {tuple(w.shape)}, v {tuple(v.shape)}, "
                         f"u {tuple(u.shape)} do not chain")
    if d not in HEAD_WIDTHS or n % N_TILE or rows % ROW_TILE or iters < 1:
        raise ValueError(f"pair_chain: the kernel takes d in {HEAD_WIDTHS}, n a multiple of "
                         f"{N_TILE}, rows a multiple of {ROW_TILE} and iters >= 1; got d {d}, "
                         f"n {n}, rows {rows}, iters {iters}")
    if not (w.dtype == v.dtype == u.dtype == torch.bfloat16):
        raise TypeError("pair_chain: the kernel takes bfloat16 operands")
    if not (w.device == v.device == u.device):
        raise ValueError("pair_chain: w, v and u must be on one device")
    if not (w.is_contiguous() and v.is_contiguous() and u.is_contiguous()):
        raise ValueError("pair_chain: w, v and u must be contiguous")
    out = torch.empty_like(w)
    err = _lib()(w.data_ptr(), v.data_ptr(), u.data_ptr(), out.data_ptr(), rows, n, d, iters,
                 cuda_build.stream_ptr(w))
    cuda_build.check(err, "pair_chain")
    pair_chain.launches += 1
    return out


pair_chain.launches = 0
