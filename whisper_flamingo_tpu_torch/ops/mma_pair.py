"""The attention matmul pair looped on the tensor cores: the kernel, its
plain version, its launch plan and the helpers of the rate probe.

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
of ``csrc/mma_pair.cu`` for CUDA tensors: a cluster of C CTAs splits the n
columns, each CTA keeps its slices of u and v in shared memory for the
whole launch, and the partial sums of o meet through the cluster's shared
memory. :func:`plan` picks C and the rows per CTA from (rows, n, d); on a
CUDA tensor the wrapper launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_build

ROW_TILE = 64  # rows of w per warpgroup of the kernel (the wgmma M)
# The launches the kernel is built for, by head width: (cluster, rows per
# CTA). A cluster of C CTAs splits n; a CTA takes 1, 2 or 4 warpgroups of
# 64 rows. The first of each width is for rows that fill the card (the most
# warpgroups a CTA, so that one's products hide another's exchange); below
# that, 64 rows a CTA spread the rows over more SMs. At d 128 and n 3072
# only clusters of 16 hold u and v; at d 256, only 16 CTAs of 64 rows.
LAUNCHES = {64: ((4, 256), (8, 64)), 128: ((8, 128), (8, 64), (16, 128)), 256: ((16, 64),)}
SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_MAX = 231424  # dynamic shared memory of a CTA: 227 KB less 1 KB for the static
_ptr = ctypes.c_void_p


class Plan(NamedTuple):
    """A launch of the kernel: ``cluster`` CTAs split n, each CTA takes
    ``rows_per_cta`` rows of w; ``smem`` bytes of shared memory a CTA,
    ``ctas`` CTAs in all."""

    cluster: int
    rows_per_cta: int
    smem: int
    ctas: int


def pair_flops(rows: int, n: int, d: int, iters: int) -> float:
    """Operations of the loop: two products of 2 * rows * n * d per
    iteration."""
    return 4.0 * rows * n * d * iters


def smem_bytes(n: int, d: int, cluster: int, rows_per_cta: int) -> int:
    """``smem_bytes`` of ``csrc/mma_pair.cu``: 1 KB to align, the CTA's
    slices of u and v (its n / cluster columns in 64-wide chunks, d rows of
    128 bytes each), and per warpgroup its o tile (64 x d bf16) and the
    slots of the units of d it owns (cluster x units x 64 rows x 8 fp32)."""
    chunks = -(-(n // cluster) // 64)
    groups = rows_per_cta // ROW_TILE
    units = -(-(d // 8) // cluster)
    return 1024 + 2 * chunks * d * 128 + groups * (d * 128 + cluster * units * 64 * 8 * 4)


def plan(rows: int, n: int, d: int) -> Plan:
    """The kernel's launch for w (rows, n) at head width d: of the
    :data:`LAUNCHES` of width d whose slices are whole 32-column halves and
    whose CTA fits :data:`SMEM_MAX`, the first, if its CTAs cover the card's
    SMs, else the first with the most CTAs. Raises ValueError for what the
    kernel cannot take."""
    if d not in LAUNCHES or rows <= 0 or rows % ROW_TILE or n <= 0:
        raise ValueError(f"mma_pair: the kernel takes d in {tuple(LAUNCHES)} and rows a positive "
                         f"multiple of {ROW_TILE}; got d {d}, rows {rows}, n {n}")
    options = [Plan(c, m, smem_bytes(n, d, c, m), -(-rows // m) * c) for c, m in LAUNCHES[d]
               if n % c == 0 and (n // c) % 32 == 0 and smem_bytes(n, d, c, m) <= SMEM_MAX]
    if not options:
        raise ValueError(f"mma_pair: no launch of the kernel takes n {n} at d {d}: n / cluster "
                         f"must be a multiple of 32 and a CTA's shared memory at most {SMEM_MAX}")
    if options[0].ctas >= SMS:
        return options[0]
    return max(options, key=lambda p: p.ctas)


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
    lib = cuda_build.load("mma_pair")
    if lib.wf_mma_pair.argtypes is None:
        lib.wf_mma_pair.restype = ctypes.c_int
        lib.wf_mma_pair.argtypes = [_ptr] * 4 + [ctypes.c_int] * 6 + [_ptr]
        lib.wf_mma_pair_max_clusters.restype = ctypes.c_int
        lib.wf_mma_pair_max_clusters.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    return lib


def max_active_clusters(rows: int, n: int, d: int) -> int:
    """How many clusters of :func:`plan`'s launch the card holds at once
    (``cudaOccupancyMaxActiveClusters``; needs a card)."""
    p = plan(rows, n, d)
    count = ctypes.c_int(0)
    cuda_build.check(_lib().wf_mma_pair_max_clusters(rows, n, d, p.cluster, p.rows_per_cta,
                                                     ctypes.byref(count)), "mma_pair occupancy")
    return count.value


def check_operands(w: torch.Tensor, v: torch.Tensor, u: torch.Tensor, iters: int) -> Plan:
    """Every check of the kernel's operands (shapes, dtype, device,
    contiguity, 16-byte alignment, iters) and the plan; raises on what the
    kernel cannot take, before anything is built."""
    rows, n = w.shape
    d = v.shape[1]
    if v.shape != (n, d) or u.shape != (d, n):
        raise ValueError(f"pair_chain: shapes w {tuple(w.shape)}, v {tuple(v.shape)}, "
                         f"u {tuple(u.shape)} do not chain")
    if not (w.dtype == v.dtype == u.dtype == torch.bfloat16):
        raise TypeError("pair_chain: the kernel takes bfloat16 operands")
    if not (w.device == v.device == u.device):
        raise ValueError("pair_chain: w, v and u must be on one device")
    if not (w.is_contiguous() and v.is_contiguous() and u.is_contiguous()):
        raise ValueError("pair_chain: w, v and u must be contiguous")
    if any(x.data_ptr() % 16 for x in (w, v, u)):
        raise ValueError("pair_chain: w, v and u must be 16-byte aligned")
    if iters < 1:
        raise ValueError(f"pair_chain: iters must be >= 1, got {iters}")
    return plan(rows, n, d)


def pair_chain(w: torch.Tensor, v: torch.Tensor, u: torch.Tensor, iters: int) -> torch.Tensor:
    """w (R, n), v (n, d), u (d, n) -> w after ``iters`` iterations of the
    pair (the plain version for CPU tensors, the kernel for CUDA ones, in
    :func:`plan`'s launch)."""
    if w.device.type == "cpu":
        return pair_chain_plain(w, v, u, iters)
    if w.device.type != "cuda":
        raise RuntimeError(f"pair_chain: no kernel for device {w.device}")
    p = check_operands(w, v, u, iters)
    rows, n = w.shape
    out = torch.empty_like(w)
    err = _lib().wf_mma_pair(w.data_ptr(), v.data_ptr(), u.data_ptr(), out.data_ptr(), rows, n,
                             v.shape[1], iters, p.cluster, p.rows_per_cta,
                             cuda_build.stream_ptr(w))
    cuda_build.check(err, "pair_chain")
    pair_chain.launches += 1
    return out


pair_chain.launches = 0
