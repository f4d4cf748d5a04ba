"""Two forward variants of the d_head-64 encoder attention: the kernels,
their plain versions, and the per-head key-norm bound one of them reads.

Port of the kernel bodies of ``tools/flash64_fwd_probe.py``, the JAX
package's probe of three ways to form the softmax of the flash64 forward
(primal only, no lse):

- "shipped" (max, exp, row sum) is :func:`.flash64.flash64_forward`;
  there is no third kernel for it here.
- "augv" (``fwd_augv``): the row sum comes out of the P·V product through a
  ones column appended to V, so o and l are the sums of the same rounded
  probabilities.
- "csbound + augv" (``fwd_csbound_augv``): the row max is replaced by the
  Cauchy-Schwarz bound ``|q_i|_2 * max_j |k_j|_2``, so exp(s - bound) <= 1
  with no max pass and, in a tiled kernel, no rescale of the accumulator.
  A row whose scores all lie more than ~87 below its bound underflows to
  l = 0 and comes out non-finite, in the JAX math as here.

Contract as the probe's: q, k, v are (..., T, 64), q and k already scaled;
the scores are fp32; the probabilities are rounded to the input dtype
before the V product; o and l come from one fp32 product with the
ones-augmented V; the output is (o / l) in the input dtype. ``kmax`` (the
largest fp32 norm of a key row, one per (batch, head)) is plain tensor
code beside the kernel, as the probe left it to XLA (``make_variant``).

Left out, TPU artefacts: the padding of T to a multiple of 512 (the
kernels mask the ragged edge) and the ``chained`` scan the probe timed
through (the card is timed with CUDA events).

The wrappers run the plain versions for CPU tensors and the kernels of
``csrc/flash64_fwd_probe.cu`` (bf16 only) for CUDA tensors; on a CUDA
tensor they launch the kernel or raise. The kernels run the shipped
forward's frame (``csrc/flash64_fwd_frame.cuh``) with their own softmax,
so a timing against :func:`.flash64.flash64_forward` measures the
softmax alone; csbound's call also runs :func:`key_norm_max` first.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build

D_HEAD = 64
_ptr = ctypes.c_void_p
_VARIANT = {"augv": 0, "csbound": 1}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def key_norm_max(k: torch.Tensor) -> torch.Tensor:
    """max_j |k_j|_2 in fp32 over the key rows: (..., T, 64) -> (...). One
    reduction that reads K once, casting inside (no fp32 copy of K), then
    the max over the (..., T) norms."""
    return torch.linalg.vector_norm(k, dim=-1, dtype=torch.float32).amax(dim=-1)


def _augmented_product(e: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """fp32 (..., T, T) probabilities already rounded to v's dtype, times
    [V | 1]: the (..., T, 64) output sum and the row sum, then o / l in v's
    dtype."""
    ones = torch.ones(v.shape[:-1] + (1,), dtype=torch.float32, device=v.device)
    ol = torch.matmul(e, torch.cat([v.float(), ones], dim=-1))
    return (ol[..., :D_HEAD] / ol[..., D_HEAD:]).to(v.dtype)


def flash64_fwd_augv_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``fwd_augv`` in plain PyTorch: row max, exp, and the row sum from the
    ones-augmented V product."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return _augmented_product(e.to(v.dtype).float(), v)


def flash64_fwd_csbound_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              kmax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``fwd_csbound_augv`` in plain PyTorch: exp(s - |q_i| * kmax) with no
    row max, and the row sum from the ones-augmented V product; ``kmax``
    is :func:`key_norm_max` of k unless given."""
    if kmax is None:
        kmax = key_norm_max(k)
    bound = q.float().pow(2).sum(dim=-1, keepdim=True).sqrt() * kmax[..., None, None]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    e = torch.exp(s - bound)
    return _augmented_product(e.to(v.dtype).float(), v)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _lib():
    fn = cuda_build.load("flash64_fwd_probe").wf_flash64_fwd_probe
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [_ptr] * 5 + [ctypes.c_int] * 3 + [_ptr]
    return fn


def _launch(variant: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            kmax: Optional[torch.Tensor] = None) -> torch.Tensor:
    what = f"flash64_fwd_{variant}"
    if q.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {q.device}")
    if q.dim() < 3 or q.shape[-1] != D_HEAD:
        raise ValueError(f"{what} takes (..., T, 64), got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: q, k and v must have one shape")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"{what}: the kernel takes bfloat16 q, k and v")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{what}: q, k and v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what}: q, k and v must be contiguous")
    t = q.shape[-2]
    heads = q.numel() // (t * D_HEAD)
    if heads > 65535:
        raise ValueError(f"{what}: more than 65535 (batch, head) pairs")
    if variant == "csbound":
        kmax = (key_norm_max(k) if kmax is None else kmax).float().contiguous()
        if kmax.numel() != heads or kmax.device != q.device:
            raise ValueError(f"{what}: kmax must hold one value per (batch, head)")
    out = torch.empty_like(q)
    err = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if kmax is None else kmax.data_ptr(), out.data_ptr(),
        heads, t, _VARIANT[variant], cuda_build.stream_ptr(q),
    )
    cuda_build.check(err, what)
    return out


def flash64_fwd_augv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., T, 64) pre-scaled q/k/v -> the attention output, the row sum
    taken from the ones-augmented V product."""
    if q.device.type == "cpu":
        return flash64_fwd_augv_plain(q, k, v)
    out = _launch("augv", q, k, v)
    flash64_fwd_augv.launches += 1
    return out


flash64_fwd_augv.launches = 0


def flash64_fwd_csbound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kmax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., T, 64) pre-scaled q/k/v -> the attention output with the
    Cauchy-Schwarz bound in place of the row max (rows may come out
    non-finite where the bound is ~87 above every score, as in JAX).
    ``kmax`` ((...) fp32, :func:`key_norm_max` of k) is computed here
    unless given, as when the kernel is timed alone."""
    if q.device.type == "cpu":
        return flash64_fwd_csbound_plain(q, k, v, kmax)
    out = _launch("csbound", q, k, v, kmax)
    flash64_fwd_csbound.launches += 1
    return out


flash64_fwd_csbound.launches = 0
