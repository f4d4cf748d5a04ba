"""Encoder self-attention at d_head 64: the CUDA kernel and its plain version.

Port of ``whisper_flamingo_tpu/ops/flash64.py`` (the forward,
``_fwd_kernel`` through ``_flash64_forward``). Contract as there: q/k/v are
(B, H, T, 64) with q and k pre-scaled by d_head^-0.25 by the caller; the
attention is non-causal with no mask; the softmax is fp32, the
probabilities are cast to the input dtype before the V product, and the
output has the input dtype.

Left out, each a TPU workaround: the padding of T to a multiple of 512
(the kernel masks the ragged edge itself), the ones-column row sum, and
the whole-row resident K/V (the kernel tiles K/V with an online softmax;
bf16 runs on the tensor cores, fp32 on FMA without TF32; see
``csrc/flash64_fwd.cu`` for the design and what bounds it). The
``with_lse`` forward and the backward kernel belong to the training
slice.

:func:`flash64_attention` runs :func:`flash64_attention_plain` for CPU
tensors and the kernel for CUDA tensors; on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

D_HEAD = 64
_c_i64 = ctypes.c_int64


def flash64_attention_plain(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch (whole-row fp32 softmax)."""
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(e.to(qh.dtype).float(), vh.float()) / l
    return o.to(qh.dtype)


def _lib():
    lib = cuda_build.load("flash64_fwd")
    fn = lib.wf_flash64_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [_c_i64] * 6 + [
            ctypes.c_int, ctypes.c_void_p,
        ]
    return fn


def flash64_attention(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 64) pre-scaled q/k/v -> (B, H, T, 64) attention output.

    q/k/v may be the head-split views of (B, T, H*64) projections (they
    must share one stride layout with a unit last stride); the result is
    the head-split view of a contiguous (B, T, H*64) tensor, so merging
    the heads back costs no copy.
    """
    if qh.device.type == "cpu":
        return flash64_attention_plain(qh, kh, vh)
    if qh.device.type != "cuda":
        raise RuntimeError(f"flash64_attention: no kernel for device {qh.device}")
    b, h, t, d = qh.shape
    if d != D_HEAD:
        raise ValueError(f"flash64_attention takes d_head 64, got {d}")
    if kh.shape != qh.shape or vh.shape != qh.shape:
        raise ValueError("flash64_attention: q, k and v must have one shape")
    if not (qh.dtype == kh.dtype == vh.dtype):
        raise TypeError("flash64_attention: q, k and v must have one dtype")
    if not (qh.device == kh.device == vh.device):
        raise ValueError("flash64_attention: q, k and v must be on one device")
    strides = qh.stride()
    if kh.stride() != strides or vh.stride() != strides or strides[-1] != 1:
        raise ValueError(
            "flash64_attention: q, k and v must share one stride layout with "
            f"a unit last stride (got {qh.stride()}, {kh.stride()}, {vh.stride()})"
        )
    if b * h > 65535:
        raise ValueError("flash64_attention: batch * heads exceeds 65535")
    code = cuda_build.dtype_code(qh.dtype, "flash64_attention")
    if qh.dtype == torch.bfloat16 and (
        any(s % 8 for s in strides[:3]) or any(x.data_ptr() % 16 for x in (qh, kh, vh))
    ):  # the tensor-core kernel reads rows in 16-byte pieces
        raise ValueError("flash64_attention: bf16 rows must be 16-byte aligned")
    fn = _lib()
    out = torch.empty((b, t, h, d), dtype=qh.dtype, device=qh.device).permute(0, 2, 1, 3)
    ob, oh, ot, _ = out.stride()
    err = fn(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr(),
        b, h, t, strides[0], strides[1], strides[2], ob, oh, ot,
        code, cuda_build.stream_ptr(qh),
    )
    cuda_build.check(err, "flash64_attention")
    flash64_attention.launches += 1
    return out


flash64_attention.launches = 0
