"""The decoder MLP of the incremental decode loop as one streaming kernel:
the CUDA kernel, its plain version and the decode loop's dispatch.

Port of ``whisper_flamingo_tpu/ops/decode_mlp.py`` (``fused_mlp`` over
``_kernel``), plain and int8 weights. It computes what ``mlp_block``
computes with the kernel's roundings: ``h = x . W1`` accumulated in fp32,
int8 only ``h *= s1`` (fp32, before the nonlinearity), ``+ b1`` as fp32,
the exact GELU, ``a`` rounded to x's dtype, ``a . W2`` summed in fp32, int8
only ``*= s2``, then the cast to x's dtype and ``+ b2`` in x's dtype. The
unfused ``mlp_block`` instead rounds fc1's output to x's dtype before the
GELU, so the decode loop keeps the JAX package's default numerics while
:data:`ENABLED` is off (its default, as in JAX).

:func:`fused_mlp` keeps the JAX dispatch rule, which decides which route
computes: the kernel takes the call when the ffn axis tiles by
:data:`TILE_F` (or is at most one tile wide), d % 8 == 0 and there are at
most 1024 rows; otherwise ``mlp_block`` does. When the rule picks the
kernel, a CPU tensor takes :func:`fused_mlp_plain` and a CUDA tensor
launches the kernel (``csrc/decode_mlp.cu``) or raises; it takes d and f
that are multiples of 16, one dtype for x and the float weights,
contiguous operands.

Left out, a TPU workaround: the Abramowitz-Stegun erf polynomial (Pallas
on the TPU lowers no erf); the kernel and the plain version use the exact
erf. See ``csrc/decode_mlp.cu`` for the design and what bounds it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import cuda_build

TILE_F = 512  # the JAX package's ffn tile: part of the dispatch rule
MAX_ROWS = 1024

# Decode-loop dispatch switch (read by models.whisper.decoder_apply's cache
# path), off by default as in the JAX package.
ENABLED = False


def _weights(p: nn.Sequential) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
                                        Optional[torch.Tensor]]:
    """(W1 (f, d), W2 (d, f), s1, s2): the int8 weights and their scales when
    the layers are quantized, else the weights and None."""
    fc1, fc2 = p[0], p[2]
    if getattr(fc1, "w_q", None) is not None:
        return fc1.w_q, fc2.w_q, fc1.w_s, fc2.w_s
    return fc1.weight, fc2.weight, None, None


def fused_mlp_plain(
    x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
    s1: Optional[torch.Tensor] = None, s2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``x`` (rows, d); ``w1`` (f, d)
    and ``w2`` (d, f) in x's dtype, or int8 with the fp32 scales ``s1`` (f)
    and ``s2`` (d). Returns (rows, d) in x's dtype."""
    h = torch.matmul(x.float(), w1.to(x.dtype).float().t())  # exact products, fp32 sums
    if s1 is not None:
        h = h * s1.float()
    a = F.gelu(h + b1.float()).to(x.dtype)
    o = torch.matmul(a.float(), w2.to(x.dtype).float().t())
    if s2 is not None:
        o = o * s2.float()
    return o.to(x.dtype) + b2.to(x.dtype)


def _lib():
    lib = cuda_build.load("decode_mlp")
    fn = lib.wf_decode_mlp
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return lib


def _launch(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
            b2: torch.Tensor, s1: Optional[torch.Tensor], s2: Optional[torch.Tensor]) -> torch.Tensor:
    rows, d = x.shape
    f = w1.shape[0]
    quantized = s1 is not None
    wdt = torch.int8 if quantized else x.dtype
    if w1.shape != (f, d) or w2.shape != (d, f) or b1.shape != (f,) or b2.shape != (d,):
        raise ValueError("fused_mlp: weights must be (f, d) and (d, f), biases (f,) and (d,)")
    if w1.dtype != wdt or w2.dtype != wdt or b1.dtype != x.dtype or b2.dtype != x.dtype:
        raise TypeError("fused_mlp: the weights and biases must have x's dtype (or int8 "
                        "weights with scales)")
    if quantized and (s2 is None or s1.shape != (f,) or s2.shape != (d,)
                      or s1.dtype != torch.float32 or s2.dtype != torch.float32):
        raise ValueError("fused_mlp: int8 weights need float32 scales (f,) and (d,)")
    tensors = [x, w1, b1, w2, b2] + ([s1, s2] if quantized else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_mlp: all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_mlp: the operands must be contiguous")
    if d % 16 or f % 16:
        raise ValueError(f"fused_mlp: d ({d}) and f ({f}) must be multiples of 16")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("fused_mlp: the operands must be 16-byte aligned")
    code = cuda_build.dtype_code(x.dtype, "fused_mlp")
    act = torch.empty((rows, f), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    err = _lib().wf_decode_mlp(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), s1.data_ptr() if quantized else None,
        w2.data_ptr(), b2.data_ptr(), s2.data_ptr() if quantized else None,
        act.data_ptr(), out.data_ptr(), rows, d, f, code, int(quantized),
        cuda_build.stream_ptr(x),
    )
    cuda_build.check(err, "fused_mlp")
    fused_mlp.launches += 1
    return out


def fused_mlp(p: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """Drop-in for ``mlp_block(p, x)`` on the decode path: ``p`` is a
    layer's MLP (``p[0]`` fc1, ``p[2]`` fc2, plain or quantized by
    ``quantize_decode_params``), ``x`` (..., D) with the leading axes folded
    into rows. The JAX dispatch rule picks the kernel or ``mlp_block``."""
    w1, w2, s1, s2 = _weights(p)
    f, d = w1.shape
    rows = x.numel() // x.shape[-1]
    tile = TILE_F if f % TILE_F == 0 else (f if f <= TILE_F else None)
    if tile is None or d % 8 or rows > MAX_ROWS:
        from ..models.whisper import mlp_block

        return mlp_block(p, x)
    x2 = x.reshape(rows, d)
    b1, b2 = p[0].bias, p[2].bias
    if x.device.type == "cpu":
        out = fused_mlp_plain(x2, w1, b1, w2, b2, s1, s2)
    elif x.device.type == "cuda":
        out = _launch(x2.contiguous(), w1, b1, w2, b2, s1, s2)
    else:
        raise RuntimeError(f"fused_mlp: no kernel for device {x.device}")
    return out.reshape(x.shape)


fused_mlp.launches = 0
