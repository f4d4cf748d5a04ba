"""The decode loop's incremental self-attention step: the CUDA kernel and
its plain version.

Port of ``whisper_flamingo_tpu/ops/decode_attn.py`` (``fused_step``, with
both ``_kernel`` and ``_kernel_multi``). One call writes the current
token's K/V row into the unsplit (B, T_max, D) self cache at ``offset`` (K
scaled by d_head^-0.25 in the source dtype, then cast to the cache dtype)
and attends over the cache positions <= offset: fp32 per-head logits with
q scaled in fp32, fp32 softmax, weights rounded to the compute dtype, fp32
V sum, head-merged (B, 1, D) output.

The caches are updated IN PLACE (the JAX version returned new arrays);
:func:`fused_step` still returns them, for the JAX call shape.

Left out, each a TPU measurement or workaround: the ``ENABLED`` /
``FORCE_CPU`` / ``MAX_ROWS`` / ``MULTI_ENABLED`` dispatch (the kernel serves
every incremental step, for any row count), the separate many-row
lockstep kernel (a scalar offset is the same kernel with offset stride 0),
and the 8-row aligned write window (the kernel writes just the new row).
See ``csrc/decode_attn.cu`` for the design and what bounds it.

``offset`` is a Python int, or a device int32 tensor of shape (), (1,)
(one offset for every row: lockstep) or (B,) (one per row). The kernel
reads it on the device: a step needs no host sync.
"""

from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from . import cuda_build

_SMEM_LIMIT = 48 * 1024

Offset = Union[int, torch.Tensor]


def _row_offsets(offset: Offset, b: int, device) -> torch.Tensor:
    off = torch.as_tensor(offset, device=device).reshape(-1).long()
    return off.expand(b) if off.numel() == 1 else off


def fused_step_plain(
    q: torch.Tensor, k_raw: torch.Tensor, v_raw: torch.Tensor,
    k_cache: torch.Tensor, v_cache: torch.Tensor, offset: Offset, n_head: int,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch; updates the caches in place
    and returns the (B, 1, D) attention output."""
    b, t_max, d = k_cache.shape
    dh = d // n_head
    scale = dh ** -0.25
    rows = torch.arange(b, device=k_cache.device)
    off = _row_offsets(offset, b, k_cache.device)
    k_cache[rows, off] = (k_raw[:, 0] * scale).to(k_cache.dtype)
    v_cache[rows, off] = v_raw[:, 0].to(v_cache.dtype)

    qs = q[:, 0].float() * scale  # (B, D), fp32
    prod = k_cache.float() * qs[:, None, :]  # (B, T, D) exact fp32 products
    logits = prod.view(b, t_max, n_head, dh).sum(-1)  # (B, T, H)
    valid = torch.arange(t_max, device=k_cache.device)[None, :] <= off[:, None]
    logits = logits.masked_fill(~valid[:, :, None], float("-inf"))
    e = torch.exp(logits - logits.amax(dim=1, keepdim=True))
    w = e / e.sum(dim=1, keepdim=True)
    wl = w.to(q.dtype).float().repeat_interleave(dh, dim=-1)  # (B, T, D)
    out = (wl * v_cache.float()).sum(dim=1, keepdim=True)
    return out.to(q.dtype)


def _lib():
    lib = cuda_build.load("decode_attn")
    fn = lib.wf_decode_attn_step
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p] + [
            ctypes.c_int
        ] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.wf_decode_attn_smem_bytes.restype = ctypes.c_int
        lib.wf_decode_attn_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def fused_step(
    q: torch.Tensor, k_raw: torch.Tensor, v_raw: torch.Tensor,
    k_cache: torch.Tensor, v_cache: torch.Tensor, offset: Offset, n_head: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One incremental self-attention step, fused.

    ``q``/``k_raw``/``v_raw`` are the current token's unscaled projections
    (B, 1, D); ``k_cache``/``v_cache`` the unsplit (B, T_max, D) slabs with
    K pre-scaled. Returns ``(attn_out (B, 1, D), k_cache, v_cache)``, the
    caches being the same tensors, updated in place.
    """
    if q.device.type == "cpu":
        out = fused_step_plain(q, k_raw, v_raw, k_cache, v_cache, offset, n_head)
        return out, k_cache, v_cache
    if q.device.type != "cuda":
        raise RuntimeError(f"fused_step: no kernel for device {q.device}")
    b, t_max, d = k_cache.shape
    dh = d // n_head
    tensors = (q, k_raw, v_raw, k_cache, v_cache)
    if q.shape != (b, 1, d) or k_raw.shape != q.shape or v_raw.shape != q.shape:
        raise ValueError("fused_step: q/k/v must be (B, 1, D) for a (B, T, D) cache")
    if v_cache.shape != k_cache.shape or d % n_head:
        raise ValueError("fused_step: bad cache or head shapes")
    if len({t.dtype for t in tensors}) != 1:
        raise TypeError("fused_step: q, k, v and the caches must have one dtype")
    if any(t.device != q.device for t in tensors):
        raise ValueError("fused_step: all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_step: q, k, v and the caches must be contiguous")
    if dh not in (32, 64, 128):
        raise ValueError(f"fused_step: d_head {dh} is not 32, 64 or 128")
    if (d * k_cache.element_size()) % 16 or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("fused_step: cache rows must be 16-byte aligned")
    if b > 65535:
        raise ValueError("fused_step: more than 65535 rows")
    code = cuda_build.dtype_code(q.dtype, "fused_step")
    if isinstance(offset, int):
        if not 0 <= offset < t_max:
            raise ValueError(f"fused_step: offset {offset} outside [0, {t_max})")
        offsets = torch.full((1,), offset, dtype=torch.int32, device=q.device)
    else:
        offsets = offset.reshape(-1)
        if offsets.dtype != torch.int32:
            offsets = offsets.to(torch.int32)
        if offsets.device != q.device or offsets.numel() not in (1, b):
            raise ValueError("fused_step: offsets must be 1 or B values on q's device")
        offsets = offsets.contiguous()
    lib = _lib()
    if lib.wf_decode_attn_smem_bytes(t_max, dh) > _SMEM_LIMIT:
        raise ValueError(f"fused_step: cache length {t_max} needs too much shared memory")
    out = torch.empty_like(q)
    err = lib.wf_decode_attn_step(
        q.data_ptr(), k_raw.data_ptr(), v_raw.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), offsets.data_ptr(),
        0 if offsets.numel() == 1 else 1, out.data_ptr(),
        b, t_max, d, n_head, dh ** -0.25, code, cuda_build.stream_ptr(q),
    )
    cuda_build.check(err, "fused_step")
    fused_step.launches += 1
    return out, k_cache, v_cache


fused_step.launches = 0
