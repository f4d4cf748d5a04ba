"""Multi-head attention primitives.

Port of ``whisper_flamingo_tpu/ops/attention.py``. The contract is kept:

- q and k are each scaled by ``d_head ** -0.25`` before the logits;
- in the decode caches K is pre-scaled once, when it is written;
- logits and softmax are fp32 (the operands are upcast, so the products
  of bf16 values are exact), and the weights are cast to the compute dtype
  before the V product.

Layouts: the self cache is unsplit (B, T_max, D); the static cross-attention
slabs (audio features, conditioning streams) are head-split (B, H, T, Dh),
K and V in the compute dtype (int8 in the quantized modes). On the card
:func:`xa_qkv_attention` over bf16 or fp16 slabs at d_head 64 runs the
cached cross-attention kernel (:mod:`.xattn_step`), which takes the
compute-dtype operands and accumulates the logits in fp32.

Left out, each a TPU workaround: the transposed (B, H, Dh, T) slabs kept
off the 128-lane axis, the selector-matrix form of many-row attention
(``cached_selector_attention``), the Pallas library fallback and the
``shard_map`` wrapper. :func:`qkv_attention` with ``backend="flash"`` takes
the d_head 64 kernel (:mod:`.flash64`); another head size (only the
``debug`` dims) runs the plain path, where the JAX package used the
library kernel.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .. import profiling
from . import flash64, xattn_step

NEG_INF = float("-inf")


def split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, T, D) -> (B, H, T, D/H), a view."""
    b, t, d = x.shape
    return x.view(b, t, n_head, d // n_head).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, D/H) -> (B, T, D)."""
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _attend(qh, kh, vh, mask=None, out_dtype=None, return_qk=False,
            logit_scale=None, weight_scale=None):
    """fp32 logits and softmax over head-split operands; weights in the
    compute dtype for the V product. With ``return_qk`` also the fp32
    logits (mask added). ``logit_scale`` multiplies the fp32 logits before
    the mask (unwritten int8kv positions carry scale 0 and mask -inf:
    ``0 * -inf`` would be NaN the other way round); ``weight_scale``
    multiplies the weights in their dtype before the V product."""
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    if logit_scale is not None:
        logits = logits * logit_scale
    if mask is not None:
        logits = logits + mask
    weights = torch.softmax(logits, dim=-1).to(out_dtype or qh.dtype)
    if weight_scale is not None:
        weights = weights * weight_scale.to(weights.dtype)
    out = torch.matmul(weights, vh.to(weights.dtype))
    return (out, logits) if return_qk else out


def qkv_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int,
    mask: Optional[torch.Tensor] = None, backend: str = "plain", return_qk: bool = False,
):
    """Scaled dot-product attention over projected (B, T, D) q/k/v.

    ``mask`` is additive, broadcastable to (B, H, Tq, Tk). With
    ``backend="flash"``, no mask and d_head 64 the attention runs through
    :func:`.flash64.flash64_attention` (the CUDA kernel on the card). With
    ``return_qk`` (the plain path) it returns ``(out, logits)``: the fp32
    pre-softmax scaled logits (B, H, Tq, Tk) that word timing reads."""
    d_head = q.shape[-1] // n_head
    scale = d_head ** -0.25
    if backend == "flash" and mask is None and not return_qk and d_head == flash64.D_HEAD:
        out = flash64.flash64_attention(
            split_heads(q * scale, n_head), split_heads(k * scale, n_head),
            split_heads(v.contiguous(), n_head),
        )
        return merge_heads(out)
    qh = split_heads(q, n_head) * scale
    kh = split_heads(k, n_head) * scale
    if return_qk:
        out, logits = _attend(qh, kh, split_heads(v, n_head), mask, return_qk=True)
        return merge_heads(out), logits
    return merge_heads(_attend(qh, kh, split_heads(v, n_head), mask))


def causal_mask(n_ctx: int, device=None) -> torch.Tensor:
    """Additive (n_ctx, n_ctx) causal mask."""
    return torch.full((n_ctx, n_ctx), NEG_INF, device=device).triu(1)


def cached_causal_mask(
    q_len: int, cache_len: int, offset: Union[int, torch.Tensor], device=None
) -> torch.Tensor:
    """Additive mask for attention over a preallocated cache where the
    current chunk sits at [offset, offset + q_len): position ``i`` sees
    cache slots ``j <= offset + i``. A (B,) ``offset`` gives a
    (B, 1, q_len, cache_len) mask."""
    q_pos = torch.arange(q_len, device=device)[:, None]
    k_pos = torch.arange(cache_len, device=device)[None, :]
    if isinstance(offset, torch.Tensor) and offset.dim() == 1:
        q_pos = offset.to(device)[:, None, None, None] + q_pos[None, None]
        k_pos = k_pos[None, None]
    else:
        q_pos = q_pos + int(offset)
    zero = torch.zeros((), device=device)
    return torch.where(k_pos <= q_pos, zero, torch.full((), NEG_INF, device=device))


def update_cache(
    cache: torch.Tensor, new: torch.Tensor, offset: Union[int, torch.Tensor]
) -> torch.Tensor:
    """Write ``new`` (B, T, d) into ``cache`` (B, T_max, d) at ``offset``
    along the time axis, IN PLACE (the JAX version returned a new array).
    A (B,) ``offset`` writes each row at its own position. Returns
    ``cache``."""
    t = new.shape[-2]
    if isinstance(offset, torch.Tensor) and offset.dim() == 1:
        idx = offset.to(cache.device).long()[:, None] + torch.arange(t, device=cache.device)
        rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
        cache[rows, idx] = new.to(cache.dtype)
    else:
        offset = int(offset)
        cache[..., offset: offset + t, :] = new.to(cache.dtype)
    return cache


def cached_qkv_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int,
    mask: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None, v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Self-attention of ``q`` (B, Tq, D) against the unsplit (B, T_max, D)
    cache slabs, K pre-scaled at write time.

    With ``k_scale``/``v_scale`` (the int8kv self cache's per-(token, head)
    (B, T_max, H) scales) the slabs are int8: K's scale multiplies the fp32
    logits before the mask, V's the weights in q's dtype."""
    d_head = q.shape[-1] // n_head
    qh = split_heads(q, n_head) * (d_head ** -0.25)
    kh = split_heads(k, n_head)
    vh = split_heads(v.to(q.dtype), n_head)
    if k_scale is not None:  # (B, T, H) -> (B, H, 1, T)
        k_scale = k_scale.transpose(1, 2)[:, :, None, :]
    if v_scale is not None:
        v_scale = v_scale.transpose(1, 2)[:, :, None, :]
    return merge_heads(_attend(qh, kh, vh, mask, logit_scale=k_scale, weight_scale=v_scale))


def xa_qkv_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int,
    k_scale: Optional[torch.Tensor] = None, v_scale: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Cross-attention of ``q`` (B, Tq, D) against a head-split, pre-scaled
    (B, H, Tk, Dh) K/V slab; ``mask`` an optional additive key mask
    broadcastable to (B, H, Tq, Tk) (a slab held at a capacity).

    With ``k_scale``/``v_scale`` (per-head (B, H, 1, 1) scales) the slabs
    are int8: K's scale multiplies q in q's dtype before QK^T, V's the
    weights in their dtype.

    On the card, bf16 or fp16 slabs at d_head 64 go to the kernel
    (:func:`.xattn_step.xattn_step`, counter ``decode.xattn_kernel``); the
    int8 and fp32 ones to the plain product (``decode.xattn_plain``)."""
    unscaled = k_scale is None and v_scale is None
    if unscaled and xattn_step.takes(q, k, n_head):
        profiling.count("decode.xattn_kernel")
        return xattn_step.xattn_step(q, k, v, n_head, mask)
    if q.is_cuda:
        profiling.count("decode.xattn_plain")
    if unscaled:
        return xa_qkv_plain(q, k, v, n_head, mask)
    qh = split_heads(q, n_head) * ((q.shape[-1] // n_head) ** -0.25)
    if k_scale is not None:
        qh = qh * k_scale.to(qh.dtype)
    return merge_heads(_attend(qh, k, v, mask, out_dtype=q.dtype, weight_scale=v_scale))


def xa_qkv_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`xa_qkv_attention` over unquantized slabs in plain PyTorch: q
    scaled by d_head^-0.25 in its dtype, fp32 logits plus the mask, an fp32
    softmax, the weights in q's dtype for the V product. The route off the
    kernel, and what the kernel is held to."""
    qh = split_heads(q, n_head) * ((q.shape[-1] // n_head) ** -0.25)
    return merge_heads(_attend(qh, k, v, mask, out_dtype=q.dtype))


def head_split_kv(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, T, D) projected K or V -> the contiguous (B, H, T, Dh) slab that
    :func:`xa_qkv_attention` consumes. A one-time cost at prefill."""
    return split_heads(x, n_head).contiguous()
