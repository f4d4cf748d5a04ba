"""Symmetric int8 quantization for the serving modes
(``DecodingOptions(quantize="int8" | "int8kv")``).

Port of ``whisper_flamingo_tpu/ops/quant.py``: the same scales, the same
rounding (``torch.round`` rounds half to even, as ``jnp.round`` does) and
the same int8 values, bit for bit, from the same float32 input. These are
plain PyTorch: the JAX package left them to XLA, and the dequantizing
product stays ``torch.matmul`` over the int8 values cast to the
activation dtype.

Scale conventions (symmetric, no zero point):

- weights, in the port's ``nn.Linear`` layout (..., D_out, D_in): one
  scale per output channel, the amax over D_in (JAX reduces its
  (D_in, D_out) layout over axis -2: the same numbers, transposed); the
  scale multiplies the product's output;
- K/V slabs (..., H, T, Dh): one scale per head, the amax over (T, Dh);
  K's scale multiplies q before QK^T, V's the attention weights;
- the int8kv self cache (..., T, D): one scale per (token, head), see
  :func:`quantize_tokenwise_kv`.

An all-zero channel gets scale 0 and int8 zeros, so it dequantizes to
exact zeros.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch


def _inverse(scale: torch.Tensor) -> torch.Tensor:
    return torch.where(scale > 0, 1.0 / scale.clamp_min(1e-30), torch.zeros_like(scale))


AmaxReduce = Optional[Callable[[torch.Tensor], torch.Tensor]]


def quantize_int8(
    x: torch.Tensor, dim: Union[int, Sequence[int]], amax_reduce: AmaxReduce = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)`` with ``q = round(x / scale)`` in [-127, 127] (int8) and
    the float32 ``scale = amax / 127`` over ``dim``, reduced dims kept.
    ``amax_reduce`` combines the amax with other ranks' before the scale
    (a weight split along ``dim`` over the model axis)."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    scale = amax / 127.0
    q = torch.round(xf * _inverse(scale))
    return q.to(torch.int8), scale


def quantize_tokenwise_kv(x: torch.Tensor, n_head: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) int8 for K/V rows written one step at a time (the
    int8kv self cache): ``x`` (..., T, D) -> int8 ``q`` (..., T, D) and
    float32 ``scale`` (..., T, H). A slab-wide amax is unknown while the
    cache fills, and a scale per token keeps the error from growing with
    the sequence."""
    *lead, t, d = x.shape
    xh = x.float().reshape(*lead, t, n_head, d // n_head)
    scale = xh.abs().amax(dim=-1) / 127.0
    q = torch.round(xh * _inverse(scale)[..., None]).reshape(*lead, t, d)
    return q.to(torch.int8), scale


def quantize_linear_params(
    weight: torch.Tensor, amax_reduce: AmaxReduce = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """An ``nn.Linear`` weight (D_out, D_in) -> int8 ``w_q`` of the same
    shape and float32 per-output-channel ``w_s`` (D_out,); ``amax_reduce``
    as in :func:`quantize_int8` (an input-split weight)."""
    w_q, w_s = quantize_int8(weight, dim=-1, amax_reduce=amax_reduce)
    return w_q, w_s.squeeze(-1)


def quantized_matmul(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(w_q)^T``: the product of ``x`` with the int8 values cast
    to x's dtype, then the per-output-channel scale in x's dtype (the JAX
    package's order of roundings)."""
    y = torch.matmul(x, w_q.to(x.dtype).t())
    return y * w_s.to(x.dtype)
