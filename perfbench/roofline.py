"""The yardstick's peaks and each measured kernel's least time.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
700 W limit): 989 TFLOP/s in bf16 and fp16, 67 TFLOP/s in fp32 outside the
tensor cores, 3.35 TB/s of HBM. A kernel's least time is the larger of its
operations over the peak rate and its bytes over the bandwidth, each input
byte read once and each output byte written once, counted from the call's
shapes whatever implements it. A share of the roofline is that least time
over the device time the kernels of the call took.
"""

from __future__ import annotations

from typing import Sequence, Union

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
BF16_PEAK_FLOPS = PEAK_FLOPS["bfloat16"]
HBM_BYTES_PER_S = 3.35e12

ITEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def least_s(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def flash64_fwd_s(bh: int, t: int, dtype: str, with_lse: bool = False) -> float:
    """Encoder self-attention forward at d_head 64 over (B*H, T, 64): QK^T and
    PV, 4 BH T^2 64 operations; q, k, v read and o written (and the fp32
    lse written when asked)."""
    item = ITEM[dtype]
    nbytes = bh * t * (4 * 64 * item + (4 if with_lse else 0))
    return least_s(4.0 * bh * t * t * 64, nbytes, dtype)


def flash64_bwd_s(bh: int, t: int, dtype: str) -> float:
    """Its backward counted as five products of 2 BH T^2 64 operations (S
    again, dP, dV, dQ, dK); q, k, v, o, dO and the lse read, dQ, dK, dV
    written."""
    item = ITEM[dtype]
    return least_s(5 * 2.0 * bh * t * t * 64, bh * t * (8 * 64 * item + 4), dtype)


def decode_attn_s(rows: int, d: int, offsets: Union[int, Sequence[int]], dtype: str) -> float:
    """One incremental self-attention step per row with its cache prefix of
    ``offset`` tokens: the prefix's K and V read once, the new token's q, k,
    v read, its output and new K/V row written; QK^T and PV over offset + 1
    keys. ``offsets`` is one offset for every row or one per row."""
    item = ITEM[dtype]
    offs = [int(offsets)] * rows if isinstance(offsets, int) else [int(o) for o in offsets]
    total = sum(offs)
    flops = 4.0 * d * (total + rows)
    nbytes = item * d * (2 * total + 6 * rows)
    return least_s(flops, nbytes, dtype)
