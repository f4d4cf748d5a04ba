"""The decode loop's cached cross-attention over a static slab: the CUDA
kernel and its plain version.

The rows of ``q`` (B, M, D) attend, head by head, to a head-split,
pre-scaled (B, H, Tk, 64) K/V slab in the compute dtype (the audio and
gated slabs of ``models.whisper.init_cache``), with an optional additive
key mask (B or 1, 1, 1, Tk). M is every query row that shares slab row b:
the G beams x t tokens that ``attention_block`` folds together, one
request in serving, a prompt in a prefill. The contract is that of
:func:`.attention.xa_qkv_attention` without int8 scales: q scaled by
d_head^-0.25 in the compute dtype, fp32 logits (exact products of the
compute-dtype values, fp32 sums) plus the mask, an fp32 softmax over all
the keys, the weights normalised and rounded to the compute dtype, an fp32
V sum, the head-merged (B, M, D) output in the compute dtype.

The plain version is :func:`.attention.xa_qkv_plain`, the route off the
kernel. It replaces no TPU kernel (the JAX package leaves this attention to
XLA); see ``csrc/xattn_step.cu`` for why it was added, its design and what
bounds it. :func:`plan` picks the launch from the shapes and the card's
occupancy for the kernel (no knob): the cluster that splits the keys.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch

from . import cuda_build

D_HEAD = 64
TILE = 64  # keys a tile
DTYPE_CODES = {torch.bfloat16: 1, torch.float16: 2}
_sm_count = {}  # device index -> SMs (a fact of the card, read once)


def takes(q: torch.Tensor, k: torch.Tensor, n_head: int) -> bool:
    """True when the kernel serves this call: a CUDA q in bf16 or fp16, a K
    slab of q's dtype (not int8) and d_head 64."""
    return (q.is_cuda and q.dtype in DTYPE_CODES and k.dtype == q.dtype
            and q.shape[-1] == n_head * D_HEAD)


@functools.lru_cache(maxsize=None)
def occupancy(device: int, dtype: torch.dtype) -> Callable[[int], int]:
    """The function ``tpc -> blocks`` for card ``device``: blocks of ``tpc``
    key tiles that one SM holds at once, from the CUDA runtime's occupancy
    calculator on the kernel's real launch (its registers, threads and
    shared memory); 0 where one block's shared memory does not fit."""
    fn = cuda_build.load("xattn_step").wf_xattn_step_blocks_per_sm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]

    @functools.lru_cache(maxsize=None)
    def blocks(tpc: int) -> int:
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            cuda_build.check(fn(tpc, DTYPE_CODES[dtype], ctypes.byref(n)), "xattn_step occupancy")
        return n.value

    return blocks


@functools.lru_cache(maxsize=256)  # pure in its arguments; an eager serving step calls it 32 times
def plan(slabs: int, rows: int, keys: int, heads: int, sms: int,
         occupancy: Callable[[int], int]) -> Tuple[int, int]:
    """``(cluster, tpc)``: the blocks of a cluster that split the keys (1 to
    8) and the 64-key tiles each takes; a block takes 16 query rows. On a
    card of ``sms`` SMs, each holding ``occupancy(tpc)`` blocks of ``tpc``
    tiles (:func:`occupancy`).

    A block's fixed cost (q, the statistics' exchange, the output's
    reduction) is paid once whatever its keys, so the plan takes the
    smallest cluster whose grid puts two blocks on every SM in one wave (a
    beam step of the AV model: 2 x 160 blocks of 750 keys). Where none
    does (too few blocks, or too many: long-form's 20, serving's 320, a
    long prefill) it takes the cluster with the fewest waves x (tiles a
    block + 8), the fixed cost counted as 8 tiles."""
    blocks = slabs * heads * -(-rows // 16)
    tiles = -(-keys // TILE)
    options = [c for c in (1, 2, 4, 8) if c == 1 or c <= tiles]
    fits = [c for c in options if occupancy(-(-tiles // c)) > 0]
    if not fits:
        raise ValueError(f"xattn_step: {keys} keys need too much shared memory")
    for c in fits:
        tpc = -(-tiles // c)
        if 2 * sms <= blocks * c <= occupancy(tpc) * sms:
            return c, tpc

    def cost(c):
        tpc = -(-tiles // c)
        return -(-blocks * c // (occupancy(tpc) * sms)) * (tpc + 8), c

    c = min(fits, key=cost)
    return c, -(-tiles // c)


def _kernel():
    fn = cuda_build.load("xattn_step").wf_xattn_step
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p] + [
            ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return fn


def xattn_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-attention of ``q`` (B, M, D) against the (B, H, Tk, 64) slabs
    ``k`` (pre-scaled) and ``v``; ``mask`` an optional fp32 additive key
    mask (B or 1, 1, 1, Tk). Returns the head-merged (B, M, D) output; raises
    for what the kernel does not take, a tensor off the card included."""
    if not q.is_cuda:
        raise RuntimeError(f"xattn_step: no kernel for device {q.device}")
    b, m, d = q.shape
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"xattn_step takes bfloat16 or float16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("xattn_step: q, k and v must have one dtype")
    if d != n_head * D_HEAD or k.dim() != 4 or k.shape[:2] != (b, n_head) or k.shape[3] != D_HEAD:
        raise ValueError(f"xattn_step: q {tuple(q.shape)} and K {tuple(k.shape)} are not "
                         f"(B, M, {n_head} x {D_HEAD}) and (B, {n_head}, Tk, {D_HEAD})")
    if v.shape != k.shape:
        raise ValueError("xattn_step: K and V must have one shape")
    tk = k.shape[2]
    where = q.get_device()
    if not (k.get_device() == v.get_device() == where):
        raise ValueError("xattn_step: all tensors must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("xattn_step: q, K and V must be contiguous")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("xattn_step: q, K and V must be 16-byte aligned")
    if m < 1 or tk < 1:
        raise ValueError("xattn_step: no rows or no keys")
    mask_ptr, mask_b = None, 0
    if mask is not None:
        if (mask.dtype != torch.float32 or mask.dim() != 4 or mask.shape[1:] != (1, 1, tk)
                or mask.shape[0] not in (1, b) or mask.get_device() != where
                or mask.stride(-1) != 1):
            raise ValueError("xattn_step: the mask must be an fp32 (B or 1, 1, 1, Tk) key mask "
                             "on q's device")
        mask_ptr, mask_b = mask.data_ptr(), mask.stride(0) if mask.shape[0] == b else 0
    sms = _sm_count.get(where)
    if sms is None:
        sms = _sm_count[where] = torch.cuda.get_device_properties(where).multi_processor_count
    cluster, tpc = plan(b, m, tk, n_head, sms, occupancy(where, q.dtype))
    if b * -(-m // 16) > 65535:
        raise ValueError("xattn_step: more than 65535 slab rows x query blocks")
    out = torch.empty_like(q)
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, mask_b, out.data_ptr(),
        b, m, tk, n_head, cluster, tpc, D_HEAD ** -0.25, DTYPE_CODES[q.dtype],
        cuda_build.stream_ptr(q),
    )
    cuda_build.check(err, "xattn_step")
    xattn_step.launches += 1
    return out


xattn_step.launches = 0
