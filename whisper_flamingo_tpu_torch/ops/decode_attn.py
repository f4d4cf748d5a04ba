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

``offset`` is a Python int (the lockstep decode loop's: passed to the
kernel by value), or a device int32 tensor of shape (), (1,) (one offset
for every row) or (B,) (one per row), which the kernel reads on the
device: a step needs no host sync either way.

Beam search reads the self cache through a row table (:func:`beam_rows`):
inside its block, position ``p < offset`` of row ``b`` is read from row
``rows[b, p]`` of the cache, so the decode loop reorders the table after
each beam selection and never the cache. The new K/V row still goes into
row ``b`` at ``offset``. Without a table the kernel reads none.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
from typing import Iterator, Optional, Tuple, Union

import torch

from . import cuda_build

Offset = Union[int, torch.Tensor]

_ROWS: contextvars.ContextVar = contextvars.ContextVar("decode_attn_rows", default=None)


@contextlib.contextmanager
def beam_rows(rows: Optional[torch.Tensor]) -> Iterator[None]:
    """Read the self caches of every :func:`fused_step` (and
    :func:`fused_step_plain`) in the block through ``rows``: an int32
    (B, T_max) table, contiguous on the caches' device, whose entry
    ``(b, p)`` names the row of the cache that holds position ``p`` of row
    ``b``'s history. Entries at or past a row's offset are not read (the
    row's own new K/V is). Each entry before the offset must name a row
    whose position ``p`` is already written and is not written by the same
    call (a lockstep offset guarantees it). ``None`` reads every row's own
    slab, as outside the block."""
    if rows is not None and (rows.dim() != 2 or rows.dtype != torch.int32
                             or not rows.is_contiguous()):
        raise ValueError("beam_rows: the table must be a contiguous int32 (B, T_max) tensor")
    token = _ROWS.set(rows)
    try:
        yield
    finally:
        _ROWS.reset(token)


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
    pos = torch.arange(t_max, device=k_cache.device)[None, :]
    table = _ROWS.get()
    if table is not None:  # each row's history, gathered through the table
        _check_table(table, b, t_max, k_cache)
        src = torch.where(pos < off[:, None], table.long(), rows[:, None])
        k_cache, v_cache = k_cache[src, pos], v_cache[src, pos]

    qs = q[:, 0].float() * scale  # (B, D), fp32
    prod = k_cache.float() * qs[:, None, :]  # (B, T, D) exact fp32 products
    logits = prod.view(b, t_max, n_head, dh).sum(-1)  # (B, T, H)
    valid = pos <= off[:, None]
    logits = logits.masked_fill(~valid[:, :, None], float("-inf"))
    e = torch.exp(logits - logits.amax(dim=1, keepdim=True))
    w = e / e.sum(dim=1, keepdim=True)
    wl = w.to(q.dtype).float().repeat_interleave(dh, dim=-1)  # (B, T, D)
    out = (wl * v_cache.float()).sum(dim=1, keepdim=True)
    return out.to(q.dtype)


def _check_table(table: torch.Tensor, b: int, t_max: int, k_cache: torch.Tensor) -> None:
    if table.shape != (b, t_max) or table.device != k_cache.device:
        raise ValueError(f"fused_step: a (B, T_max) = ({b}, {t_max}) row table on the "
                         f"caches' device is needed, got {tuple(table.shape)} on {table.device}")


# The kernel's two modes (csrc/decode_attn.cu): with at most two blocks (one
# per (row, head)) per SM the launch is latency-bound and takes 512 threads,
# 8 KB chunks and a ring of 3; with more, 128 threads, 4 KB chunks and a
# ring of 2, so that 11 blocks share an SM. A block may use 227 KB of
# shared memory on an H100.
SMEM_LIMIT = 232448
_sm_count = {}  # device index -> SMs (a fact of the card, read once)


def latency_mode(blocks: int, sm_count: int) -> bool:
    """True when the grid has at most two blocks per SM."""
    return blocks <= 2 * sm_count


def smem_bytes(t_max: int, d_head: int, item: int, latency: bool, indirect: bool = False) -> int:
    """Dynamic shared memory of one launch, in bytes (the C side's
    ``wf_decode_attn_smem_bytes``): chunk 0 of K and V and the ring, the
    new K/V row, the V sum's partials (one per warp: 16 or 4), the t_max
    logits and, reading through a row table, its t_max entries."""
    chunk, stages, warps = (8192, 3, 16) if latency else (4096, 2, 4)
    return ((2 + stages) * chunk + 2 * d_head * item + 4 * (warps * d_head + t_max)
            + (4 * t_max if indirect else 0))


def _kernel():
    fn = cuda_build.load("decode_attn").wf_decode_attn_step
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p] + [
            ctypes.c_int
        ] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    return fn


def fused_step(
    q: torch.Tensor, k_raw: torch.Tensor, v_raw: torch.Tensor,
    k_cache: torch.Tensor, v_cache: torch.Tensor, offset: Offset, n_head: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One incremental self-attention step, fused.

    ``q``/``k_raw``/``v_raw`` are the current token's unscaled projections
    (B, 1, D); ``k_cache``/``v_cache`` the unsplit (B, T_max, D) slabs with
    K pre-scaled. Returns ``(attn_out (B, 1, D), k_cache, v_cache)``, the
    caches being the same tensors, updated in place. Inside
    :func:`beam_rows` the prefix is read through its table.
    """
    kind = q.device.type
    if kind == "cpu":
        out = fused_step_plain(q, k_raw, v_raw, k_cache, v_cache, offset, n_head)
        return out, k_cache, v_cache
    if kind != "cuda":
        raise RuntimeError(f"fused_step: no kernel for device {q.device}")
    b, t_max, d = k_cache.shape
    dh = d // n_head
    dtype, where = q.dtype, q.get_device()
    if q.shape != (b, 1, d) or k_raw.shape != q.shape or v_raw.shape != q.shape:
        raise ValueError("fused_step: q/k/v must be (B, 1, D) for a (B, T, D) cache")
    if v_cache.shape != k_cache.shape or d % n_head:
        raise ValueError("fused_step: bad cache or head shapes")
    if not (k_raw.dtype == v_raw.dtype == k_cache.dtype == v_cache.dtype == dtype):
        raise TypeError("fused_step: q, k, v and the caches must have one dtype")
    if not (k_raw.get_device() == v_raw.get_device() == k_cache.get_device()
            == v_cache.get_device() == where):
        raise ValueError("fused_step: all tensors must be on one device")
    if not (q.is_contiguous() and k_raw.is_contiguous() and v_raw.is_contiguous()
            and k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("fused_step: q, k, v and the caches must be contiguous")
    if dh not in (32, 64, 128):
        raise ValueError(f"fused_step: d_head {dh} is not 32, 64 or 128")
    kp, vp = k_cache.data_ptr(), v_cache.data_ptr()
    if (d * k_cache.element_size()) % 16 or kp % 16 or vp % 16:
        raise ValueError("fused_step: cache rows must be 16-byte aligned")
    if b > 65535:
        raise ValueError("fused_step: more than 65535 rows")
    sms = _sm_count.get(where)
    if sms is None:
        sms = _sm_count[where] = torch.cuda.get_device_properties(where).multi_processor_count
    latency = latency_mode(b * n_head, sms)
    table = _ROWS.get()
    if table is not None:
        _check_table(table, b, t_max, k_cache)
    if smem_bytes(t_max, dh, k_cache.element_size(), latency, table is not None) > SMEM_LIMIT:
        raise ValueError(f"fused_step: cache length {t_max} needs too much shared memory")
    code = cuda_build.dtype_code(dtype, "fused_step")
    if isinstance(offset, int):  # by value: no device read
        if not 0 <= offset < t_max:
            raise ValueError(f"fused_step: offset {offset} outside [0, {t_max})")
        off_ptr, off_stride, off_scalar = None, 0, offset
    else:
        offsets = offset if offset.dim() == 1 else offset.reshape(-1)
        if offsets.dtype != torch.int32:
            offsets = offsets.to(torch.int32)
        n_off = offsets.numel()
        if offsets.get_device() != where or n_off not in (1, b):
            raise ValueError("fused_step: offsets must be 1 or B values on q's device")
        offsets = offsets.contiguous()
        off_ptr, off_stride, off_scalar = offsets.data_ptr(), 0 if n_off == 1 else 1, 0
    out = torch.empty_like(q)
    err = _kernel()(
        q.data_ptr(), k_raw.data_ptr(), v_raw.data_ptr(), kp, vp, off_ptr, off_stride,
        off_scalar, out.data_ptr(),
        b, t_max, d, n_head, dh ** -0.25, code, latency,
        None if table is None else table.data_ptr(), cuda_build.stream_ptr(q),
    )
    cuda_build.check(err, "fused_step")
    fused_step.launches += 1
    return out, k_cache, v_cache


fused_step.launches = 0
