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

In bf16 the kernel is bound by its weight bytes: the weight is the M side
of ``wgmma`` (64 output features a CTA, the rows the N side), each pass's
contraction is split over a thread-block cluster whose fp32 partial sums
meet in distributed shared memory in a fixed order, the weight slices come
by TMA through tensor maps encoded once per weight set, int8 weights are
converted to bf16 in shared memory, and fc2 launches after fc1 in stream
order. :func:`plan` chooses the row tile and the
cluster sizes. The wrapper checks and prepares a weight set once, when the
kernel first sees it, and keeps it in ``_CHECKED``, keyed by the tensors
themselves (weak references), their versions and data pointers; per call
it checks only x, and fc1's output goes to one scratch buffer per stream.

Left out, a TPU workaround: the Abramowitz-Stegun erf polynomial (Pallas
on the TPU lowers no erf); the kernel and the plain version use the exact
erf. See ``csrc/decode_mlp.cu`` for the design and what bounds it.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.tp import reduce_from_tp
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


class Plan(NamedTuple):
    """The bf16 kernel's launch: the row tile ``nt`` (the ``wgmma`` N), the
    cluster sizes ``cl1`` (over fc1's d) and ``cl2`` (over fc2's f), each
    CTA's 64-wide contraction blocks, the row tiles a CTA walks, each
    pass's CTAs and shared-memory bytes per CTA."""

    nt: int
    cl1: int
    cl2: int
    kbs1: int
    kbs2: int
    tiles: int
    ctas1: int
    ctas2: int
    smem1: int
    smem2: int


ROW_TILES = (8, 32, 128)  # the wgmma N widths the kernel is built for
CLUSTER_CAP = (4, 8)  # the most CTAs splitting fc1's and fc2's contraction
SMEM_MAX = 231424  # dynamic shared memory a CTA may take: an H100's 227 KB less 1 KB


def _pass_smem(int8: bool, kbs: int, nt: int) -> int:
    """``pass_smem`` of ``csrc/decode_mlp.cu``: 1 KB to align, the bf16 weight
    slice, the activation tile and the cluster's fp32 partial sums of the
    CTA's rows, (cl, 64 / cl, nt + 2), which at nt 128 take the tile's place
    once the products are done, and, for int8 weights, the int8 slice."""
    tile, red = kbs * nt * 64 * 2, 64 * (nt + 2) * 4
    alias = nt >= 128 and tile >= red
    return 1024 + kbs * 64 * 64 * 2 + (tile if alias else tile + red) + (
        kbs * 64 * 64 if int8 else 0)


def _cluster(k: int, cap: int) -> Tuple[int, int]:
    """(CTAs, 64-wide blocks per CTA) splitting a contraction of k: the
    largest power of two <= cap that leaves no CTA without a block."""
    blocks, c = -(-k // 64), 1
    while c * 2 <= min(cap, blocks):
        c *= 2
    while (c - 1) * -(-blocks // c) >= blocks:
        c //= 2
    return c, -(-blocks // c)


@functools.lru_cache(maxsize=1024)
def plan(rows: int, d: int, f: int, int8: bool) -> Plan:
    """The bf16 kernel's launch for ``rows`` rows at widths (d, f): the
    smallest row tile that holds the rows (128 at most, the rest in row
    tiles), halved while a CTA's shared memory would not fit; contraction
    clusters of up to 4 CTAs over d and 8 over f."""
    (cl1, kbs1), (cl2, kbs2) = _cluster(d, CLUSTER_CAP[0]), _cluster(f, CLUSTER_CAP[1])
    nt = next(t for t in ROW_TILES if t >= min(max(rows, 1), ROW_TILES[-1]))
    def smem(t):
        return _pass_smem(int8, kbs1, t), _pass_smem(int8, kbs2, t)

    while nt > ROW_TILES[0] and max(smem(nt)) > SMEM_MAX:
        nt = ROW_TILES[ROW_TILES.index(nt) - 1]
    smem1, smem2 = smem(nt)
    if max(smem1, smem2) > SMEM_MAX:
        raise ValueError(f"fused_mlp: d {d}, f {f} need more shared memory than a CTA has")
    return Plan(nt, cl1, cl2, kbs1, kbs2, -(-rows // nt), -(-f // 64) * cl1, -(-d // 64) * cl2,
                smem1, smem2)


def _lib():
    return _bind(cuda_build.load("decode_mlp"))


def _bind(lib):
    """``lib`` (a build of ``csrc/decode_mlp.cu``) with its C signatures."""
    if lib.wf_decode_mlp.argtypes is None:
        lib.wf_decode_mlp_prepare.restype = ctypes.c_void_p
        lib.wf_decode_mlp_prepare.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.wf_decode_mlp_free.restype = None
        lib.wf_decode_mlp_free.argtypes = [ctypes.c_void_p]
        lib.wf_decode_mlp.restype = ctypes.c_int
        lib.wf_decode_mlp.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


def check_weights(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                  s1: Optional[torch.Tensor], s2: Optional[torch.Tensor],
                  dtype: torch.dtype) -> Tuple[int, int, int]:
    """Every check of a weight set for activations of ``dtype``: shapes,
    dtypes, one device, contiguity, d and f multiples of 16, 16-byte
    alignment. Raises on what the kernel cannot take; returns (d, f, the
    dtype's code)."""
    f, d = w1.shape
    quantized = s1 is not None
    wdt = torch.int8 if quantized else dtype
    if w1.shape != (f, d) or w2.shape != (d, f) or b1.shape != (f,) or b2.shape != (d,):
        raise ValueError("fused_mlp: weights must be (f, d) and (d, f), biases (f,) and (d,)")
    if w1.dtype != wdt or w2.dtype != wdt or b1.dtype != dtype or b2.dtype != dtype:
        raise TypeError("fused_mlp: the weights and biases must have x's dtype (or int8 "
                        "weights with scales)")
    if quantized and (s2 is None or s1.shape != (f,) or s2.shape != (d,)
                      or s1.dtype != torch.float32 or s2.dtype != torch.float32):
        raise ValueError("fused_mlp: int8 weights need float32 scales (f,) and (d,)")
    tensors = [w1, b1, w2, b2] + ([s1, s2] if quantized else [])
    if any(t.device != w1.device for t in tensors):
        raise ValueError("fused_mlp: all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_mlp: the operands must be contiguous")
    if d % 16 or f % 16:
        raise ValueError(f"fused_mlp: d ({d}) and f ({f}) must be multiples of 16")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("fused_mlp: the operands must be 16-byte aligned")
    return d, f, cuda_build.dtype_code(dtype, "fused_mlp")


# Weight sets already checked and prepared: id(w1) -> _Prepared. A hit needs
# the same tensor objects (a new tensor at a freed id fails the weak
# reference), at the same versions and data pointers (an in-place change, or
# new data under the same tensor object, checks and prepares again).
_CHECKED: dict = {}


def _state(tensors) -> tuple:
    return tuple(None if t is None else (t._version, t.data_ptr()) for t in tensors)


class _Prepared:
    """A checked weight set: weak references to its six tensors, their
    versions and data pointers, the x dtype, the device index, d, f, the
    dtype's code and the kernel library's handle (pointers, widths, tensor
    maps), freed with it."""

    __slots__ = ("refs", "state", "dtype", "device", "d", "f", "code", "handle", "__weakref__")

    def __init__(self, tensors, dtype, d, f, code):
        self.refs = tuple(None if t is None else weakref.ref(t) for t in tensors)
        self.state = _state(tensors)
        self.dtype, self.device, self.d, self.f, self.code = dtype, tensors[0].get_device(), d, f, code
        self.handle = None

    def matches(self, w1, b1, w2, b2, s1, s2, dtype) -> bool:
        r = self.refs
        if dtype is not self.dtype or r[0]() is not w1 or r[1]() is not b1 or r[2]() is not w2 \
                or r[3]() is not b2:
            return False
        if s1 is None:
            if r[4] is not None or s2 is not None or r[5] is not None:
                return False
        elif r[4] is None or r[4]() is not s1 or s2 is None or r[5] is None or r[5]() is not s2:
            return False
        return self.state == _state((w1, b1, w2, b2, s1, s2))


def _checked(w1, b1, w2, b2, s1, s2, dtype, prepare=False) -> _Prepared:
    """The weight set's checks, run when it is first seen (and after a
    change); with ``prepare`` also the kernel library's handle, made once."""
    hit = _CHECKED.get(id(w1))
    if hit is None or not hit.matches(w1, b1, w2, b2, s1, s2, dtype):
        tensors = (w1, b1, w2, b2, s1, s2)
        hit = _Prepared(tensors, dtype, *check_weights(w1, b1, w2, b2, s1, s2, dtype))
        _CHECKED[id(w1)] = hit
    if prepare and hit.handle is None:
        lib, err = _lib(), ctypes.c_int(0)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        handle = lib.wf_decode_mlp_prepare(ptr(w1), ptr(b1), ptr(s1), ptr(w2), ptr(b2), ptr(s2),
                                           hit.d, hit.f, hit.code, int(s1 is not None),
                                           ctypes.byref(err))
        cuda_build.check(err.value, "fused_mlp: preparing the weights")
        weakref.finalize(hit, lib.wf_decode_mlp_free, handle)
        hit.handle = handle
    return hit


# fc1's output `act` between the two passes: one buffer per (stream, device,
# dtype), grown to the largest (rows, f) seen. Calls on one stream run in
# order, so they can share it; calls on other streams have their own.
_SCRATCH: dict = {}


def _act(x: torch.Tensor, stream: int, n: int) -> int:
    key = (stream, x.get_device(), x.dtype)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < n:
        buf = _SCRATCH[key] = x.new_empty(max(n, 64 * 1024))
    return buf.data_ptr()


def _launch(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
            b2: torch.Tensor, s1: Optional[torch.Tensor], s2: Optional[torch.Tensor]) -> torch.Tensor:
    hit = _checked(w1, b1, w2, b2, s1, s2, x.dtype, prepare=True)
    d, f = hit.d, hit.f
    rows = x.shape[0]
    if x.dim() != 2 or x.shape[1] != d or x.get_device() != hit.device or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise ValueError(f"fused_mlp: x must be a contiguous, 16-byte aligned (rows, {d}) tensor "
                         f"on the weights' device")
    out = x.new_empty((rows, d))
    stream = cuda_build.stream_ptr(x)
    nt, cl1, cl2 = plan(rows, d, f, s1 is not None)[:3] if hit.code == 1 else (1, 1, 1)
    err = _lib().wf_decode_mlp(hit.handle, x.data_ptr(), _act(x, stream, rows * f),
                               out.data_ptr(), rows, nt, cl1, cl2, stream)
    cuda_build.check(err, "fused_mlp")
    fused_mlp.launches += 1
    return out


def fused_mlp(p: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """Drop-in for ``mlp_block(p, x)`` on the decode path: ``p`` is a
    layer's MLP (``p[0]`` fc1, ``p[2]`` fc2, plain or quantized by
    ``quantize_decode_params``), ``x`` (..., D) with the leading axes folded
    into rows. The JAX dispatch rule picks the kernel or ``mlp_block``.

    Under tensor parallelism (``p.tp``, fc1's output and fc2's input split)
    the kernel runs on this rank's shard with a zero fc2 bias; the partial
    outputs are summed over the model axis and the bias is added once,
    after the sum."""
    w1, w2, s1, s2 = _weights(p)
    f, d = w1.shape
    rows = x.numel() // x.shape[-1]
    tile = TILE_F if f % TILE_F == 0 else (f if f <= TILE_F else None)
    if tile is None or d % 8 or rows > MAX_ROWS:
        from ..models.whisper import mlp_block

        return mlp_block(p, x)
    x2 = x.reshape(rows, d)
    tp = getattr(p, "tp", None)
    b1, b2 = p[0].bias, p[2].bias if tp is None else _zero_bias(p)
    if x.device.type == "cpu":
        out = fused_mlp_plain(x2, w1, b1, w2, b2, s1, s2)
    elif x.device.type == "cuda":
        out = _launch(x2.contiguous(), w1, b1, w2, b2, s1, s2)
    else:
        raise RuntimeError(f"fused_mlp: no kernel for device {x.device}")
    if tp is not None:
        out = reduce_from_tp(out, tp) + p[2].bias.to(x.dtype)
    return out.reshape(x.shape)


def _zero_bias(p: nn.Sequential) -> torch.Tensor:
    """fc2's zero bias for the split kernel call, made once per layer (the
    kernel's prepared weight set holds the tensor itself)."""
    b2 = p[2].bias
    zero = getattr(p, "tp_zero_bias", None)
    if zero is None or zero.dtype != b2.dtype or zero.device != b2.device:
        zero = torch.zeros_like(b2)
        p.tp_zero_bias = zero
    return zero


fused_mlp.launches = 0
