"""Encoder self-attention at d_head 64: the CUDA kernels, their plain
versions and the autograd function over them.

Port of ``whisper_flamingo_tpu/ops/flash64.py``: the forward
(``_fwd_kernel`` through ``_flash64_forward``, with or without the row
logsumexp) and the backward (``_bwd_kernel`` through ``_flash64_bwd_rule``).
Contract as there: q/k/v are (B, H, T, 64) with q and k pre-scaled by
d_head^-0.25 by the caller; the attention is non-causal with no mask; the
softmax is fp32, the probabilities are cast to the input dtype before the
V product, and the output has the input dtype. The backward recomputes
``P = exp(S - lse)`` from the saved fp32 row logsumexp, takes
``D = rowsum(dO * O)`` in fp32 over the stored output, and rounds ``dS``
and ``P`` to the input dtype before its three products.

Left out, each a TPU workaround: the padding of T to a multiple of 512
(the kernels mask the ragged edge themselves); the ones-column row sum
(``FWD_SUM = "mxu"``, which took the softmax denominator from the V
product of the rounded probabilities: here, as in the JAX "vpu" variant,
the denominator and the lse are the fp32 row sum); the whole-row resident
K/V (the forward tiles K/V with an online softmax; the backward splits
into a dK/dV kernel and a dQ kernel; see ``csrc/flash64_fwd.cu`` and
``csrc/flash64_bwd.cu``).

:func:`flash64_attention` goes through :class:`Flash64Function` when grad
is enabled for any of q, k and v, and straight to :func:`flash64_forward`
otherwise (the inference forward writes no lse). :func:`flash64_forward`
and :func:`flash64_backward` run the plain versions for CPU tensors and
the kernels for CUDA tensors; on a CUDA tensor they launch the kernels or
raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from . import cuda_build

D_HEAD = 64
_c_i64 = ctypes.c_int64
_ptr = ctypes.c_void_p


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def flash64_forward_plain(
    qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, with_lse: bool = False
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The forward kernel's function in plain PyTorch (whole-row fp32
    softmax); with ``with_lse`` also the fp32 row logsumexp (B, H, T)."""
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    o = (torch.matmul(e.to(qh.dtype).float(), vh.float()) / l).to(qh.dtype)
    if with_lse:
        return o, (m + torch.log(l)).squeeze(-1)
    return o


def flash64_attention_plain(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor) -> torch.Tensor:
    """The inference forward in plain PyTorch."""
    return flash64_forward_plain(qh, kh, vh)


def flash64_backward_plain(
    qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function in plain PyTorch, with the roundings
    of ``_bwd_kernel`` / ``_flash64_bwd_rule``: dO cast to the input dtype;
    D, P, dP and dS in fp32; dS and P rounded to the input dtype before the
    products; dQ, dK and dV summed in fp32 and cast to the input dtype."""
    dt = qh.dtype
    g = do.to(dt).float()
    drow = (g * o.float()).sum(dim=-1, keepdim=True)
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    p = torch.exp(s - lse.unsqueeze(-1))
    dp = torch.matmul(g, vh.float().transpose(-1, -2))
    ds = (p * (dp - drow)).to(dt).float()
    p = p.to(dt).float()
    dq = torch.matmul(ds, kh.float()).to(dt)
    dk = torch.matmul(ds.transpose(-1, -2), qh.float()).to(dt)
    dv = torch.matmul(p.transpose(-1, -2), g).to(dt)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _fwd_lib():
    fn = cuda_build.load("flash64_fwd").wf_flash64_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [_ptr] * 5 + [ctypes.c_int] * 3 + [_c_i64] * 6 + [ctypes.c_int, _ptr]
    return fn


def _bwd_lib():
    fn = cuda_build.load("flash64_bwd").wf_flash64_bwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [_ptr] * 10 + [ctypes.c_int] * 3 + [_c_i64] * 12 + [ctypes.c_int, _ptr]
    return fn


def _check_device(x: torch.Tensor, what: str) -> bool:
    """True for a CPU tensor (the plain version), False for a CUDA tensor
    (the kernel); any other device raises."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {x.device}")
    return False


def _check_qkv(qh, kh, vh, what: str) -> int:
    """Validate q/k/v for the kernels; returns the dtype code."""
    b, h, t, d = qh.shape
    if d != D_HEAD:
        raise ValueError(f"{what} takes d_head 64, got {d}")
    if kh.shape != qh.shape or vh.shape != qh.shape:
        raise ValueError(f"{what}: q, k and v must have one shape")
    if not (qh.dtype == kh.dtype == vh.dtype):
        raise TypeError(f"{what}: q, k and v must have one dtype")
    if not (qh.device == kh.device == vh.device):
        raise ValueError(f"{what}: q, k and v must be on one device")
    strides = qh.stride()
    if kh.stride() != strides or vh.stride() != strides or strides[-1] != 1:
        raise ValueError(
            f"{what}: q, k and v must share one stride layout with "
            f"a unit last stride (got {qh.stride()}, {kh.stride()}, {vh.stride()})"
        )
    if b * h > 65535:
        raise ValueError(f"{what}: batch * heads exceeds 65535")
    return cuda_build.dtype_code(qh.dtype, what)


def _check_rows16(what: str, *xs: torch.Tensor) -> None:
    """The bf16 tensor-core kernels read rows in 16-byte pieces."""
    for x in xs:
        if x.dtype == torch.bfloat16 and (
            any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16
        ):
            raise ValueError(f"{what}: bf16 rows must be 16-byte aligned")


def _head_split_out(b: int, h: int, t: int, like: torch.Tensor) -> torch.Tensor:
    """An uninitialized (B, H, T, 64) head-split view of a contiguous
    (B, T, H*64) buffer, so merging the heads back costs no copy."""
    return torch.empty((b, t, h, D_HEAD), dtype=like.dtype, device=like.device).permute(0, 2, 1, 3)


def flash64_forward(
    qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, *, with_lse: bool = False
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """(B, H, T, 64) pre-scaled q/k/v -> the attention output, and with
    ``with_lse`` also the fp32 row logsumexp (B, H, T) the backward reads.

    q/k/v may be the head-split views of (B, T, H*64) projections (they
    must share one stride layout with a unit last stride); the output is
    the head-split view of a contiguous (B, T, H*64) tensor."""
    if _check_device(qh, "flash64_forward"):
        return flash64_forward_plain(qh, kh, vh, with_lse)
    code = _check_qkv(qh, kh, vh, "flash64_forward")
    _check_rows16("flash64_forward", qh, kh, vh)
    b, h, t, _ = qh.shape
    strides = qh.stride()
    out = _head_split_out(b, h, t, qh)
    lse: Optional[torch.Tensor] = None
    if with_lse:
        lse = torch.empty((b, h, t), dtype=torch.float32, device=qh.device)
    ob, oh, ot, _ = out.stride()
    err = _fwd_lib()(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, h, t, strides[0], strides[1], strides[2], ob, oh, ot,
        code, cuda_build.stream_ptr(qh),
    )
    cuda_build.check(err, "flash64_forward")
    flash64_forward.launches += 1
    flash64_forward.lse_launches += with_lse
    return (out, lse) if with_lse else out


flash64_forward.launches = 0  # every launch
flash64_forward.lse_launches = 0  # the launches that also wrote the lse (training)


def flash64_backward(
    qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) of the attention from the forward's inputs, output and
    lse and the output's gradient ``do``.

    q/k/v share one stride layout, as in the forward; ``o`` and ``do`` are
    taken by their own strides (``do`` arrives through the head merge as
    the head-split view of a (B, T, H*64) gradient), with a unit last
    stride (``do`` is made contiguous otherwise). The gradients are
    head-split views of contiguous (B, T, H*64) buffers. One call launches
    the three kernels of ``csrc/flash64_bwd.cu`` (the D row pass, dK/dV,
    dQ) and counts one."""
    if _check_device(qh, "flash64_backward"):
        return flash64_backward_plain(qh, kh, vh, o, lse, do)
    code = _check_qkv(qh, kh, vh, "flash64_backward")
    do = do.to(qh.dtype)
    if do.stride()[-1] != 1:
        do = do.contiguous()
    b, h, t, _ = qh.shape
    if o.shape != qh.shape or do.shape != qh.shape or o.dtype != qh.dtype:
        raise ValueError("flash64_backward: o and do must match q's shape and dtype")
    if o.stride()[-1] != 1:
        raise ValueError("flash64_backward: o must have a unit last stride")
    if lse.shape != (b, h, t) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash64_backward: lse must be a contiguous fp32 (B, H, T) tensor")
    if not (o.device == do.device == lse.device == qh.device):
        raise ValueError("flash64_backward: every input must be on one device")
    _check_rows16("flash64_backward", qh, kh, vh, o, do)
    dq, dk, dv = (_head_split_out(b, h, t, qh) for _ in range(3))
    drow = torch.empty((b, h, t), dtype=torch.float32, device=qh.device)
    s, os_, gs, xs = qh.stride(), o.stride(), do.stride(), dq.stride()
    err = _bwd_lib()(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), drow.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, t, s[0], s[1], s[2], os_[0], os_[1], os_[2], gs[0], gs[1], gs[2],
        xs[0], xs[1], xs[2], code, cuda_build.stream_ptr(qh),
    )
    cuda_build.check(err, "flash64_backward")
    flash64_backward.launches += 1
    return dq, dk, dv


flash64_backward.launches = 0


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------

class Flash64Function(torch.autograd.Function):
    """The forward with its lse, saved with q/k/v and the output for the
    backward kernels (the JAX ``custom_vjp``). Both look up
    :func:`flash64_forward` / :func:`flash64_backward` at call time, so a
    caller can substitute the plain versions module-wide."""

    @staticmethod
    def forward(ctx, qh, kh, vh):
        o, lse = flash64_forward(qh, kh, vh, with_lse=True)
        ctx.save_for_backward(qh, kh, vh, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        qh, kh, vh, o, lse = ctx.saved_tensors
        return flash64_backward(qh, kh, vh, o, lse, do)


def flash64_attention(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 64) pre-scaled q/k/v -> (B, H, T, 64) attention output;
    differentiable through :class:`Flash64Function` when grad is enabled
    for any input, the inference forward (no lse) otherwise."""
    if torch.is_grad_enabled() and (qh.requires_grad or kh.requires_grad or vh.requires_grad):
        return Flash64Function.apply(qh, kh, vh)
    return flash64_forward(qh, kh, vh)
