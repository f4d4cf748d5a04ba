"""The tensor-parallel collectives inside the model: the two Megatron
operators, the vocabulary-parallel embedding and logits.

In JAX, GSPMD inserted these where a sharded operand met a replicated one;
here :mod:`..models.whisper` calls them where the layout of
:mod:`.mesh` needs them:

- :func:`copy_to_tp` at the input of the column-parallel projections
  (q/k/v, ``fc1``, the vocabulary-split logits): identity forward,
  ``all_reduce`` of the gradient backward (each rank holds part of the
  input's gradient);
- :func:`reduce_from_tp` after the row-parallel ones (``out``, ``fc2``):
  ``all_reduce`` forward, identity backward; the replicated bias is added
  after it, once;
- :func:`vocab_embedding`: the masked lookup of this rank's vocabulary
  rows, then :func:`reduce_from_tp`;
- :func:`vocab_parallel_nll`: the cross-entropy over vocabulary-split
  logits (``all_reduce`` of the row max, of the sum of exponentials and
  of the target logit), for training; :func:`gather_from_tp` gathers the
  full logits for decoding and distillation.

Every function takes the mesh that marks the split module (``module.tp``)
and is the identity when it is ``None`` or the model axis has one rank, so
the one-device path does not change by a bit. Each rank of a model row
computes the same replicated values (an ``all_reduce`` gives every rank
the same bits), so replicated parameters get the same gradient on each.
"""

from __future__ import annotations

from typing import Optional

import torch

from .mesh import MODEL_AXIS, Mesh


def _active(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.n_model > 1


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.clone(), MODEL_AXIS), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.clone(), MODEL_AXIS)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.block = mesh, dim, x.shape[dim]
        return mesh.all_gather(x.contiguous(), MODEL_AXIS, dim)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.mesh.model_index * ctx.block
        return grad.narrow(ctx.dim, start, ctx.block), None, None


def copy_to_tp(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    if not _active(mesh) or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToTP.apply(x, mesh)


def reduce_from_tp(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    if not _active(mesh):
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        return mesh.all_reduce(x.contiguous(), MODEL_AXIS)
    return _ReduceFromTP.apply(x, mesh)


def gather_from_tp(x: torch.Tensor, mesh: Optional[Mesh], dim: int = -1) -> torch.Tensor:
    """The model row's blocks of ``x`` along ``dim``, concatenated; the
    gradient of each rank's block is its slice of the full gradient."""
    if not _active(mesh):
        return x
    dim = dim % x.dim()
    if not (torch.is_grad_enabled() and x.requires_grad):
        return mesh.all_gather(x.contiguous(), MODEL_AXIS, dim)
    return _GatherFromTP.apply(x, mesh, dim)


def vocab_embedding(weight: torch.Tensor, tokens: torch.Tensor,
                    mesh: Optional[Mesh]) -> torch.Tensor:
    """``weight[tokens]`` with ``weight`` this rank's contiguous block of
    vocabulary rows: rows of other ranks' tokens are zero before the
    reduction."""
    if not _active(mesh):
        return weight[tokens]
    rows = weight.shape[0]
    local = tokens - mesh.model_index * rows
    inside = (local >= 0) & (local < rows)
    out = weight[local.clamp(0, rows - 1)]
    out = torch.where(inside[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    return reduce_from_tp(out, mesh)


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor,
                       mesh: Mesh) -> torch.Tensor:
    """Per-position ``-log softmax(logits)[target]`` over the full
    vocabulary from this rank's fp32 block of it, (..., V / n_model);
    ``targets`` are valid ids (masked positions clamped by the caller)."""
    v = logits.shape[-1]
    m = logits.detach().amax(dim=-1, keepdim=True)
    mesh.all_reduce(m, MODEL_AXIS, "max")
    shifted = logits - m
    sum_exp = reduce_from_tp(torch.exp(shifted).sum(dim=-1), mesh)
    local = targets - mesh.model_index * v
    inside = (local >= 0) & (local < v)
    target = torch.gather(shifted, -1, local.clamp(0, v - 1)[..., None])[..., 0]
    target = reduce_from_tp(torch.where(inside, target, torch.zeros_like(target)), mesh)
    return torch.log(sum_exp) - target
