"""Optimizers and schedules, written by hand to optax's rules.

Port of ``whisper_flamingo_tpu/training/optim.py``:

- :func:`whisper_optimizer`: AdamW with the reference's no-decay split
  (biases and LayerNorm weights take no weight decay; everything else,
  the positional embedding and the tanh gates included, does) and a
  linear warmup -> linear decay schedule;
- :func:`whisper_flamingo_optimizer`: only the gated x-attn parameter group
  trains (everything under the decoder blocks' ``gated_x_attn_layers``,
  ``ff_ln``, ``ff`` and ``ff_gate``), with uniform decay.

The update is optax's ``adamw`` (``scale_by_adam`` -> ``add_decayed_weights``
-> ``scale_by_learning_rate``) with the schedule read at the count of
applied updates; ``optax.MultiSteps`` accumulation (the running mean of k
gradients, the schedule and the Adam count advancing only on applied
updates); ``clip_by_global_norm`` (``torch.nn.utils.clip_grad_norm_`` adds
1e-6 to the norm and differs). Frozen parameters are left out of the
optimizer and do not require grad (optax's ``set_to_zero`` gave them zero
updates). Parameters are updated in place.

Masks are ``{parameter name: bool}`` over the model's OpenAI-keyed
parameters. ``optimizer="adafactor"`` is not ported yet and raises.

Under a mesh (:meth:`WhisperOptimizer.shard`, after
:func:`..parallel.mesh.shard_params`) the moments are sliced like their
parameters, each step first averages the gradients over the data axis in
one flat ``all_reduce``, and clipping reads the global norm: the squares
of split parameters summed over the model axis, each replicated parameter
counted once (its gradient is the same on every rank of a model row).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..parallel.mesh import DATA_AXIS, MODEL_AXIS

import numpy as np
import torch
from torch import nn

Mask = Dict[str, bool]


def linear_warmup_schedule(lr: float, warmup_steps: int, total_steps: int) -> Callable[[int], float]:
    """0 -> lr over warmup, then linearly to 0 at total_steps, as a
    function of the count of applied updates. The value is optax's
    ``join_schedules`` of two ``linear_schedule`` s computed in float32."""
    w, d = max(warmup_steps, 1), max(total_steps - warmup_steps, 1)

    def linear(init: float, end: float, steps: int, count: int) -> float:
        c = np.float32(min(max(count, 0), steps))
        frac = np.float32(1) - c / np.float32(steps)
        return float(np.float32(init - end) * frac + np.float32(end))

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return linear(0.0, lr, w, count)
        return linear(lr, 0.0, d, count - warmup_steps)

    return schedule


def no_decay_mask(model: nn.Module) -> Mask:
    """True where weight decay applies: everywhere but biases and
    LayerNorm weights (the reference's ``no_decay = ["bias",
    "LayerNorm.weight"]``)."""
    out: Mask = {}
    for mod_name, mod in model.named_modules():
        for name, _ in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            out[full] = not (name == "bias" or isinstance(mod, nn.LayerNorm))
    return out


def _is_gated(name: str) -> bool:
    parts = name.split(".")
    return (
        len(parts) > 3 and parts[0] == "decoder" and parts[1] == "blocks"
        and parts[3] in ("gated_x_attn_layers", "ff_ln", "ff", "ff_gate")
    )


def flamingo_trainable_mask(model: nn.Module, train_xt_projection: bool = False) -> Mask:
    """True for the gated x-attn parameter group."""
    return {
        name: _is_gated(name) or (train_xt_projection and name.startswith("decoder.xt_projection."))
        for name, _ in model.named_parameters()
    }


def encoder_frozen_mask(model: nn.Module) -> Mask:
    """True for everything except the encoder (``freeze_encoder``)."""
    return {name: not name.startswith("encoder.") for name, _ in model.named_parameters()}


class WhisperOptimizer:
    """AdamW over the trainable parameters, with optional global-norm
    clipping and k-step gradient accumulation. :meth:`step` reads each
    parameter's ``.grad``, clears it and updates the parameters in place;
    it returns whether an update was applied."""

    def __init__(
        self, named_params: Dict[str, torch.Tensor], decay: Mask, schedule: Callable[[int], float],
        *, weight_decay: float, eps: float, b1: float = 0.9, b2: float = 0.999,
        max_grad_norm: Optional[float] = None, accumulate_steps: int = 1,
    ):
        self.names: List[str] = list(named_params)
        self.params: List[torch.Tensor] = [named_params[n] for n in self.names]
        self.decay_idx = [i for i, n in enumerate(self.names) if decay[n]]
        self.schedule = schedule
        self.weight_decay, self.eps, self.b1, self.b2 = weight_decay, eps, b1, b2
        self.max_grad_norm = max_grad_norm
        self.accumulate_steps = accumulate_steps
        self.count = 0  # applied updates: the schedule's and Adam's count
        self.mini_step = 0  # gradients accumulated since the last update
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = [torch.zeros_like(p) for p in self.params] if accumulate_steps > 1 else []
        self.mesh = None
        self.tp_dims: List[Optional[int]] = [None] * len(self.params)

    def shard(self, mesh, dims: Dict[str, Optional[int]]) -> "WhisperOptimizer":
        """Run under ``mesh``: ``dims`` is the model's layout (``tp_dims``);
        moments still at a parameter's full shape (made, or restored,
        before :func:`..parallel.mesh.shard_params`) take this rank's
        block."""
        self.mesh = mesh
        self.tp_dims = [dims.get(n) if mesh.n_model > 1 else None for n in self.names]
        for state in (self.mu, self.nu, self.acc):
            for i, t in enumerate(state):
                dim, p = self.tp_dims[i], self.params[i]
                if dim is not None and t.shape != p.shape:
                    block = p.shape[dim]
                    state[i] = t.narrow(dim, mesh.model_index * block, block).clone()
        return self

    @property
    def lr(self) -> float:
        """The learning rate of the next applied update."""
        return self.schedule(self.count)

    def _grads(self) -> List[torch.Tensor]:
        grads = []
        for name, p in zip(self.names, self.params):
            if p.grad is None:
                raise RuntimeError(f"no gradient for trainable parameter {name!r}")
            grads.append(p.grad)
            p.grad = None
        mesh = self.mesh
        if mesh is not None and mesh.n_data > 1 and grads:  # the data-parallel average
            flat = torch.cat([g.reshape(-1) for g in grads])  # fp32: trainable masters
            mesh.all_reduce(flat, DATA_AXIS).div_(mesh.n_data)
            grads = [part.view_as(g) for g, part in zip(grads, flat.split([g.numel() for g in grads]))]
        return grads

    def _clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        split = [i for i, d in enumerate(self.tp_dims) if d is not None]
        if not split:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        else:  # the global norm: split squares summed over the model axis
            sq = [torch.sum(g * g) for g in grads]
            part = self.mesh.all_reduce(sum(sq[i] for i in split).clone(), MODEL_AXIS)
            g_norm = torch.sqrt(part + sum(sq[i] for i in range(len(sq)) if i not in split))
        keep = g_norm < self.max_grad_norm
        return [torch.where(keep, g, (g / g_norm) * self.max_grad_norm) for g in grads]

    @torch.no_grad()
    def step(self) -> bool:
        grads = self._grads()
        if not grads:  # nothing trains: empty updates, the counts advance
            self.mini_step = (self.mini_step + 1) % self.accumulate_steps
            self.count += self.mini_step == 0
            return self.mini_step == 0
        if self.accumulate_steps > 1:
            # optax.MultiSteps: acc += (g - acc) / (n + 1), applied on the k-th
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, diff)
            self.mini_step = (self.mini_step + 1) % self.accumulate_steps
            if self.mini_step:
                return False
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
        if self.max_grad_norm:
            grads = self._clip(grads)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        n = np.float32(self.count + 1)
        bc1 = float(np.float32(1) - np.float32(b1) ** n)
        bc2 = float(np.float32(1) - np.float32(b2) ** n)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(updates, denom)
        if self.weight_decay and self.decay_idx:
            torch._foreach_add_(
                [updates[i] for i in self.decay_idx], [self.params[i] for i in self.decay_idx],
                alpha=self.weight_decay,
            )
        torch._foreach_add_(self.params, updates, alpha=-self.lr)
        self.count += 1
        return True

    def state_dict(self) -> Dict[str, object]:
        return {
            "names": list(self.names), "count": self.count, "mini_step": self.mini_step,
            "mu": self.mu, "nu": self.nu, "acc": self.acc,
        }

    def full_state_dict(self) -> Dict[str, object]:
        """:meth:`state_dict` with split moments gathered to full shapes
        (every rank of the model axis must call it)."""
        out = self.state_dict()
        if self.mesh is not None:
            for key in ("mu", "nu", "acc"):
                out[key] = [t if d is None else self.mesh.all_gather(t, MODEL_AXIS, d)
                            for t, d in zip(out[key], self.tp_dims)]
        return out

    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Restore a :meth:`state_dict`; raises where the parameter set or
        the accumulation differ."""
        if list(state["names"]) != self.names:
            raise ValueError("optimizer state: the trainable parameters differ")
        if len(state["acc"]) != len(self.acc):
            raise ValueError("optimizer state: the gradient accumulation differs")
        for dst, key in ((self.mu, "mu"), (self.nu, "nu"), (self.acc, "acc")):
            for d, s in zip(dst, state[key]):
                d.copy_(s)
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])


def _build(
    model: nn.Module, trainable: Mask, decay: Mask, schedule, *, optimizer: str,
    weight_decay: float, adam_epsilon: float, max_grad_norm, accumulate_steps: int,
) -> WhisperOptimizer:
    if optimizer == "adafactor":
        raise NotImplementedError("optimizer='adafactor' is not ported yet (use 'adamw')")
    if optimizer != "adamw":
        raise ValueError(f"unknown optimizer {optimizer!r} (adamw|adafactor)")
    named = {}
    for name, p in model.named_parameters():
        p.requires_grad_(bool(trainable[name]))
        if trainable[name]:
            named[name] = p
    return WhisperOptimizer(
        named, decay, schedule, weight_decay=weight_decay, eps=adam_epsilon,
        max_grad_norm=max_grad_norm, accumulate_steps=accumulate_steps,
    )


def whisper_optimizer(
    model: nn.Module, learning_rate: float, *, weight_decay: float = 0.01,
    adam_epsilon: float = 1e-8, warmup_steps: int = 0, total_steps: int = 100_000,
    trainable_mask: Optional[Mask] = None, max_grad_norm: Optional[float] = None,
    accumulate_steps: int = 1, optimizer: str = "adamw",
):
    """AdamW + linear warmup/decay with the no-decay split; returns
    ``(optimizer, schedule)``. ``trainable_mask`` freezes parameters (e.g.
    the encoder): they stop requiring grad. Clipping is off by default, as
    in the reference."""
    schedule = linear_warmup_schedule(learning_rate, warmup_steps, total_steps)
    trainable = trainable_mask or {n: True for n, _ in model.named_parameters()}
    tx = _build(
        model, trainable, no_decay_mask(model), schedule, optimizer=optimizer,
        weight_decay=weight_decay, adam_epsilon=adam_epsilon, max_grad_norm=max_grad_norm,
        accumulate_steps=accumulate_steps,
    )
    return tx, schedule


def whisper_flamingo_optimizer(
    model: nn.Module, learning_rate: float, *, weight_decay: float = 0.01,
    adam_epsilon: float = 1e-8, warmup_steps: int = 0, total_steps: int = 100_000,
    train_xt_projection: bool = False, max_grad_norm: Optional[float] = None,
    accumulate_steps: int = 1, optimizer: str = "adamw",
):
    """Gated-x-attn-only AdamW (one parameter group, decay applied
    uniformly); returns ``(optimizer, schedule)``."""
    schedule = linear_warmup_schedule(learning_rate, warmup_steps, total_steps)
    uniform = {n: True for n, _ in model.named_parameters()}
    tx = _build(
        model, flamingo_trainable_mask(model, train_xt_projection), uniform, schedule,
        optimizer=optimizer, weight_decay=weight_decay, adam_epsilon=adam_epsilon,
        max_grad_norm=max_grad_norm, accumulate_steps=accumulate_steps,
    )
    return tx, schedule
