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
parameters.

``optimizer="adafactor"`` (:class:`Adafactor`) is optax 0.2.6's
``adafactor(schedule, multiply_by_parameter_scale=False, momentum=None)``
chained with the JAX package's scheduled decoupled decay: factored second
moments (``min_dim_size_to_factor`` 128, decay ``1 - (t+1)^-0.8``, eps
1e-30 on g²), ``clip_by_block_rms(1.0)``, ``-lr``, then ``-lr * wd * p``
on the decay mask. optax works on the JAX package's leaves, so each
factorization is computed in the JAX leaf's axis order (linears (in, out),
convs (k, in, out)) and each block RMS is taken over the whole stacked leaf:
every layer of one kind (and every stream of a gated layer) shares one
clipping factor. The layout comes from :func:`..convert.jax_leaf`.

Under a mesh (:meth:`WhisperOptimizer.shard`, after
:func:`..parallel.mesh.shard_params`) the moments are sliced like their
parameters, each step first averages the gradients over the data axis in
one flat ``all_reduce`` (span ``train.allreduce``, its bytes added to the
counter ``train.allreduce_bytes``), and clipping reads the global norm: the squares
of split parameters summed over the model axis, each replicated parameter
counted once (its gradient is the same on every rank of a model row).
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional

from .. import profiling
from ..convert import JaxLeaf, jax_leaf
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

    STATE = ("mu", "nu", "acc")  # the per-parameter state lists

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
        self.acc = [torch.zeros_like(p) for p in self.params] if accumulate_steps > 1 else []
        self.mesh = None
        self.tp_dims: List[Optional[int]] = [None] * len(self.params)
        self._init_state()

    def _init_state(self) -> None:
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def _state_dim(self, key: str, i: int) -> Optional[int]:
        """The dim of ``key``'s i-th tensor that the model axis splits."""
        return self.tp_dims[i]

    def shard(self, mesh, dims: Dict[str, Optional[int]]) -> "WhisperOptimizer":
        """Run under ``mesh``: ``dims`` is the model's layout (``tp_dims``);
        state still at a parameter's full size (made, or restored, before
        :func:`..parallel.mesh.shard_params`) takes this rank's block."""
        self.mesh = mesh
        self.tp_dims = [dims.get(n) if mesh.n_model > 1 else None for n in self.names]
        for key in self.STATE:
            state = getattr(self, key)
            for i, t in enumerate(state):
                dim, p = self._state_dim(key, i), self.params[i]
                if dim is not None and t.shape[dim] != p.shape[dim]:
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
            profiling.count("train.allreduce_bytes", flat.numel() * flat.element_size())
            with profiling.span("train.allreduce"):
                mesh.all_reduce(flat, DATA_AXIS)
            flat.div_(mesh.n_data)
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
        self._update(grads)
        self.count += 1
        return True

    def _update(self, grads: List[torch.Tensor]) -> None:
        """AdamW: optax's ``scale_by_adam`` -> ``add_decayed_weights`` ->
        ``-lr``."""
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

    def state_bytes(self) -> int:
        """Bytes of the optimizer's statistics (AdamW's moments, Adafactor's
        factored state); the accumulation buffers are left out."""
        return sum(t.numel() * t.element_size() for key in self.STATE if key != "acc"
                   for t in getattr(self, key))

    def state_dict(self) -> Dict[str, object]:
        return {
            "names": list(self.names), "count": self.count, "mini_step": self.mini_step,
            **{key: getattr(self, key) for key in self.STATE},
        }

    def full_state_dict(self) -> Dict[str, object]:
        """:meth:`state_dict` with split state gathered to full shapes
        (every rank of the model axis must call it)."""
        out = self.state_dict()
        if self.mesh is not None:
            for key in self.STATE:
                out[key] = [t if self._state_dim(key, i) is None
                            else self.mesh.all_gather(t, MODEL_AXIS, self._state_dim(key, i))
                            for i, t in enumerate(out[key])]
        return out

    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Restore a :meth:`state_dict`; raises where the parameter set or
        the accumulation differ."""
        if list(state["names"]) != self.names:
            raise ValueError("optimizer state: the trainable parameters differ")
        if len(state["acc"]) != len(self.acc):
            raise ValueError("optimizer state: the gradient accumulation differs")
        if any(key not in state for key in self.STATE):
            raise ValueError("optimizer state: another optimizer's state")
        for key in self.STATE:
            for d, s in zip(getattr(self, key), state[key]):
                d.copy_(s)
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])


class Adafactor(WhisperOptimizer):
    """optax's Adafactor with no momentum and no parameter scaling, then
    the scheduled decoupled decay; accumulation, global-norm clipping and
    the data-parallel average as :class:`WhisperOptimizer`.

    ``layout[name]`` is a parameter's place in the JAX tree
    (:func:`..convert.jax_leaf`: its stacked leaf, its indices there, its
    torch dims in the leaf's per-layer order). A parameter is factored when the
    second largest dim of its whole JAX leaf (layer axes first) is at
    least ``min_dim_size_to_factor``: ``v_row`` is the mean of g² + eps
    over the largest dim, ``v_col`` over the second (ties: the earlier JAX
    axis is the second), both kept with the reduced dim as 1; the update is
    ``g * (v_row / mean(v_row))^-1/2 * v_col^-1/2``. Otherwise ``v`` is the
    elementwise mean and the update ``g * v^-1/2``. Unused state is a
    (1,) zero, as in optax. The factored dims come from the full shapes,
    so build it before :func:`..parallel.mesh.shard_params`; under a mesh
    each mean that spans a split dim, and each block RMS of a split leaf,
    sums over the model axis."""

    STATE = ("v_row", "v_col", "v", "acc")

    def __init__(
        self, named_params: Dict[str, torch.Tensor], decay: Mask, schedule: Callable[[int], float],
        *, layout: Dict[str, JaxLeaf], weight_decay: float,
        max_grad_norm: Optional[float] = None, accumulate_steps: int = 1,
        decay_rate: float = 0.8, eps: float = 1e-30, min_dim_size_to_factor: int = 128,
        clipping_threshold: float = 1.0,
    ):
        self.decay_rate, self.clipping_threshold = decay_rate, clipping_threshold
        self._layout, self._min_dim = layout, min_dim_size_to_factor
        super().__init__(named_params, decay, schedule, weight_decay=weight_decay, eps=eps,
                         max_grad_norm=max_grad_norm, accumulate_steps=accumulate_steps)

    def _init_state(self) -> None:
        layout = [self._layout[n] for n in self.names]
        self.groups: Dict[str, List[int]] = {}
        for i, leaf in enumerate(layout):
            self.groups.setdefault(leaf.key, []).append(i)
        self.factored: List[Optional[tuple]] = []  # (row dim, col dim) in torch dims
        for i, (name, p) in enumerate(zip(self.names, self.params)):
            ax, group = layout[i].axes, self.groups[layout[i].key]
            # the JAX leaf's shape: one axis per stacked index, then the layer's
            stack = [len({layout[j].index[k] for j in group})
                     for k in range(len(layout[i].index))]
            shape = tuple(stack) + tuple(p.shape[a] for a in ax)
            order = np.argsort(shape)
            if len(shape) < 2 or shape[order[-2]] < self._min_dim:
                self.factored.append(None)
                continue
            d1, d0 = int(order[-2]) - len(stack), int(order[-1]) - len(stack)
            if min(d1, d0) < 0:
                raise ValueError(f"adafactor: {name} would factor over a stacked axis {shape}")
            self.factored.append((ax[d0], ax[d1]))
        self.v_row, self.v_col, self.v = [], [], []
        for p, fd in zip(self.params, self.factored):
            z = p.new_zeros(1)
            if fd is None:
                self.v_row.append(z), self.v_col.append(z.clone()), self.v.append(torch.zeros_like(p))
            else:
                self.v_row.append(p.new_zeros(_reduced(p.shape, fd[0])))
                self.v_col.append(p.new_zeros(_reduced(p.shape, fd[1])))
                self.v.append(z)

    def _state_dim(self, key: str, i: int) -> Optional[int]:
        dim, fd = self.tp_dims[i], self.factored[i]
        if key == "acc" or dim is None:
            return dim
        if key == "v":
            return dim if fd is None else None
        if fd is None:
            return None
        reduced = fd[0] if key == "v_row" else fd[1]
        return None if dim == reduced else dim

    def _mean(self, x: torch.Tensor, dim: int, split: bool) -> torch.Tensor:
        """The mean over ``dim`` (kept as 1); over the model axis too when
        ``dim`` is split."""
        if not split:
            return x.mean(dim, keepdim=True)
        total = self.mesh.all_reduce(x.sum(dim, keepdim=True), MODEL_AXIS)
        return total / (x.shape[dim] * self.mesh.n_model)

    def _update(self, grads: List[torch.Tensor]) -> None:
        t = np.float32(self.count + 1)
        beta = float(np.float32(1) - t ** np.float32(-self.decay_rate))
        updates = []
        for i, (g, fd) in enumerate(zip(grads, self.factored)):
            dim = self.tp_dims[i]
            g2 = g * g + self.eps
            if fd is None:
                self.v[i].mul_(beta).add_(g2, alpha=1 - beta)
                updates.append(g * self.v[i].rsqrt())
                continue
            row, col = fd  # v_row reduces the row dim (the largest), v_col the col dim
            self.v_row[i].mul_(beta).add_(self._mean(g2, row, dim == row), alpha=1 - beta)
            self.v_col[i].mul_(beta).add_(self._mean(g2, col, dim == col), alpha=1 - beta)
            row_col_mean = self._mean(self.v_row[i], col, dim == col and dim != row)
            row_factor = (self.v_row[i] / row_col_mean).rsqrt()
            updates.append(g * row_factor * self.v_col[i].rsqrt())
        # clip_by_block_rms: one RMS over each whole stacked JAX leaf
        for idx in self.groups.values():
            sq = sum(torch.sum(updates[i] * updates[i]) for i in idx)
            numel = sum(updates[i].numel() for i in idx)
            if self.tp_dims[idx[0]] is not None:
                sq = self.mesh.all_reduce(sq.clone(), MODEL_AXIS)
                numel *= self.mesh.n_model
            denom = torch.clamp(torch.sqrt(sq / numel) / self.clipping_threshold, min=1.0)
            for i in idx:
                updates[i] = updates[i] / denom
        lr = self.lr
        torch._foreach_mul_(updates, lr)
        if self.weight_decay and self.decay_idx:  # u -= schedule(count) * wd * p
            coef = float(np.float32(lr) * np.float32(self.weight_decay))
            torch._foreach_add_(
                [updates[i] for i in self.decay_idx], [self.params[i] for i in self.decay_idx],
                alpha=coef,
            )
        torch._foreach_sub_(self.params, updates)


def _reduced(shape, dim: int) -> tuple:
    out = list(shape)
    out[dim] = 1
    return tuple(out)


def _build(
    model: nn.Module, trainable: Mask, decay: Mask, schedule, *, optimizer: str,
    weight_decay: float, adam_epsilon: float, max_grad_norm, accumulate_steps: int,
) -> WhisperOptimizer:
    if optimizer not in ("adamw", "adafactor"):
        raise ValueError(f"unknown optimizer {optimizer!r} (adamw|adafactor)")
    named = {}
    for name, p in model.named_parameters():
        p.requires_grad_(bool(trainable[name]))
        if trainable[name]:
            named[name] = p
    if optimizer == "adafactor":
        if adam_epsilon != 1e-8:
            warnings.warn(
                f"adam_epsilon={adam_epsilon} has no effect with "
                "optimizer='adafactor' (Adafactor has its own eps pair)",
                stacklevel=3,
            )
        return Adafactor(
            named, decay, schedule, layout={n: jax_leaf(model, n) for n in named},
            weight_decay=weight_decay,
            max_grad_norm=max_grad_norm, accumulate_steps=accumulate_steps,
        )
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
