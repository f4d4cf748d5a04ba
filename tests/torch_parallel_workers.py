"""Rank bodies for the port's multi-rank tests (``test_torch_parallel*.py``).

Torch-only: the ranks are fresh processes started by
``whisper_flamingo_tpu_torch.parallel.distributed.spawn`` (gloo on the
CPU, one thread each), and this module imports neither JAX nor the JAX
package. Each body takes a list of case specs and returns one result per
case, so one process group serves several tests.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from whisper_flamingo_tpu_torch.decoding import DecodingOptions, DecodingTask
from whisper_flamingo_tpu_torch.models.dims import ModelDimensions
from whisper_flamingo_tpu_torch.models.whisper import ModelExtras, Whisper
from whisper_flamingo_tpu_torch.ops import decode_mlp
from whisper_flamingo_tpu_torch.parallel.mesh import (
    gather_named,
    make_mesh,
    shard_batch,
    shard_params,
)
from whisper_flamingo_tpu_torch.training.checkpoints import load_torch_state
from whisper_flamingo_tpu_torch.training.optim import whisper_flamingo_optimizer, whisper_optimizer
from whisper_flamingo_tpu_torch.training.steps import (
    TrainState,
    make_ce_train_step,
    make_eval_step,
    make_kd_train_step,
    make_prompt_kd_train_step,
)


def load(spec: Dict[str, Any], key: str = "state") -> Whisper:
    dims = ModelDimensions(**spec["dims"])
    extras = ModelExtras(**spec.get("extras", {})) if key == "state" else ModelExtras()
    return load_torch_state(torch.load(spec[key]), dims, extras, device="cpu")


def _mesh(spec, cache: Dict) -> Optional[Any]:
    shape = spec.get("mesh")
    if shape is None:
        return None
    if shape not in cache:
        cache[shape] = make_mesh(*shape)
    return cache[shape]


def train(spec: Dict[str, Any], mesh) -> Dict[str, Any]:
    """One train (or eval) step of ``spec["kind"]``: the reported loss and
    the gradients the optimizer applied, gathered to full shapes, plus
    this rank's own gradients of the replicated trainable parameters."""
    dims = ModelDimensions(**spec["dims"])
    model = load(spec)
    kind = spec["kind"]
    batch = spec["batch"]
    if kind == "eval":
        if mesh is not None:
            shard_params(model, mesh)
            batch = shard_batch(batch, mesh)
        loss, preds = make_eval_step(dims, use_xt="xt" in batch)(model, batch)
        preds = preds.numpy()
        if mesh is not None:
            preds = np.concatenate(mesh.all_gather_object(preds, "data"))
        return {"loss": float(loss), "preds": preds}
    build = whisper_flamingo_optimizer if spec.get("optimizer") == "flamingo" else whisper_optimizer
    tx, _ = build(model, 1e-3, total_steps=10, max_grad_norm=spec.get("max_grad_norm"))
    teacher = load(spec, "teacher") if "teacher" in spec else None
    if mesh is not None:
        shard_params(model, mesh)
        tx.shard(mesh, model.tp_dims)
        if teacher is not None:
            shard_params(teacher, mesh)
        batch = shard_batch(batch, mesh)
    captured: Dict[str, torch.Tensor] = {}
    clipped: Dict[str, torch.Tensor] = {}
    grads_of, clip = tx._grads, tx._clip

    def capture():
        grads = grads_of()
        captured.update((n, g.clone()) for n, g in zip(tx.names, grads))
        return grads

    def capture_clip(grads):
        grads = clip(grads)
        clipped.update((n, g.clone()) for n, g in zip(tx.names, grads))
        return grads

    tx._grads, tx._clip = capture, capture_clip
    state = TrainState.create(model, tx)
    if kind == "ce":
        step = make_ce_train_step(dims, use_xt=spec.get("use_xt", False), dtype=torch.float32,
                                  remat=spec.get("remat", False))
        _, metrics = step(state, batch)
    elif kind == "kd":
        step = make_kd_train_step(dims, teacher_uses_xt=False, dtype=torch.float32, remat=False)
        _, metrics = step(state, teacher, batch)
    elif kind == "prompt_kd":
        step = make_prompt_kd_train_step(dims, dtype=torch.float32, remat=False)
        _, metrics = step(state, teacher, batch)
    else:
        raise ValueError(kind)
    dims_of = getattr(model, "tp_dims", {})
    full = gather_named(captured, dims_of, mesh)
    local_rep = {n: g.numpy() for n, g in captured.items() if dims_of.get(n) is None}
    out = {k: float(v) for k, v in metrics.items()}
    full_clipped = gather_named(clipped, dims_of, mesh)
    out.update(grads={n: g.numpy() for n, g in full.items()}, local_replicated=local_rep,
               clipped={n: g.numpy() for n, g in full_clipped.items()},
               model_index=mesh.model_index if mesh is not None else 0,
               data_index=mesh.data_index if mesh is not None else 0)
    return out


def decode(spec: Dict[str, Any], mesh) -> List:
    """``DecodingTask.run`` on a (sharded) model: (tokens, avg_logprob) per row."""
    model = load(spec)
    if mesh is not None:
        shard_params(model, mesh)
    decode_mlp.ENABLED = bool(spec.get("decode_mlp", False))
    try:
        res = DecodingTask(model, DecodingOptions(**spec["options"])).run(
            spec["mel"], xt=spec.get("xt"))
    finally:
        decode_mlp.ENABLED = False
    return [(r.tokens, r.avg_logprob) for r in res]


def layout(spec: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The shard's shapes, its split-module marks, and the gathered state
    against the loaded one (bit-equal)."""
    from whisper_flamingo_tpu_torch.parallel.mesh import gather_params

    model = load(spec)
    full = {k: v.clone() for k, v in model.state_dict().items()}
    shard_params(model, mesh)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    back = gather_params(model)
    marked = sorted(n for n, m in model.named_modules() if getattr(m, "tp", None) is mesh)
    return {"shapes": shapes, "equal": all(torch.equal(back[k], full[k]) for k in full),
            "marked": marked, "model_index": mesh.model_index}


def collectives(spec: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The tensor-parallel operators on small tensors: forward values and
    gradients, against the one-device computation on the full tensors."""
    from whisper_flamingo_tpu_torch.parallel import tp
    from whisper_flamingo_tpu_torch.training.steps import ce_loss

    g = torch.Generator().manual_seed(0)
    v, d = 12, 5
    table = torch.randn(v, d, generator=g)
    logits = torch.randn(3, 4, v, generator=g)
    labels = torch.randint(0, v, (3, 4), generator=g)
    labels[0, 1] = -100
    tokens = torch.randint(0, v, (3, 4), generator=g)
    block, k = v // mesh.n_model, mesh.model_index
    local_table = table[k * block:(k + 1) * block].clone().requires_grad_(True)
    emb = tp.vocab_embedding(local_table, tokens, mesh)
    emb.sum().backward()
    local_logits = logits[..., k * block:(k + 1) * block].clone().requires_grad_(True)
    nll = ce_loss(local_logits, labels, vocab_tp=mesh)
    nll.backward()
    x = torch.randn(3, d, generator=g, requires_grad=True)
    gathered = tp.gather_from_tp(tp.copy_to_tp(x, mesh) * (k + 1), mesh)
    (gathered ** 2).sum().backward()
    return {"emb": emb.detach().numpy(), "emb_grad": local_table.grad.numpy(),
            "nll": float(nll), "logit_grad": local_logits.grad.numpy(), "x_grad": x.grad.numpy(),
            "gathered": gathered.detach().numpy(), "model_index": k}


def fail_on_rank(rank: int, device, bad: int) -> int:
    """A rank body that raises on rank ``bad`` (the spawn helper's failure path)."""
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    return rank


def one_by_one(rank: int, device, spec: Dict[str, Any]) -> Dict[str, Any]:
    """A CE step under a 1 x 1 mesh and with no mesh, from one state."""
    return {"mesh": train(dict(spec, mesh=(1, 1)), make_mesh(1, 1)),
            "none": train(dict(spec, mesh=None), None)}


def adafactor(spec: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Adafactor (weight decay, global-norm clipping) in float64 fed the
    full gradients ``spec["grads"]`` (one dict per update): each rank takes
    its model shard, and data rank ``d`` of ``n`` the gradients scaled by
    ``1 + (2d + 1 - n) / 2`` (their mean is the given gradients, exactly).
    Returns the full parameters and factored state after the updates."""
    model = load(spec).double()
    tx, _ = whisper_optimizer(model, 1e-2, optimizer="adafactor", weight_decay=0.01,
                              total_steps=10, max_grad_norm=spec.get("max_grad_norm"))
    scale, index = 1.0, 0
    if mesh is not None:
        shard_params(model, mesh)
        tx.shard(mesh, model.tp_dims)
        scale = 1.0 + (2 * mesh.data_index + 1 - mesh.n_data) / 2
        index = mesh.model_index
    dims_of = getattr(model, "tp_dims", {})
    for grads in spec["grads"]:
        for name, p in model.named_parameters():
            g = torch.from_numpy(grads[name]) * scale
            dim = dims_of.get(name)
            if dim is not None:
                g = g.narrow(dim, index * p.shape[dim], p.shape[dim])
            p.grad = g.clone()
        tx.step()
    params = gather_named(dict(model.named_parameters()), dims_of, mesh)
    state_dict = tx.full_state_dict()
    return {"params": {n: p.detach().numpy() for n, p in params.items()},
            **{key: [t.numpy() for t in state_dict[key]] for key in ("v_row", "v_col", "v")}}


KINDS = {"train": train, "decode": decode, "layout": layout, "collectives": collectives,
         "adafactor": adafactor}


def run(rank: int, device, specs: List[Dict[str, Any]]) -> List[Any]:
    torch.manual_seed(0)
    meshes: Dict = {}
    return [KINDS[spec["body"]](spec, _mesh(spec, meshes)) for spec in specs]
