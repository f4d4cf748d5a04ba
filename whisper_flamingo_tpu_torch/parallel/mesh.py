"""The (data, model) rank mesh, the tensor-parallel parameter layout and the
batch split.

Port of ``whisper_flamingo_tpu/parallel/mesh.py``. JAX laid a
``Mesh(('data', 'model'))`` over devices and let GSPMD place the
collectives; here each rank is a process (:mod:`.distributed`) and
:class:`Mesh` holds its place in the grid and the two axes' process
groups. Rank ``r`` is data index ``r // n_model`` and model index
``r % n_model``, as JAX's ``reshape(n_data, n_model)``.

The layout is JAX's ``param_pspecs`` table (the Megatron layout) over the
port's OpenAI parameter names, torch layouts ((out, in) linears):

- self-attention and the gated sub-blocks' attention (``.../attn/q|k|v``
  in JAX, which the rule matches literally) split their output features,
  ``out`` its input features with the bias replicated (added once, after
  the reduction). The decoder's ``cross_attn`` is not matched and stays
  replicated;
- the MLP and the gated FFN split ``fc1``'s output and ``fc2``'s input;
- the tied ``token_embedding`` splits the vocabulary;
- everything else is replicated, and so is any parameter whose split axis
  the model axis does not divide (51,865 tokens under 2 ranks).

Shards are contiguous blocks, as JAX's. :func:`shard_params` slices a full
model in place and marks the split modules with the mesh (``module.tp``),
which the apply functions of :mod:`..models.whisper` read to run the
collectives of :mod:`.tp`. A split attention must keep whole heads on
each rank (JAX's GSPMD could split a head; the port's kernels cannot).

Batches: every rank reads the same global batch and :func:`shard_batch`
takes its data index's rows (JAX's single-host semantics), after padding a
ragged batch to a multiple of ``n_data`` as the JAX trainer's
``_device_batch`` does (the last row repeated, its ``labels`` and
``teacher_labels`` -100, so every masked mean is the unpadded batch's).

Device tensors cross ranks only through ``all_reduce`` (gloo takes no
other collective on CUDA tensors): a gather is an ``all_reduce`` of a
zero-filled buffer into which each rank writes its block.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Mesh:
    """This rank's place in an ``n_data`` x ``n_model`` grid and the process
    groups of its data column and model row. Collectives over an axis of
    size 1 do nothing, so a 1 x 1 mesh computes exactly what no mesh
    computes."""

    def __init__(self, n_data: int, n_model: int, rank: int, groups: Dict[str, Any]):
        self.n_data, self.n_model, self.rank = n_data, n_model, rank
        self.data_index, self.model_index = divmod(rank, n_model)
        self._groups = groups

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.data_index if axis == DATA_AXIS else self.model_index

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over ``axis``, in place; returns ``t``."""
        if self.size(axis) > 1:
            dist.all_reduce(t, op=_REDUCE_OPS[op], group=self._groups[axis])
        return t

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The ranks' equal blocks of ``axis`` concatenated along ``dim``
        (an ``all_reduce`` over a zero-filled buffer)."""
        n = self.size(axis)
        if n == 1:
            return t
        dim = dim % t.dim()
        shape = list(t.shape)
        block = shape[dim]
        shape[dim] = block * n
        out = t.new_zeros(shape)
        start = self.index(axis) * block
        out.narrow(dim, start, block).copy_(t)
        return self.all_reduce(out, axis)

    def all_gather_object(self, obj: Any, axis: str) -> List[Any]:
        """Every rank's ``obj`` along ``axis``, in index order."""
        n = self.size(axis)
        if n == 1:
            return [obj]
        out: List[Any] = [None] * n
        dist.all_gather_object(out, obj, group=self._groups[axis])
        return out

    def __deepcopy__(self, memo) -> "Mesh":  # a model's decode copy shares the mesh
        return self

    def __repr__(self) -> str:
        return (f"Mesh({self.n_data}x{self.n_model}, rank={self.rank}, "
                f"data={self.data_index}, model={self.model_index})")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The mesh over the process group's ranks (``n_data`` defaults to the
    world size over ``n_model``). Every rank must call it, in the same
    order as every other ``new_group``."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"a {n_data}x{n_model} mesh needs a process group: launch with "
            f"`torchrun --nproc-per-node {(n_data or 1) * n_model} -m <module> ...`"
        )
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(
            f"{n_data}x{n_model} mesh does not match the {world} ranks of the process group: "
            f"launch with `torchrun --nproc-per-node {n_data * n_model} ...`"
        )

    def group(ranks):
        # an axis over every rank is the world's group, with its timeout
        # (a new group would take torch's default) and no second communicator
        return dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)

    groups: Dict[str, Any] = {}
    if n_model > 1:
        for d in range(n_data):
            g = group([d * n_model + m for m in range(n_model)])
            if rank // n_model == d:
                groups[MODEL_AXIS] = g
    if n_data > 1:
        for m in range(n_model):
            g = group([d * n_model + m for d in range(n_data)])
            if rank % n_model == m:
                groups[DATA_AXIS] = g
    return Mesh(n_data, n_model, rank, groups)


# ---------------------------------------------------------------------------
# The tensor-parallel layout
# ---------------------------------------------------------------------------

def _dim_for(name: str) -> Optional[int]:
    """The torch dim of parameter ``name`` that the model axis splits (the
    JAX rule over the OpenAI keys), or ``None``."""
    parts = name.split(".")
    if len(parts) >= 3:
        owner, layer, leaf = parts[-3], parts[-2], parts[-1]
        if owner == "attn":  # "/attn/q/" etc.; "cross_attn" is not matched
            if layer in ("query", "key", "value"):
                return 0  # output features (weight rows, bias)
            if layer == "out":
                return 1 if leaf == "weight" else None
        if owner in ("mlp", "ff"):  # "/fc1/", "/fc2/"
            if layer == "0":
                return 0
            if layer == "2":
                return 1 if leaf == "weight" else None
    if name == "decoder.token_embedding.weight":
        return 0  # the vocabulary
    return None


def param_pspecs(model: nn.Module, n_model: Optional[int] = None) -> Dict[str, Optional[int]]:
    """``{parameter name: split dim or None}`` over ``model``'s full shapes.
    Given the model axis' size ``n_model``, a dim it does not divide falls
    back to ``None`` (replicated), as JAX's ``param_pspecs`` with a mesh."""
    out: Dict[str, Optional[int]] = {}
    for name, p in model.named_parameters():
        dim = _dim_for(name)
        if dim is not None and n_model is not None and p.shape[dim] % n_model:
            dim = None
        out[name] = dim
    return out


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Slice ``model`` (full weights, the same on every rank) into this
    rank's shard, in place, and mark it: ``model.mesh``, ``model.tp_dims``
    (the layout) and ``module.tp = mesh`` on every split attention, MLP and
    the decoder when its vocabulary is split. Returns ``model``."""
    if getattr(model, "mesh", None) is not None:
        raise ValueError("shard_params: the model is sharded already")
    dims = param_pspecs(model, mesh.n_model)
    n, k = mesh.n_model, mesh.model_index
    split_parents = set()
    with torch.no_grad():
        for name, p in model.named_parameters():
            dim = dims[name]
            if dim is None or n == 1:
                continue
            block = p.shape[dim] // n
            p.data = p.data.narrow(dim, k * block, block).clone()
            parent = name.rsplit(".", 2)[0] if name.startswith(("encoder.blocks", "decoder.blocks")) \
                else "decoder"
            split_parents.add(parent)
    for parent in split_parents:
        mod = model.get_submodule(parent)
        if hasattr(mod, "query"):  # an attention: whole heads per rank
            heads = _n_head(model, parent)
            if heads % n:
                raise ValueError(f"shard_params: {heads} heads of {parent} do not split over "
                                 f"{n} model ranks")
        mod.tp = mesh
    model.mesh = mesh
    model.tp_dims = dims if n > 1 else {name: None for name in dims}
    return model


def _n_head(model: nn.Module, attn_name: str) -> int:
    d = model.dims
    return d.n_audio_head if attn_name.startswith("encoder.") else d.n_text_head


def gather_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The full state dict of a sharded ``model`` (every rank gets it;
    every rank of the model axis must call this)."""
    return gather_named(model.state_dict(), getattr(model, "tp_dims", {}),
                        getattr(model, "mesh", None))


def gather_named(tensors: Dict[str, torch.Tensor], dims: Dict[str, Optional[int]],
                 mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """Named shards (parameters, their gradients or moments) gathered to
    full shapes along their ``dims`` (a collective over the model axis)."""
    return {name: t if mesh is None or dims.get(name) is None
            else mesh.all_gather(t, MODEL_AXIS, dims[name])
            for name, t in tensors.items()}


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------

# Batch fields whose batch axis is not the leading one: the conditioning
# streams ``xt`` are (n_langs, B, S, D).
BATCH_AXES = {"xt": 1}
_LABEL_FIELDS = ("labels", "teacher_labels")


def batch_axis(key: str) -> int:
    """Which axis of batch field ``key`` is the batch axis."""
    return BATCH_AXES.get(key, 0)


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def pad_batch(batch: Dict[str, Any], n_data: int) -> Dict[str, np.ndarray]:
    """The array fields of ``batch`` (host-only lists and strings dropped)
    as numpy arrays, a ragged batch padded to a multiple of ``n_data``
    rows: the last row repeated, the padded rows' labels -100 (the JAX
    trainer's ``_device_batch``)."""
    arrays = {k: _host(v) for k, v in batch.items() if not isinstance(v, (list, tuple, str))}
    lead = next((v.shape[batch_axis(k)] for k, v in arrays.items()
                 if v.ndim > batch_axis(k)), 0)
    if lead % n_data == 0:
        return arrays
    pad = n_data - lead % n_data

    def pad_rows(k, v):
        axis = batch_axis(k)
        if v.ndim <= axis or v.shape[axis] != lead:
            return v
        v = np.concatenate([v, np.repeat(np.take(v, [-1], axis=axis), pad, axis=axis)], axis=axis)
        if k in _LABEL_FIELDS:
            v[lead:] = -100
        return v

    return {k: pad_rows(k, v) for k, v in arrays.items()}


def shard_batch(batch: Dict[str, Any], mesh: Optional[Mesh]) -> Dict[str, Any]:
    """This rank's rows of the global ``batch`` (padded by
    :func:`pad_batch`): the contiguous block of its data index along each
    field's batch axis. Without a mesh, the array fields themselves; with
    one data rank, the padded batch."""
    if mesh is None:
        return {k: v for k, v in batch.items() if not isinstance(v, (list, tuple, str))}
    arrays = pad_batch(batch, mesh.n_data)
    if mesh.n_data == 1:
        return arrays
    d, i = mesh.n_data, mesh.data_index
    out = {}
    for k, v in arrays.items():
        axis = batch_axis(k)
        if v.ndim <= axis:
            out[k] = v
            continue
        block = v.shape[axis] // d
        out[k] = np.take(v, np.arange(i * block, (i + 1) * block), axis=axis)
    return out
