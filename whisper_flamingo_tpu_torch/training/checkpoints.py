"""Checkpoint interchange: OpenAI ``.pt`` and Lightning ``.ckpt`` into the
port, and the port's parameters out as an OpenAI ``.pt``.

Port of ``whisper_flamingo_tpu/training/checkpoints.py``.
The port's parameters carry the OpenAI key names, so a state dict loads
with ``load_state_dict(strict=False)`` on a seeded random init: keys the
checkpoint lacks (new gated x-attn weights) keep their initialization, and
keys the model lacks are ignored. Lightning checkpoints are re-keyed by
stripping the ``model.`` prefix. The write side is the module's
``state_dict()``, which already carries the OpenAI keys
(:func:`to_torch_state_dict`, :func:`save_torch_checkpoint`). The JAX
package's Orbax training checkpoints are ``torch.save`` files here
(``training/trainer.py``).
"""

from __future__ import annotations

import pickle
import warnings
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from ..models.dims import ModelDimensions
from ..models.whisper import ModelExtras, Whisper, init_params
from ..utils import resolve_device


def strip_prefix(state_dict: Mapping[str, Any], prefix: str = "model.") -> Dict[str, Any]:
    """Re-key a Lightning checkpoint state dict."""
    return {
        (k[len(prefix):] if k.startswith(prefix) else k): v for k, v in state_dict.items()
    }


def torch_load_prefer_safe(path: str):
    """``torch.load`` with ``weights_only=True`` first; the unrestricted
    unpickler (which can run code) only after a warning naming the file.
    IO errors propagate."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except OSError:
        raise
    except (pickle.UnpicklingError, RuntimeError, AttributeError, ValueError):
        warnings.warn(
            f"checkpoint {path!r} needs the unrestricted pickle loader "
            "(weights_only=False); only load checkpoints you trust"
        )
        return torch.load(path, map_location="cpu", weights_only=False)


def load_torch_state(
    state_dict: Mapping[str, Any], dims: ModelDimensions,
    extras: ModelExtras = ModelExtras(), *, seed: int = 0, device=None,
) -> Whisper:
    """A ``Whisper`` on ``device`` (the card unless named) from a torch
    state dict, with ``strict=False`` semantics over a random init seeded by
    ``seed``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = init_params(gen, dims, extras, device=device)
    model.load_state_dict(dict(state_dict), strict=False)
    return model


def load_torch_checkpoint(
    path: str, dims: Optional[ModelDimensions] = None,
    extras: ModelExtras = ModelExtras(), *, seed: int = 0, device=None,
) -> Tuple[Whisper, ModelDimensions]:
    """Read an OpenAI ``.pt`` (``{dims, model_state_dict}``), a Lightning
    ``.ckpt`` (``{state_dict}`` with ``model.`` prefixes) or a raw state
    dict; the last two carry no dims, so pass ``dims``."""
    ckpt = torch_load_prefer_safe(path)
    if "model_state_dict" in ckpt:
        state = ckpt["model_state_dict"]
        if dims is None:
            dims = ModelDimensions.from_dict(ckpt["dims"])
    elif "state_dict" in ckpt:
        state = strip_prefix(ckpt["state_dict"])
        if dims is None:
            raise ValueError("Lightning checkpoints carry no dims; pass dims=")
    else:
        state = ckpt
        if dims is None:
            raise ValueError("raw state dict carries no dims; pass dims=")
    return load_torch_state(state, dims, extras, seed=seed, device=device), dims


def to_torch_state_dict(model: Whisper) -> Dict[str, torch.Tensor]:
    """The parameters under the OpenAI keys, as fp32 CPU tensors."""
    return {k: v.detach().float().cpu() for k, v in model.state_dict().items()}


def save_torch_checkpoint(model: Whisper, path: str) -> None:
    """Write an OpenAI-format ``.pt`` (``{dims, model_state_dict}``) that
    torch-based Whisper stacks load."""
    torch.save({"dims": model.dims.to_dict(), "model_state_dict": to_torch_state_dict(model)},
               path)
