"""Lip-video visual frontend: a 3D-conv stem and a ResNet-18 trunk.

Port of ``whisper_flamingo_tpu/models/visual.py`` (the AutoAVSR /
AV-HuBERT ``ResEncoder``): Conv3d (5, 7, 7) with stride (1, 2, 2) and
padding (2, 3, 3), BatchNorm, PReLU and a (1, 3, 3) max pool with stride
(1, 2, 2) and padding (0, 1, 1) ("frontend3D"); time folds into the batch;
a BasicBlock [2, 2, 2, 2] ResNet with per-channel PReLU; a global average
pool to one 512-d vector per frame.

The modules carry the reference's torch key names (``frontend3D.{0,1,2}``,
``layer{1..4}.{i}.{conv1,bn1,relu1,conv2,bn2,relu2,downsample.{0,1}}``), so
a torch frontend state loads by a key filter (:func:`load_visual_frontend_torch`).
The layouts are PyTorch's (NCDHW activations, OIDHW / OIHW weights) where
the JAX package is channels-last.

BatchNorm always reads the stored running statistics (``F.batch_norm(...,
training=False)``, whatever the module's train/eval mode), computed in fp32
and rounded to the compute dtype, as in the JAX package: the frontend is
frozen in every recipe. The convolutions and the max pool are PyTorch's
(cuDNN on the card): the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import profiling
from ..utils import resolve_device

_STAGES = (("layer1", 64, 1), ("layer2", 128, 2), ("layer3", 256, 2), ("layer4", 512, 2))


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.relu1 = nn.PReLU(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.relu2 = nn.PReLU(planes)
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False), nn.BatchNorm2d(planes)
            )


class VisualFrontend(nn.Module):
    """The parameter tree of the ResEncoder (3D stem + 2D ResNet-18); no
    parameter requires grad (the frontend is frozen)."""

    def __init__(self):
        super().__init__()
        self.frontend3D = nn.Sequential(
            nn.Conv3d(1, 64, (5, 7, 7), (1, 2, 2), (2, 3, 3), bias=False),
            nn.BatchNorm3d(64),
            nn.PReLU(64),
        )
        inplanes = 64
        for name, planes, stride in _STAGES:
            setattr(self, name, nn.Sequential(
                BasicBlock(inplanes, planes, stride), BasicBlock(planes, planes, 1)
            ))
            inplanes = planes
        self.requires_grad_(False)


def batch_norm(p: nn.Module, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference BatchNorm over axis 1 with the stored statistics, in fp32,
    rounded to x's dtype."""
    y = F.batch_norm(
        x.float(), p.running_mean.float(), p.running_var.float(), p.weight.float(),
        p.bias.float(), training=False, eps=eps,
    )
    return y.to(x.dtype)


def prelu(p: nn.PReLU, x: torch.Tensor) -> torch.Tensor:
    """Per-channel PReLU over axis 1, alpha in x's dtype."""
    return F.prelu(x, p.weight.to(x.dtype))


def _conv2d(p: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, p.weight.to(x.dtype), None, p.stride, p.padding)


def _basic_block(p: BasicBlock, x: torch.Tensor) -> torch.Tensor:
    out = prelu(p.relu1, batch_norm(p.bn1, _conv2d(p.conv1, x)))
    out = batch_norm(p.bn2, _conv2d(p.conv2, out))
    residual = x
    if hasattr(p, "downsample"):
        residual = batch_norm(p.downsample[1], _conv2d(p.downsample[0], x))
    return prelu(p.relu2, out + residual)


def visual_frontend_apply(
    params: VisualFrontend, frames: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """(B, T, H, W) grayscale lip crops -> (B, T, 512) frame features, under
    the span ``av.frontend``."""
    with profiling.span("av.frontend"):
        return _frontend(params, frames, dtype)


def _frontend(params: VisualFrontend, frames: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    b = frames.shape[0]
    stem = params.frontend3D
    x = frames.to(dtype)[:, None]  # (B, 1, T, H, W)
    x = F.conv3d(x, stem[0].weight.to(dtype), None, (1, 2, 2), (2, 3, 3))
    x = prelu(stem[2], batch_norm(stem[1], x))
    # the implicit padding of max_pool3d is -inf, as JAX's reduce_window init
    x = F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
    _, c, t, h, w = x.shape
    x = x.transpose(1, 2).reshape(b * t, c, h, w)  # time folded into the batch
    for name, _, _ in _STAGES:
        for blk in getattr(params, name):
            x = _basic_block(blk, x)
    return x.mean(dim=(2, 3)).reshape(b, t, -1)


@torch.no_grad()
def init_visual_frontend(generator: torch.Generator, device=None) -> VisualFrontend:
    """A random frontend on ``device`` (the card unless named), with the JAX
    package's initialization: convolutions He-normal with the fan of
    ``resnet.py`` (kernel height x width x output channels for the 2D ones,
    depth x height x output channels for the 3D stem, as JAX counts it),
    BatchNorm weight 1, bias 0, running mean 0 and variance 1, PReLU alpha
    0.25. ``generator`` must live on ``device``; the values differ from
    JAX's for the same seed."""
    device = resolve_device(device)
    with device:
        model = VisualFrontend().to(device)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Conv3d)):
            o, _, k0, k1 = mod.weight.shape[:4]
            mod.weight.normal_(0.0, math.sqrt(2.0 / (k0 * k1 * o)), generator=generator)
        elif isinstance(mod, nn.PReLU):
            mod.weight.fill_(0.25)
        elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
            mod.reset_parameters()
    return model.eval()


def load_visual_frontend_torch(
    state: Mapping[str, Any], frontend: Optional[VisualFrontend] = None, device=None,
) -> VisualFrontend:
    """Torch ``frontend3D.*`` / ``layer*`` weights (the reference's
    ``resnet.py`` keys) into ``frontend`` (a new one on ``device`` when
    none is given). Every parameter and running statistic must be in
    ``state`` (``num_batches_tracked`` may be absent); other keys are
    ignored."""
    if frontend is None:
        frontend = VisualFrontend().to(resolve_device(device)).eval()
    own = frontend.state_dict()
    missing = [k for k in own if k not in state and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"visual frontend weights missing from the state: {missing[:4]}")
    picked: Dict[str, torch.Tensor] = {
        k: torch.as_tensor(state[k]).to(own[k].dtype) for k in own if k in state
    }
    frontend.load_state_dict(picked, strict=False)
    return frontend
