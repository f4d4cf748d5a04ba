"""Operations (multiply-add = 2) of the AV-HuBERT trunk, from shapes.

The lip-video front end (the Conv3d stem and the ResNet-18's convolutions
on each frame), the 512 -> D projection, the grouped positional conv and
the pre-LN layers (projections, attention over the clip's frames, MLP).
BatchNorm, PReLU, pooling, LayerNorm, softmax and GELU are left out: they
are elementwise, as in ``flops.py``.
"""

from __future__ import annotations

from typing import Dict

STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))  # planes, first block's stride


def _out(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


def frontend_flops_per_frame(height: int = 88, width: int = 88) -> float:
    """One frame through the stem (its 5 temporal taps counted) and the
    ResNet-18 of BasicBlocks [2, 2, 2, 2]."""
    h, w = _out(height, 7, 2, 3), _out(width, 7, 2, 3)
    total = 2 * 64 * (5 * 7 * 7) * h * w
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)  # max pool
    c_in = 64
    for planes, stride in STAGES:
        for i in range(2):
            s = stride if i == 0 else 1
            h_in, w_in = h, w
            h, w = _out(h_in, 3, s, 1), _out(w_in, 3, s, 1)
            total += 2 * planes * c_in * 9 * h * w + 2 * planes * planes * 9 * h * w
            if s != 1 or c_in != planes:
                total += 2 * planes * c_in * h * w
            c_in = planes
    return float(total)


def trunk_flops(trunk: Dict[str, int], frames: int, height: int = 88, width: int = 88) -> float:
    """One clip of ``frames`` frames through the whole trunk."""
    d, f, t = trunk["embed_dim"], trunk["ffn_dim"], frames
    total = t * frontend_flops_per_frame(height, width)
    total += 2 * t * trunk["frontend_dim"] * d
    total += 2 * t * d * (d // trunk["conv_pos_groups"]) * trunk["conv_pos"]
    layer = 4 * 2 * t * d * d + 2 * 2 * t * t * d + 2 * 2 * t * d * f
    return float(total + trunk["n_layers"] * layer)
