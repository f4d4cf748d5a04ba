"""Weights from the JAX package's parameter layout into the port's.

:func:`params_from_jax` is the counterpart of the JAX package's
``training/checkpoints.py`` ``load_torch_state`` / ``to_torch_state_dict``:
it takes the JAX parameter pytree as nested dicts of **numpy** arrays
(layers stacked on a leading axis, linears (in, out), convs (k, in, out),
gated sub-blocks stacked (layer, lang)) and returns the port's state dict
(OpenAI key names, torch layouts), so both packages compute one function.
Any pytree shaped like the parameters crosses the same way: gradients and
Adam moments (e.g. ``opt_state[0].mu``) come out keyed by parameter name,
for comparison with the port's ``.grad`` and optimizer state.
:func:`jax_leaf` gives the way back, a port parameter's place in the JAX
tree (its stacked leaf, its indices there, its axis order); the
converters and the optimizer's Adafactor, which works on JAX's leaves,
read the layout from here.
:func:`video_params_from_jax` does the same for the AV-HuBERT trunk (and
:func:`visual_frontend_from_jax` for the lip-video frontend alone), into
the port's fairseq-keyed modules. It imports nothing of JAX: convert the
pytree with ``jax.tree.map(np.asarray, tree)`` first.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from .models.dims import ModelDimensions
from .models.whisper import ModelExtras

# The JAX package's layout. Each permutation is its own inverse: it takes
# a JAX array to the torch layout, and lists a torch parameter's dims in
# the JAX leaf's axis order.
LINEAR_AXES = (1, 0)  # a linear's weight: (in, out) in JAX, (out, in) here
CONV_AXES = (2, 1, 0)  # a conv1d's weight: (k, in, out) in JAX, (out, in, k) here
STACKED = ("blocks", "gated_x_attn_layers")  # stacked on leading axes: the layer, the stream


class JaxLeaf(NamedTuple):
    """A port parameter's place in the JAX tree."""

    key: str  # the stacked leaf: the name with each stacked index as "*"
    index: Tuple[int, ...]  # the parameter's indices along the leaf's stacked axes
    axes: Tuple[int, ...]  # its torch dims in the leaf's per-layer axis order


def jax_leaf(model: nn.Module, name: str) -> JaxLeaf:
    """Where parameter ``name`` of ``model`` lives in the JAX tree."""
    parts, index = name.split("."), []
    for i in range(1, len(parts)):
        if parts[i - 1] in STACKED and parts[i].isdigit():
            index.append(int(parts[i]))
            parts[i] = "*"
    owner = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
    if name.endswith(".weight") and isinstance(owner, nn.Linear):
        axes = LINEAR_AXES
    elif name.endswith(".weight") and isinstance(owner, nn.Conv1d):
        axes = CONV_AXES
    else:
        axes = tuple(range(model.get_parameter(name).dim()))
    return JaxLeaf(".".join(parts), tuple(index), axes)


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def params_from_jax(
    tree: Mapping[str, Any], dims: ModelDimensions, extras: ModelExtras = ModelExtras()
) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    enc, dec = tree["encoder"], tree["decoder"]
    if bool(extras.add_gated_x_attn) != ("gated" in dec["blocks"]):
        raise ValueError("extras.add_gated_x_attn does not match the tree's gated blocks")

    for name in ("conv1", "conv2"):
        out[f"encoder.{name}.weight"] = _t(np.asarray(enc[name]["w"]).transpose(CONV_AXES))
        out[f"encoder.{name}.bias"] = _t(enc[name]["b"])
    out["encoder.ln_post.weight"] = _t(enc["ln_post"]["scale"])
    out["encoder.ln_post.bias"] = _t(enc["ln_post"]["bias"])
    out["decoder.token_embedding.weight"] = _t(dec["token_embedding"])
    out["decoder.positional_embedding"] = _t(dec["pos_embedding"])
    out["decoder.ln.weight"] = _t(dec["ln"]["scale"])
    out["decoder.ln.bias"] = _t(dec["ln"]["bias"])
    if "xt_projection" in dec:
        w = np.asarray(dec["xt_projection"]["w"])
        out["decoder.xt_projection.weight"] = _t(w.transpose(LINEAR_AXES))
        out["decoder.xt_projection.bias"] = _t(dec["xt_projection"]["b"])

    def sel(a, idx):
        return np.asarray(a)[idx]

    def attn(prefix: str, tree_: Mapping[str, Any], idx) -> None:
        for tk, ours in (("query", "q"), ("key", "k"), ("value", "v"), ("out", "out")):
            out[f"{prefix}.{tk}.weight"] = _t(sel(tree_[ours]["w"], idx).transpose(LINEAR_AXES))
            if "b" in tree_[ours] and tk != "key":
                out[f"{prefix}.{tk}.bias"] = _t(sel(tree_[ours]["b"], idx))

    def ln(prefix: str, tree_: Mapping[str, Any], idx) -> None:
        out[f"{prefix}.weight"] = _t(sel(tree_["scale"], idx))
        out[f"{prefix}.bias"] = _t(sel(tree_["bias"], idx))

    def mlp(prefix: str, tree_: Mapping[str, Any], i: int) -> None:
        out[f"{prefix}.0.weight"] = _t(sel(tree_["fc1"]["w"], i).transpose(LINEAR_AXES))
        out[f"{prefix}.0.bias"] = _t(sel(tree_["fc1"]["b"], i))
        out[f"{prefix}.2.weight"] = _t(sel(tree_["fc2"]["w"], i).transpose(LINEAR_AXES))
        out[f"{prefix}.2.bias"] = _t(sel(tree_["fc2"]["b"], i))

    def blocks(side: str, tree_: Mapping[str, Any], n_layer: int, cross: bool) -> None:
        for i in range(n_layer):
            p = f"{side}.blocks.{i}"
            attn(f"{p}.attn", tree_["attn"], i)
            ln(f"{p}.attn_ln", tree_["attn_ln"], i)
            if cross:
                attn(f"{p}.cross_attn", tree_["cross_attn"], i)
                ln(f"{p}.cross_attn_ln", tree_["cross_attn_ln"], i)
            mlp(f"{p}.mlp", tree_["mlp"], i)
            ln(f"{p}.mlp_ln", tree_["mlp_ln"], i)
            if "gated" in tree_:
                g = tree_["gated"]
                n_langs = np.asarray(g["langs"]["attn_gate"]).shape[1]
                for j in range(n_langs):
                    gp = f"{p}.gated_x_attn_layers.{j}"
                    attn(f"{gp}.attn", g["langs"]["attn"], (i, j))
                    ln(f"{gp}.attn_ln", g["langs"]["attn_ln"], (i, j))
                    out[f"{gp}.attn_gate"] = _t(sel(g["langs"]["attn_gate"], (i, j))).reshape(1)
                ln(f"{p}.ff_ln", g["ff_ln"], i)
                mlp(f"{p}.ff", g["ff"], i)
                out[f"{p}.ff_gate"] = _t(sel(g["ff_gate"], i)).reshape(1)

    blocks("encoder", enc["blocks"], dims.n_audio_layer, cross=False)
    blocks("decoder", dec["blocks"], dims.n_text_layer, cross=True)
    return out


def _bn_from_jax(out: Dict[str, torch.Tensor], prefix: str, p: Mapping[str, Any]) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])
    out[f"{prefix}.running_mean"] = _t(p["mean"])
    out[f"{prefix}.running_var"] = _t(p["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def visual_frontend_from_jax(tree: Mapping[str, Any],
                             prefix: str = "") -> Dict[str, torch.Tensor]:
    """The JAX visual frontend pytree (numpy) -> the port's
    :class:`.models.visual.VisualFrontend` state under ``prefix``: conv
    weights DHWIO -> OIDHW and HWIO -> OIHW, BatchNorm scale / bias / mean /
    variance into weight / bias / running statistics, PReLU alphas."""
    out: Dict[str, torch.Tensor] = {}
    conv3d = np.asarray(tree["conv3d"]["w"])
    out[f"{prefix}frontend3D.0.weight"] = _t(conv3d.transpose(4, 3, 0, 1, 2))
    _bn_from_jax(out, f"{prefix}frontend3D.1", tree["bn3d"])
    out[f"{prefix}frontend3D.2.weight"] = _t(tree["prelu"]["alpha"])

    def conv2d(w) -> torch.Tensor:
        return _t(np.asarray(w).transpose(3, 2, 0, 1))

    for stage in ("layer1", "layer2", "layer3", "layer4"):
        for i, blk in enumerate(tree[stage]):
            p = f"{prefix}{stage}.{i}"
            for n in (1, 2):
                out[f"{p}.conv{n}.weight"] = conv2d(blk[f"conv{n}"]["w"])
                _bn_from_jax(out, f"{p}.bn{n}", blk[f"bn{n}"])
                out[f"{p}.relu{n}.weight"] = _t(blk[f"prelu{n}"]["alpha"])
            if "downsample" in blk:
                out[f"{p}.downsample.0.weight"] = conv2d(blk["downsample"]["conv"]["w"])
                _bn_from_jax(out, f"{p}.downsample.1", blk["downsample"]["bn"])
    return out


def video_params_from_jax(tree: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """The JAX AV-HuBERT trunk pytree (numpy) -> the port's
    :class:`.models.avhubert.VideoEncoder` state for ``cfg``: the stacked
    (L, ...) block leaves unstacked into ``encoder.layers.{i}``, linears
    (in, out) -> (out, in), the pos conv (K, I/g, O) -> (O, I/g, K), the
    frontend as :func:`visual_frontend_from_jax` (BatchNorm statistics
    carried)."""
    out = visual_frontend_from_jax(tree["frontend"], "feature_extractor_video.resnet.")

    def lin(name: str, p: Mapping[str, Any], idx=None) -> None:
        w, b = np.asarray(p["w"]), np.asarray(p["b"])
        if idx is not None:
            w, b = w[idx], b[idx]
        out[f"{name}.weight"] = _t(w.transpose(LINEAR_AXES))
        out[f"{name}.bias"] = _t(b)

    def ln(name: str, p: Mapping[str, Any], idx=None) -> None:
        s, b = np.asarray(p["scale"]), np.asarray(p["bias"])
        if idx is not None:
            s, b = s[idx], b[idx]
        out[f"{name}.weight"] = _t(s)
        out[f"{name}.bias"] = _t(b)

    lin("feature_extractor_video.proj", tree["proj"])
    pos_conv = np.asarray(tree["pos_conv"]["w"])
    out["encoder.pos_conv.0.weight"] = _t(pos_conv.transpose(CONV_AXES))
    out["encoder.pos_conv.0.bias"] = _t(tree["pos_conv"]["b"])
    ln("encoder.layer_norm", tree["ln_post" if cfg.layer_norm_first else "ln_pre"])
    blocks = tree["blocks"]
    for i in range(cfg.n_layers):
        p = f"encoder.layers.{i}"
        for ours, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "out_proj")):
            lin(f"{p}.self_attn.{name}", blocks[ours], i)
        ln(f"{p}.self_attn_layer_norm", blocks["attn_ln"], i)
        lin(f"{p}.fc1", blocks["mlp"]["fc1"], i)
        lin(f"{p}.fc2", blocks["mlp"]["fc2"], i)
        ln(f"{p}.final_layer_norm", blocks["mlp_ln"], i)
    if cfg.audio_feat_dim is not None:
        lin("feature_extractor_audio.proj", tree["proj_audio"])
        ln("layer_norm", tree["fuse_ln"])
        if "post_proj" in tree:
            lin("post_extract_proj", tree["post_proj"])
    return out
