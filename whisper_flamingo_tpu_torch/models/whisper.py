"""Whisper encoder/decoder with Flamingo-style gated cross-attention, in
PyTorch.

Port of ``whisper_flamingo_tpu/models/whisper.py``. The parameters are an
``nn.Module`` tree with the OpenAI state-dict key names (and the
Whisper-Flamingo fork's ``gated_x_attn_layers`` / ``ff`` / ``ff_gate`` /
``xt_projection`` keys), so an OpenAI ``.pt`` loads with
``load_state_dict(strict=False)``. The compute is plain functions over
that tree and tensors, with the JAX package's names and numerics:

- LayerNorm is an fp32 island; GELU is the exact erf form;
- attention scales q and k by d_head^-0.25, logits and softmax in fp32;
- the encoder's self-attention at d_head 64 runs the flash64 kernel;
- the decoder runs teacher-forced (no cache), prefill (writes the cache)
  and incremental (one token, through the decode-attention kernel);
- gated x-attn runs before self-attention, parallel or sequential over the
  stacked (n_langs, B, S, D) conditioning streams;
- the tied-embedding logits are a float32 matmul of the compute-dtype
  operands (so bf16 inputs give JAX's bf16-inputs / fp32-accumulate
  product);
- the int8 serving modes: :func:`quantize_decode_params` hangs int8
  weights with per-output-channel scales (``w_q``/``w_s``) on the decode
  copy's linears and an int8 lm head (``lm_head_q``/``lm_head_s``);
  :func:`init_cache` stores the static slabs int8 with per-head scales,
  and with ``quantize_self`` the self cache int8 with per-(token, head)
  scales (int8kv);
- with ``ops.decode_mlp.ENABLED`` the cached decoder's MLP goes through
  the streaming decode-MLP kernel (:func:`..ops.decode_mlp.fused_mlp`);
- on the card the decode loop's incremental step replays CUDA graphs
  between the decode-attention launches (:class:`StepGraphs`);
- tensor parallelism: on a model sliced by
  :func:`..parallel.mesh.shard_params` each split module carries the mesh
  (``module.tp``). The apply functions then take the local head count and
  width from it (the d_head scale is unchanged), put
  :func:`..parallel.tp.copy_to_tp` before the column-parallel projections
  and :func:`..parallel.tp.reduce_from_tp` after the row-parallel ones
  (the replicated bias after the reduction), look tokens up in a
  vocabulary-split embedding and gather vocabulary-split logits (or leave
  them split, ``gather_logits=False``, for the vocabulary-parallel
  cross-entropy). The decoder's cross-attention is replicated and takes no
  collective. With no mesh every collective is the identity.

Layers are a ``ModuleList`` looped in Python (the JAX package stacked them
for ``lax.scan``). The decode caches are dicts of stacked tensors:
``k``/``v`` (L, B, T, D) unsplit, written in place; ``xa_k``/``xa_v``
(L, B, H, Ta, Dh) and ``xt_k``/``xt_v`` (L, n_langs, B, H, S, Dh)
head-split, K pre-scaled, K and V in the compute dtype; on the card the
per-step cross-attention over them is one kernel that accumulates the
logits in fp32 (:mod:`..ops.xattn_step`). A cache made with a stream capacity
holds the gated slabs at that length, zero past the streams' S keys, with
the additive key mask ``xt_mask`` (B, 1, 1, capacity) that takes those keys
out of the gated softmax: the attention is the one over the S keys, and
streams of every length share one shape.

Left out, each a TPU workaround or a later slice: ``CACHE_LOOP`` and
``SELECTOR_SELF`` (the selector form of many-row attention,
``cached_selector_attention``, computes what ``cached_qkv_attention``
computes), the in-loop one-hot beam reorder (``row_perm``; the decode loop
reorders a row table that the decode-attention kernel reads the self cache
through, or under int8kv the cache with ``index_select``), the transposed
(B, H, Dh, T) slabs, the fused QKV projection (int8 quantizes q, k and v
apart: per-output-channel scales give the fused weight's int8 values and
scales).

Training runs autograd through :func:`encoder_apply` and the teacher-forced
:func:`decoder_apply`; the decode paths (the cached decoder, :func:`init_cache`,
:func:`prepare_decode_params`) run without it.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from .. import profiling
from ..ops import decode_attn, decode_mlp
from ..ops.attention import (
    cached_causal_mask,
    cached_qkv_attention,
    causal_mask,
    head_split_kv,
    qkv_attention,
    update_cache,
    xa_qkv_attention,
)
from ..ops.quant import (
    quantize_int8,
    quantize_linear_params,
    quantize_tokenwise_kv,
    quantized_matmul,
)
from ..parallel.mesh import MODEL_AXIS
from ..parallel.tp import copy_to_tp, gather_from_tp, reduce_from_tp, vocab_embedding
from ..utils import resolve_device
from .dims import ModelDimensions

Cache = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Modules (parameter containers with the OpenAI key names)
# ---------------------------------------------------------------------------

class MultiHeadAttention(nn.Module):
    def __init__(self, n_state: int):
        super().__init__()
        self.query = nn.Linear(n_state, n_state)
        self.key = nn.Linear(n_state, n_state, bias=False)
        self.value = nn.Linear(n_state, n_state)
        self.out = nn.Linear(n_state, n_state)


def _mlp(n_state: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(n_state, 4 * n_state), nn.GELU(), nn.Linear(4 * n_state, n_state))


class GatedXAttnSubBlock(nn.Module):
    """One conditioning stream's gated cross-attention (gate starts at 0)."""

    def __init__(self, n_state: int):
        super().__init__()
        self.attn = MultiHeadAttention(n_state)
        self.attn_ln = nn.LayerNorm(n_state)
        self.attn_gate = nn.Parameter(torch.zeros(1))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, n_state: int, cross_attention: bool = False, n_gated: int = 0):
        super().__init__()
        self.attn = MultiHeadAttention(n_state)
        self.attn_ln = nn.LayerNorm(n_state)
        if cross_attention:
            self.cross_attn = MultiHeadAttention(n_state)
            self.cross_attn_ln = nn.LayerNorm(n_state)
        self.mlp = _mlp(n_state)
        self.mlp_ln = nn.LayerNorm(n_state)
        if n_gated:
            self.gated_x_attn_layers = nn.ModuleList(
                GatedXAttnSubBlock(n_state) for _ in range(n_gated)
            )
            self.ff_ln = nn.LayerNorm(n_state)
            self.ff = _mlp(n_state)
            self.ff_gate = nn.Parameter(torch.zeros(1))

    @property
    def gated(self) -> bool:
        return hasattr(self, "gated_x_attn_layers")


class AudioEncoder(nn.Module):
    def __init__(self, dims: ModelDimensions):
        super().__init__()
        d = dims.n_audio_state
        self.conv1 = nn.Conv1d(dims.n_mels, d, kernel_size=3, padding=1)
        self.conv2 = nn.Conv1d(d, d, kernel_size=3, stride=2, padding=1)
        # recomputed, never loaded: a checkpoint's fp16 copy would round it
        self.register_buffer(
            "positional_embedding",
            torch.from_numpy(sinusoids(dims.n_audio_ctx, d)), persistent=False,
        )
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d) for _ in range(dims.n_audio_layer)
        )
        self.ln_post = nn.LayerNorm(d)


class TextDecoder(nn.Module):
    def __init__(self, dims: ModelDimensions, extras: "ModelExtras"):
        super().__init__()
        d = dims.n_text_state
        n_gated = max(extras.num_langs, 1) if extras.add_gated_x_attn else 0
        self.token_embedding = nn.Embedding(dims.n_vocab, d)
        self.positional_embedding = nn.Parameter(torch.empty(dims.n_text_ctx, d))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d, cross_attention=True, n_gated=n_gated)
            for _ in range(dims.n_text_layer)
        )
        self.ln = nn.LayerNorm(d)
        if extras.add_gated_x_attn and extras.bert_dim != d:
            self.xt_projection = nn.Linear(extras.bert_dim, d)


@dataclass(frozen=True)
class ModelExtras:
    """Fork model-surgery flags (same fields as the JAX package)."""

    dropout_rate: float = 0.0
    add_adapter: bool = False  # accepted for config parity; inert
    adapter_dim: int = 256
    add_gated_x_attn: int = 0
    bert_dim: int = 768
    num_langs: int = 0
    # False: parallel deltas over the streams; True: sequential (legacy)
    sequential_gated_x_attn: bool = False


class Whisper(nn.Module):
    """The model handle: dims, surgery flags, compute dtype and the
    parameter tree (``encoder``, ``decoder``). The compute functions below
    take it as ``params``. No parameter requires grad until a training
    optimizer marks the ones it trains (:mod:`..training.optim`), so
    inference builds no autograd graph."""

    def __init__(
        self, dims: ModelDimensions, extras: ModelExtras = ModelExtras(),
        dtype: torch.dtype = torch.float32,
        alignment_heads: Optional[np.ndarray] = None,
    ):
        super().__init__()
        self.dims = dims
        self.extras = extras
        self.dtype = dtype
        self.alignment_heads = alignment_heads
        self.encoder = AudioEncoder(dims)
        self.decoder = TextDecoder(dims, extras)
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.decoder.token_embedding.weight.device

    def set_alignment_heads(self, dump: bytes) -> None:
        """Install a base85-gzip alignment-head bitmap (the published format)."""
        from ..registry import decode_alignment_heads

        self.alignment_heads = decode_alignment_heads(
            dump, self.dims.n_text_layer, self.dims.n_text_head
        )

    def get_alignment_heads(self) -> np.ndarray:
        """(n_text_layer, n_text_head) bool mask of the cross-attention heads
        word timing reads; every head of the second half of the decoder
        layers when none are known."""
        if self.alignment_heads is not None:
            return np.asarray(self.alignment_heads, dtype=bool)
        heads = np.zeros((self.dims.n_text_layer, self.dims.n_text_head), bool)
        heads[self.dims.n_text_layer // 2:] = True
        return heads

    @property
    def is_multilingual(self) -> bool:
        return self.dims.is_multilingual

    @property
    def num_languages(self) -> int:
        return self.dims.num_languages

    @torch.no_grad()
    def embed_audio(self, mel: torch.Tensor) -> torch.Tensor:
        return encoder_apply(self, self.dims, mel, dtype=self.dtype)

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor, audio_features: torch.Tensor) -> torch.Tensor:
        return decoder_apply(self, self.dims, tokens, audio_features, dtype=self.dtype)[0]

    @torch.no_grad()
    def forward(self, mel: torch.Tensor, tokens: torch.Tensor, xt=None) -> torch.Tensor:
        feats = self.embed_audio(mel)
        return decoder_apply(self, self.dims, tokens, feats, xt=xt, dtype=self.dtype)[0]


# ---------------------------------------------------------------------------
# Primitive layers (plain functions over modules and tensors)
# ---------------------------------------------------------------------------

def layer_norm(p: nn.LayerNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """fp32 LayerNorm island: statistics, scale and shift in fp32, rounded
    once to x's dtype. PyTorch's kernel computes a bf16 input with bf16
    weights in fp32 internally, so weights already in x's dtype (the decode
    copy) take one launch; others (fp32 masters) are upcast with x."""
    if p.weight.dtype == x.dtype:
        return F.layer_norm(x, x.shape[-1:], p.weight, p.bias, eps)
    y = F.layer_norm(x.float(), x.shape[-1:], p.weight.float(), p.bias.float(), eps)
    return y.to(x.dtype)


def linear(p: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """Dense layer with the weights cast to the activation dtype. A layer
    quantized by :func:`quantize_decode_params` carries ``w_q``/``w_s``
    (int8 weight, per-output-channel scale) in place of its weight: the
    product, then the scale, then the bias, each in x's dtype."""
    w_q = getattr(p, "w_q", None)
    if w_q is not None:
        y = quantized_matmul(x, w_q, p.w_s)
        return y if p.bias is None else y + p.bias.to(x.dtype)
    b = None if p.bias is None else p.bias.to(x.dtype)
    return F.linear(x, p.weight.to(x.dtype), b)


def _tp(p: nn.Module):
    """The mesh of a module the model axis splits (``None`` when whole)."""
    return getattr(p, "tp", None)


def local_heads(p: MultiHeadAttention, n_head: int) -> int:
    """The heads of attention ``p`` on this rank: all of them, or
    ``n_head / n_model`` when the model axis splits it."""
    tp = _tp(p)
    return n_head if tp is None else n_head // tp.n_model


def row_linear(p: nn.Linear, x: torch.Tensor, tp) -> torch.Tensor:
    """A row-parallel (input-split) dense layer: this rank's partial
    product (int8 ``w_q``/``w_s`` as in :func:`linear`), summed over the
    model axis, then the replicated bias once. Without ``tp`` it is
    :func:`linear`."""
    if tp is None:
        return linear(p, x)
    w_q = getattr(p, "w_q", None)
    y = quantized_matmul(x, w_q, p.w_s) if w_q is not None else F.linear(x, p.weight.to(x.dtype))
    y = reduce_from_tp(y, tp)
    return y if p.bias is None else y + p.bias.to(x.dtype)


def conv1d(p: nn.Conv1d, x: torch.Tensor, stride: int) -> torch.Tensor:
    """1-D conv over time, (B, C, T) layout, padding 1."""
    return F.conv1d(x, p.weight.to(x.dtype), p.bias.to(x.dtype), stride=stride, padding=1)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # exact erf form


def sinusoids(length: int, channels: int, max_timescale: float = 10000) -> np.ndarray:
    """Sinusoidal position embeddings, (length, channels) float32."""
    assert channels % 2 == 0
    log_timescale_increment = math.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(np.float32)


def attention_block(
    p: MultiHeadAttention, x: torch.Tensor, n_head: int,
    kv_src: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
    k_override: Optional[torch.Tensor] = None, v_override: Optional[torch.Tensor] = None,
    backend: str = "plain", return_qk: bool = False,
    k_scale: Optional[torch.Tensor] = None, v_scale: Optional[torch.Tensor] = None,
):
    """Projected multi-head attention. ``kv_src`` selects cross-attention;
    ``k_override``/``v_override`` are cached head-split (B, H, T, Dh) slabs
    with K pre-scaled (int8 with per-head ``k_scale``/``v_scale`` in the
    int8 modes), ``mask`` then an additive (B, 1, 1, T) key mask or none.
    ``return_qk`` (no override) also returns the fp32 logits, as ``(out,
    logits)``. ``n_head`` is the model's count; a split ``p`` runs its
    local heads.

    Beam grouping: when the slab batch is smaller than the query batch
    (beam search shares one audio stream across ``G`` beams) the beam axis
    folds into the query-length axis, so the shared slab is read once per
    audio instead of once per beam."""
    tp = _tp(p)
    n_head = local_heads(p, n_head)
    x = copy_to_tp(x, tp)
    q = linear(p.query, x)
    if k_override is not None:
        bq, t, d = q.shape
        b = k_override.shape[0]
        if b != bq:
            out = xa_qkv_attention(q.reshape(b, (bq // b) * t, d), k_override, v_override,
                                   n_head, k_scale, v_scale, mask=mask)
            out = out.reshape(bq, t, d)
        else:
            out = xa_qkv_attention(q, k_override, v_override, n_head, k_scale, v_scale,
                                   mask=mask)
        return row_linear(p.out, out, tp)
    src = x if kv_src is None else copy_to_tp(kv_src, tp)
    k = linear(p.key, src)
    v = linear(p.value, src)
    if return_qk:
        out, qk = qkv_attention(q, k, v, n_head, mask=mask, return_qk=True)
        return row_linear(p.out, out, tp), qk
    return row_linear(p.out, qkv_attention(q, k, v, n_head, mask=mask, backend=backend), tp)


def mlp_block(p: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    tp = _tp(p)
    return row_linear(p[2], gelu(linear(p[0], copy_to_tp(x, tp))), tp)


def _gate(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(g.to(x.dtype))


def _gated_streams(p: ResidualAttentionBlock, x: torch.Tensor, n_streams: int, attend,
                   sequential: bool) -> torch.Tensor:
    """The gated block over ``n_streams`` streams; ``attend(i, sub, h)`` is
    stream ``i``'s attention of its sub-block ``sub`` from ``h``, LN(x).

    Parallel: each stream attends from LN(x) of the block input and
    contributes ``attn_out * tanh(gate)``; the deltas sum into x.
    Sequential: each stream's delta lands before the next stream attends.
    Both end with the shared tanh-gated FFN."""
    x_origin = x
    total_delta = torch.zeros_like(x)
    for i in range(n_streams):
        sub = p.gated_x_attn_layers[i]
        src = x if sequential else x_origin
        attn_out = attend(i, sub, layer_norm(sub.attn_ln, src))
        if sequential:
            x = x + attn_out * _gate(sub.attn_gate, x)
        else:
            total_delta = total_delta + attn_out * _gate(sub.attn_gate, x)
    if not sequential:
        x = x_origin + total_delta
    return _gated_ff_only(p, x)


def gated_x_attn(
    p: ResidualAttentionBlock, x: torch.Tensor, xt: torch.Tensor, n_head: int,
    sequential: bool = False,
) -> torch.Tensor:
    """Flamingo gated conditioning over the stacked streams ``xt``
    (n_langs, B, S, D), parallel or ``sequential`` as in
    :func:`_gated_streams`; returns the updated x."""
    return _gated_streams(
        p, x, xt.shape[0],
        lambda i, sub, h: attention_block(sub.attn, h, n_head, kv_src=xt[i]), sequential)


def _gated_ff_only(p: ResidualAttentionBlock, x: torch.Tensor) -> torch.Tensor:
    """The gated block's shared FFN (all a gated block does with no stream)."""
    return x + mlp_block(p.ff, layer_norm(p.ff_ln, x)) * _gate(p.ff_gate, x)


def _gated_x_attn_cached(
    p: ResidualAttentionBlock, x: torch.Tensor, xt_k: torch.Tensor, xt_v: torch.Tensor,
    n_head: int, sequential: bool = False,
    k_scale: Optional[torch.Tensor] = None, v_scale: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gated x-attn over precomputed per-stream K/V (n_langs, B, H, S, Dh);
    in the int8 modes the slabs are int8 with per-stream, per-head scales
    ``k_scale``/``v_scale`` (n_langs, B, H, 1, 1). ``mask``: the additive
    (B, 1, 1, S) key mask of slabs held at a capacity, or none."""
    def attend(i, sub, h):
        return attention_block(
            sub.attn, h, n_head, k_override=xt_k[i], v_override=xt_v[i],
            k_scale=None if k_scale is None else k_scale[i],
            v_scale=None if v_scale is None else v_scale[i], mask=mask,
        )

    return _gated_streams(p, x, xt_k.shape[0], attend, sequential)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

# The argument-free ``jax.checkpoint_policies`` names as the aten products
# each one saves (``None``: save everything, no checkpoint; an empty tuple:
# save nothing, full per-block recompute). The projections fold to 2-D
# ``mm`` / ``addmm``, dot_generals with no batch dims in JAX; the attention
# products are batched ``bmm`` / ``baddbmm``.
_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_ALL_DOTS = _NO_BATCH_DOTS + (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
REMAT_POLICIES = {
    "dots": _NO_BATCH_DOTS,
    "dots_with_no_batch_dims_saveable": _NO_BATCH_DOTS,
    "checkpoint_dots_with_no_batch_dims": _NO_BATCH_DOTS,
    "dots_saveable": _ALL_DOTS,
    "checkpoint_dots": _ALL_DOTS,
    "nothing_saveable": (),
    "everything_saveable": None,
}


def _remat_wrap(fn, remat):
    """The rematerialization spec of JAX's ``_remat_wrap`` for one block:
    ``False``/``"none"`` keeps every activation; ``True``/``"full"``
    recomputes the block in the backward (``checkpoint``, non-reentrant,
    only while grad is enabled); a name of :data:`REMAT_POLICIES` (an
    argument-free ``jax.checkpoint_policies`` name, ``"dots"`` for
    ``dots_with_no_batch_dims_saveable``) keeps the outputs of the products
    it names through ``torch.utils.checkpoint``'s selective checkpoint and
    recomputes the rest. The flash64 forward is no product, so it is
    recomputed, as JAX recomputes its ``pallas_call``: its output buffer
    comes from ``torch.empty``, which no policy saves, so the rerun writes
    into a new buffer. The numbers are the same under every spec. Unknown
    names, and the policies that take arguments, raise ``ValueError``."""
    if not remat or remat == "none":
        return fn
    if remat is True or remat == "full":
        saved = ()
    elif isinstance(remat, str) and remat in REMAT_POLICIES:
        saved = REMAT_POLICIES[remat]
        if saved is None:
            return fn
    else:
        # fail at config time with the accepted values (a YAML ``remat=false``
        # arrives as the *string* "false")
        raise ValueError(
            f"unknown remat spec {remat!r}: expected False/'none', "
            "True/'full', 'dots', or a jax.checkpoint_policies name"
        )
    kwargs = {"use_reentrant": False}
    if saved:
        kwargs["context_fn"] = lambda: create_selective_checkpoint_contexts(list(saved))

    def recomputed(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, **kwargs)

    return recomputed


def encoder_apply(
    params: Whisper, dims: ModelDimensions, mel: torch.Tensor, *,
    dtype: torch.dtype = torch.float32, remat=False,
) -> torch.Tensor:
    """mel (B, n_mels, T) -> audio features (B, min(T // 2, n_audio_ctx), D).

    Conv stack with GELU, sinusoidal positions cropped at ``n_audio_ctx``,
    pre-LN blocks whose self-attention goes through the flash64 kernel at
    d_head 64 (forward and backward when grad is enabled), final LN.
    ``remat`` as in :func:`_remat_wrap`."""
    enc = params.encoder
    x = gelu(conv1d(enc.conv1, mel.to(dtype), stride=1))
    x = gelu(conv1d(enc.conv2, x, stride=2)).transpose(1, 2)  # (B, T, D)
    x = x[:, : dims.n_audio_ctx]
    x = (x + enc.positional_embedding[: x.shape[1]]).to(dtype)
    n_head = dims.n_audio_head

    def block(x, blk):
        x = x + attention_block(blk.attn, layer_norm(blk.attn_ln, x), n_head, backend="flash")
        return x + mlp_block(blk.mlp, layer_norm(blk.mlp_ln, x))

    block = _remat_wrap(block, remat)
    for blk in enc.blocks:
        x = block(x, blk)
    return layer_norm(enc.ln_post, x)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _prepare_xt(params: Whisper, dims: ModelDimensions, xt: torch.Tensor, dtype) -> torch.Tensor:
    """Project the conditioning streams (n_langs, B, S, bert_dim) to the
    model width (``xt_projection`` when the widths differ) and add the
    decoder's learned positions over the stream length."""
    dec = params.decoder
    if xt.shape[2] > dims.n_text_ctx:
        raise ValueError(
            f"conditioning stream length {xt.shape[2]} exceeds n_text_ctx="
            f"{dims.n_text_ctx}: the stream takes the decoder positional "
            "embedding, which caps its length"
        )
    xt = xt.to(dtype)
    if xt.shape[-1] != dims.n_text_state:
        xt = linear(dec.xt_projection, xt)
    return xt + dec.positional_embedding[: xt.shape[2]].to(dtype)


def embed_tokens_as_xt(params: Whisper, dims: ModelDimensions, tokens: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A conditioning stream from the decoder's own token embedding: (B, S)
    token ids -> (1, B, S, n_text_state), to pass as ``xt`` (the legacy
    "keyword" / "mix" decoder modes, which condition the gated x-attn on
    embedded keyword tokens; :func:`_prepare_xt` adds the positions)."""
    dec = params.decoder
    return vocab_embedding(dec.token_embedding.weight, tokens, _tp(dec)).to(dtype)[None]


@torch.no_grad()
def init_cache(
    params: Whisper, dims: ModelDimensions, audio_features: torch.Tensor, *,
    xt: Optional[torch.Tensor] = None, max_len: Optional[int] = None,
    dtype: torch.dtype = torch.float32, quantize: bool = False, quantize_self: bool = False,
    xt_at_ctx: bool = False,
) -> Cache:
    """Preallocate the decode cache and precompute all static K/V.

    The audio cross-attention K/V (and, with conditioning streams, the
    gated x-attn K/V) depend only on the encoder output and the streams, so
    they are computed once here, K pre-scaled, both in the compute
    ``dtype``. The self cache is zeros (L, B, T, D) with T = ``max_len``
    (default ``n_text_ctx``).

    With ``quantize`` the static slabs are int8 with one float32 scale per
    head over (T, Dh): ``xa_k_s``/``xa_v_s`` (L, B, H, 1, 1) and
    ``xt_k_s``/``xt_v_s`` (L, n_langs, B, H, 1, 1). With ``quantize_self``
    (int8kv) the self cache is int8 too, with per-(token, head) scales
    ``k_s``/``v_s`` (L, B, T, H), zero where nothing is written yet.

    With ``xt_at_ctx`` the gated slabs hold ``n_text_ctx`` keys (at least
    the streams' S): the first S are the streams', the rest zero, and
    ``xt_mask`` (B, 1, 1, n_text_ctx) is 0 over the first S and -inf past
    them, so that streams of any length up to that cap make one shape.

    Under tensor parallelism the self cache and the gated slabs hold this
    rank's heads (D / n_model wide); the audio slabs are whole (the
    cross-attention is replicated)."""
    dec = params.decoder
    L, D, H = dims.n_text_layer, dims.n_text_state, dims.n_text_head
    B = audio_features.shape[0]
    T = max_len or dims.n_text_ctx
    dh = D // H
    scale = dh ** -0.25
    h_self = local_heads(dec.blocks[0].attn, H)
    h_xa = local_heads(dec.blocks[0].cross_attn, H)
    dev = audio_features.device
    xa = audio_features.to(dtype)
    xdt = torch.int8 if quantize else dtype  # the static slabs' dtype
    sdt = torch.int8 if quantize_self else dtype
    ta = xa.shape[1]
    cache: Cache = {
        "k": torch.zeros((L, B, T, h_self * dh), dtype=sdt, device=dev),
        "v": torch.zeros((L, B, T, h_self * dh), dtype=sdt, device=dev),
        "xa_k": torch.empty((L, B, h_xa, ta, dh), dtype=xdt, device=dev),
        "xa_v": torch.empty((L, B, h_xa, ta, dh), dtype=xdt, device=dev),
    }
    if quantize_self:
        cache["k_s"] = torch.zeros((L, B, T, h_self), dtype=torch.float32, device=dev)
        cache["v_s"] = torch.zeros((L, B, T, h_self), dtype=torch.float32, device=dev)

    def store(name: str, idx: tuple, k: torch.Tensor, v: torch.Tensor, keys: tuple = ()) -> None:
        # ``keys`` narrows the slab (not its per-head scale) to the keys written
        if quantize:
            k, cache[name + "_k_s"][idx] = quantize_int8(k, dim=(-2, -1))
            v, cache[name + "_v_s"][idx] = quantize_int8(v, dim=(-2, -1))
        cache[name + "_k"][idx + keys], cache[name + "_v"][idx + keys] = k, v

    if quantize:
        for key in ("xa_k_s", "xa_v_s"):
            cache[key] = torch.empty((L, B, h_xa, 1, 1), dtype=torch.float32, device=dev)
    for l, blk in enumerate(dec.blocks):
        store("xa", (l,), head_split_kv(linear(blk.cross_attn.key, xa), h_xa) * scale,
              head_split_kv(linear(blk.cross_attn.value, xa), h_xa))
    if xt is not None and dec.blocks[0].gated:
        xt_p = _prepare_xt(params, dims, xt, dtype)  # (n_langs, B, S, D)
        n_langs, _, s, _ = xt_p.shape
        cap = dims.n_text_ctx if xt_at_ctx else s  # _prepare_xt holds s to n_text_ctx
        h_xt = local_heads(dec.blocks[0].gated_x_attn_layers[0].attn, H)
        slab = torch.zeros if cap > s else torch.empty
        cache["xt_k"] = slab((L, n_langs, B, h_xt, cap, dh), dtype=xdt, device=dev)
        cache["xt_v"] = slab((L, n_langs, B, h_xt, cap, dh), dtype=xdt, device=dev)
        if quantize:
            for key in ("xt_k_s", "xt_v_s"):
                cache[key] = torch.empty((L, n_langs, B, h_xt, 1, 1), dtype=torch.float32,
                                         device=dev)
        if xt_at_ctx:
            mask = torch.zeros((B, 1, 1, cap), dtype=torch.float32, device=dev)
            mask[..., s:] = float("-inf")
            cache["xt_mask"] = mask
        keys = (slice(None), slice(None), slice(0, s))  # (B, H, S) of a stream's slab
        for l, blk in enumerate(dec.blocks):
            for i in range(n_langs):
                attn = blk.gated_x_attn_layers[i].attn
                store("xt", (l, i), head_split_kv(linear(attn.key, xt_p[i]), h_xt) * scale,
                      head_split_kv(linear(attn.value, xt_p[i]), h_xt), keys)
        cache["xt"] = xt_p
    return cache


def lm_head_weight(params: Whisper, dtype: torch.dtype) -> torch.Tensor:
    """The tied embedding as the logits matmul's float32 operand: its
    ``dtype`` values, upcast (cached by :func:`prepare_decode_params`; in
    the int8 modes the int8 values, which the logits scale by
    ``lm_head_s``). Under a vocabulary split, this rank's rows."""
    dec = params.decoder
    cached = getattr(dec, "lm_head_f32", None)
    if cached is not None:
        return cached
    return dec.token_embedding.weight.to(dtype).float()


def self_step_kernel(cache: Cache) -> bool:
    """Whether a one-token step over ``cache`` attends through
    :func:`..ops.decode_attn.fused_step`: every self cache but int8kv's."""
    return "k_s" not in cache


def decoder_apply(
    params: Whisper, dims: ModelDimensions, tokens: torch.Tensor,
    audio_features: Optional[torch.Tensor] = None, *,
    xt: Optional[torch.Tensor] = None, cache: Optional[Cache] = None,
    offset: Union[int, torch.Tensor] = 0, dtype: torch.dtype = torch.float32,
    sequential_xt: bool = False, return_cross_qk: bool = False, remat=False,
    gather_logits: bool = True, step_graphs: Optional["StepGraphs"] = None,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """tokens (B, T) [+ audio features (B, Ta, D)] -> (fp32 logits (B, T, V), cache).

    Without ``cache``: teacher-forced (full causal mask, cross-attention
    projected from ``audio_features`` in every layer); with
    ``return_cross_qk`` the second element is, in place of the cache, the
    stacked fp32 audio cross-attention logits (L, B, H, T, Ta) that word
    timing reads. With ``cache``: the
    decode path; the chunk's self K/V are written at ``offset`` (an int,
    or a (B,) tensor of per-row offsets) IN PLACE, and attention uses the
    precomputed audio / conditioning K/V. A one-token chunk (an
    incremental step) goes through the decode-attention kernel
    (:func:`..ops.decode_attn.fused_step`); a longer one (the prefill)
    through the plain cache write and attention. An int8kv cache (``k_s``
    in it) takes the plain write and attention in every step, as in the
    JAX package: the rows are written quantized with per-(token, head)
    scales. With ``ops.decode_mlp.ENABLED`` the MLP goes through
    :func:`..ops.decode_mlp.fused_mlp`. Int8 static slabs carry their
    scales in the cache; an int8 lm head (``lm_head_s``) scales the fp32
    logits per vocabulary row.

    A gated model run without streams applies only the gated blocks'
    shared FFN (zero attention delta).

    The teacher-forced path is differentiable (``remat`` as in
    :func:`_remat_wrap`); the cache path runs without autograd. Under a
    vocabulary split the logits are gathered unless ``gather_logits`` is
    false, which leaves this rank's (B, T, V / n_model) block.

    ``step_graphs`` (the decode loop's :class:`StepGraphs`) takes the
    incremental steps it applies to; their logits are its static tensor,
    valid until its next replay."""
    if cache is not None and torch.is_grad_enabled():
        with torch.no_grad():
            return decoder_apply(
                params, dims, tokens, audio_features, xt=xt, cache=cache, offset=offset,
                dtype=dtype, sequential_xt=sequential_xt, return_cross_qk=return_cross_qk,
                gather_logits=gather_logits, step_graphs=step_graphs,
            )
    if step_graphs is not None and cache is not None:
        logits = step_graphs.step(params, dims, tokens, cache, offset, dtype, sequential_xt)
        if logits is not None:
            return logits, cache
    dec = params.decoder
    n_head = dims.n_text_head
    T = tokens.shape[-1]
    dev = tokens.device

    pe = dec.positional_embedding
    if isinstance(offset, torch.Tensor) and offset.dim() == 1:
        pos = pe[offset.long()[:, None] + torch.arange(T, device=dev)[None]]
    else:
        pos = pe[int(offset): int(offset) + T]
    x = _embed(dec, tokens, pos, dtype)

    use_gated = dec.blocks[0].gated
    if return_cross_qk and cache is not None:
        raise ValueError("return_cross_qk runs on the teacher-forced path only (no cache)")
    if cache is None:
        xt_p = _prepare_xt(params, dims, xt, dtype) if (use_gated and xt is not None) else None
        mask = causal_mask(T, device=dev)
        xa = audio_features.to(dtype)

        def block(x, blk):
            if xt_p is not None:
                x = gated_x_attn(blk, x, xt_p, n_head, sequential=sequential_xt)
            elif use_gated:
                x = _gated_ff_only(blk, x)
            x = x + attention_block(blk.attn, layer_norm(blk.attn_ln, x), n_head, mask=mask)
            cross = attention_block(
                blk.cross_attn, layer_norm(blk.cross_attn_ln, x), n_head, kv_src=xa,
                return_qk=return_cross_qk,
            )
            qk = None
            if return_cross_qk:
                cross, qk = cross
            x = x + cross
            return x + mlp_block(blk.mlp, layer_norm(blk.mlp_ln, x)), qk

        block = _remat_wrap(block, remat)
        qks = []
        for blk in dec.blocks:
            x, qk = block(x, blk)
            qks.append(qk)
        if return_cross_qk:
            cache = torch.stack(qks)
    else:
        scale = (dims.n_text_state // n_head) ** -0.25
        have_xt_kv = use_gated and "xt_k" in cache
        quantized_self = not self_step_kernel(cache)
        use_kernel = T == 1 and not quantized_self  # an int offset goes to it by value
        mask = None if use_kernel else cached_causal_mask(
            T, cache["k"].shape[-2], offset, device=dev
        )
        n_self = local_heads(dec.blocks[0].attn, n_head)
        for l, blk in enumerate(dec.blocks):
            x, q, k_raw, v_raw = _step_in(blk, x, cache, l, n_head, use_gated, have_xt_kv,
                                          sequential_xt)
            k_l, v_l = cache["k"][l], cache["v"][l]
            if use_kernel:
                attn = decode_attn.fused_step(q, k_raw, v_raw, k_l, v_l, offset, n_self)[0]
            elif quantized_self:
                k_q, k_s = quantize_tokenwise_kv(k_raw * scale, n_self)
                v_q, v_s = quantize_tokenwise_kv(v_raw, n_self)
                k_s_l, v_s_l = cache["k_s"][l], cache["v_s"][l]
                for slab, new in ((k_l, k_q), (v_l, v_q), (k_s_l, k_s), (v_s_l, v_s)):
                    update_cache(slab, new, offset)
                attn = cached_qkv_attention(q, k_l, v_l, n_self, mask=mask,
                                            k_scale=k_s_l, v_scale=v_s_l)
            else:
                update_cache(k_l, k_raw * scale, offset)
                update_cache(v_l, v_raw, offset)
                attn = cached_qkv_attention(q, k_l, v_l, n_self, mask=mask)
            x = _step_out(blk, x, attn, cache, l, n_head)
    return _logits(params, x, gather_logits), cache


def _embed(dec: TextDecoder, tokens: torch.Tensor, pos: torch.Tensor, dtype) -> torch.Tensor:
    """Token embedding plus position rows, in the compute dtype."""
    return (vocab_embedding(dec.token_embedding.weight, tokens, _tp(dec)) + pos).to(dtype)


def _slab(cache: Cache, key: str, l: int) -> Optional[torch.Tensor]:
    return cache[key][l] if key in cache else None


def _step_in(blk: ResidualAttentionBlock, x: torch.Tensor, cache: Cache, l: int, n_head: int,
             use_gated: bool, have_xt_kv: bool, sequential_xt: bool):
    """The cached layer ``l`` up to its self-attention: the gated block over
    the cached streams (a gated model without them: its FFN alone),
    ``attn_ln`` and the projections. Returns ``(x, q, k_raw, v_raw)``."""
    if have_xt_kv:
        x = _gated_x_attn_cached(
            blk, x, cache["xt_k"][l], cache["xt_v"][l], n_head, sequential=sequential_xt,
            k_scale=_slab(cache, "xt_k_s", l), v_scale=_slab(cache, "xt_v_s", l),
            mask=cache.get("xt_mask"),
        )
    elif use_gated:
        x = _gated_ff_only(blk, x)
    ap = blk.attn
    x_ln = copy_to_tp(layer_norm(blk.attn_ln, x), _tp(ap))
    return x, linear(ap.query, x_ln), linear(ap.key, x_ln), linear(ap.value, x_ln)


def _step_out(blk: ResidualAttentionBlock, x: torch.Tensor, attn: torch.Tensor, cache: Cache,
              l: int, n_head: int) -> torch.Tensor:
    """The cached layer ``l`` after its self-attention ``attn``: the out
    projection, the cross-attention over the cached audio slabs, the MLP."""
    ap = blk.attn
    x = x + row_linear(ap.out, attn, _tp(ap))
    x = x + attention_block(
        blk.cross_attn, layer_norm(blk.cross_attn_ln, x), n_head,
        k_override=cache["xa_k"][l], v_override=cache["xa_v"][l],
        k_scale=_slab(cache, "xa_k_s", l), v_scale=_slab(cache, "xa_v_s", l),
    )
    if decode_mlp.ENABLED:
        return x + decode_mlp.fused_mlp(blk.mlp, layer_norm(blk.mlp_ln, x))
    return x + mlp_block(blk.mlp, layer_norm(blk.mlp_ln, x))


def _logits(params: Whisper, x: torch.Tensor, gather_logits: bool) -> torch.Tensor:
    """The final LN and the tied-embedding fp32 logits (an int8 lm head
    scaled per vocabulary row), gathered over a vocabulary split unless
    ``gather_logits`` is false."""
    dec = params.decoder
    vocab_tp = _tp(dec)
    x = copy_to_tp(layer_norm(dec.ln, x), vocab_tp)
    logits = torch.matmul(x.float(), lm_head_weight(params, x.dtype).t())
    lm_head_s = getattr(dec, "lm_head_s", None)
    if lm_head_s is not None:  # int8 lm head: per-vocabulary-row scales
        logits = logits * lm_head_s
    if gather_logits:
        logits = gather_from_tp(logits, vocab_tp)
    return logits


# The static slabs the incremental step reads; the self cache k/v is read and
# written only by the decode-attention kernel
STATIC_SLABS = ("xa_k", "xa_v", "xa_k_s", "xa_v_s", "xt_k", "xt_v", "xt_k_s", "xt_v_s",
                "xt_mask")


class StepGraphs:
    """The decode loop's one-token cached decoder step, replayed from CUDA
    graphs: a :class:`..decoding.DecodingTask` owns one and passes it to
    every incremental :func:`decoder_apply`.

    The step is cut at each layer's decode-attention launch into
    ``n_text_layer + 1`` segments: segment 0 is the token embedding and
    position, then layer 0 up to its q/k/v projections (gated
    cross-attention, ``attn_ln``); segment ``l`` is layer ``l - 1``'s
    self-attention out projection, cross-attention and MLP, then layer
    ``l`` up to its projections; the last one ends with the final LN and
    the fp32 logits. Between two segments
    :func:`..ops.decode_attn.fused_step` runs eagerly as in the unsegmented
    step (looked up on its module at call time, the Python-int offset by
    value, the self caches in place) and its output is copied into the
    next segment's static input. What changes between steps inside a
    segment is read from static buffers filled before the replay: the
    token and the offset (the position row). The static slabs
    (:data:`STATIC_SLABS`) are the holder's, one set per shape key: a new
    batch's values are copied in and its cache rebound to them.

    One key is ``(params, rows, dtype, sequential streams, each static
    slab's shape and dtype)``: rows, audio frames, stream count and length,
    quantization. A cache whose gated slabs are held at a capacity
    (``init_cache(xt_at_ctx=True)``, the audio-visual decode) gives every
    stream length one key, its mask a static slab. Its first
    :attr:`WARMUP` forwards run the unsegmented step; the next captures the
    segments (one memory pool a key) under the span ``decode.capture`` and
    every later forward replays them. The
    logits a replay returns are the holder's static tensor, overwritten by
    the next replay.

    It applies to a one-token step at a Python-int offset on CUDA, with no
    decoder module split by tensor parallelism, no int8kv self cache (its
    plain write runs at the offset inside the chain) and
    ``ops.decode_mlp.ENABLED`` off; otherwise :meth:`step` returns
    ``None`` and the caller runs the unsegmented step. ``capture=False``
    runs the segments eagerly over the same static buffers, on any device
    (the CPU tests). Counters: ``decode.graph_steps`` (forwards through the
    segments), ``decode.eager_steps`` (forwards left to the unsegmented
    step) and ``decode.graph_captures``."""

    WARMUP = 2

    def __init__(self, capture: bool = True):
        self.capture = capture
        self._params: Optional[Whisper] = None
        self._split = False
        self._seen: Dict[tuple, int] = {}
        self._built: Dict[tuple, _StepSegments] = {}

    def _key(self, params: Whisper, tokens: torch.Tensor, cache: Cache, offset,
             dtype: torch.dtype, sequential_xt: bool) -> Optional[tuple]:
        if params is not self._params:  # another model: nothing built applies
            self._params, self._seen, self._built = params, {}, {}
            self._split = any(_tp(m) is not None for m in params.decoder.modules())
        if (self._split or (self.capture and not tokens.is_cuda) or tokens.shape[-1] != 1
                or not isinstance(offset, int) or "k_s" in cache or decode_mlp.ENABLED):
            return None
        slabs = tuple((n, tuple(cache[n].shape), cache[n].dtype) for n in STATIC_SLABS
                      if n in cache)
        return (tokens.shape[0], dtype, sequential_xt) + slabs

    def step(self, params: Whisper, dims: ModelDimensions, tokens: torch.Tensor, cache: Cache,
             offset, dtype: torch.dtype, sequential_xt: bool) -> Optional[torch.Tensor]:
        """The step's fp32 logits (rows, 1, V) from the segments, or ``None``
        where the caller runs the unsegmented step (a key's warm-up, or a
        step the holder does not apply to)."""
        key = self._key(params, tokens, cache, offset, dtype, sequential_xt)
        built = self._built.get(key)
        if built is None:
            seen = self._seen.get(key, 0)
            if key is None or seen < self.WARMUP:
                if key is not None:
                    self._seen[key] = seen + 1
                profiling.count("decode.eager_steps")
                return None
            with profiling.span("decode.capture"):
                built = self._built[key] = _StepSegments(
                    params, dims, tokens, cache, dtype, sequential_xt, self.capture)
            profiling.count("decode.graph_captures")
        profiling.count("decode.graph_steps")
        return built.run(tokens, cache, offset)


class _StepSegments:
    """One key's static buffers and segments (captured, or run eagerly)."""

    def __init__(self, params: Whisper, dims: ModelDimensions, tokens: torch.Tensor,
                 cache: Cache, dtype: torch.dtype, sequential_xt: bool, capture: bool):
        dec = params.decoder
        self.params, self.dtype, self.sequential_xt = params, dtype, sequential_xt
        self.n_head = dims.n_text_head
        self.n_self = local_heads(dec.blocks[0].attn, self.n_head)
        self.use_gated = dec.blocks[0].gated
        self.have_xt_kv = self.use_gated and "xt_k" in cache
        dev, rows = tokens.device, tokens.shape[0]
        self.tok = torch.zeros((rows, 1), dtype=torch.long, device=dev)
        self.off = torch.zeros((1,), dtype=torch.long, device=dev)
        self.slabs = {n: torch.empty_like(cache[n]) for n in STATIC_SLABS if n in cache}
        d_self = cache["k"].shape[-1]
        self.attn = [torch.zeros((rows, 1, d_self), dtype=dtype, device=dev)
                     for _ in dec.blocks]
        self.outs: list = [None] * (len(dec.blocks) + 1)
        self.graphs = None
        if capture:
            self._capture(dev)

    def _segment(self, i: int):
        """Segment ``i``: ``(x, q, k_raw, v_raw)`` before layer ``i``'s
        self-attention, or the logits after the last layer."""
        dec = self.params.decoder
        if i == 0:
            pos = dec.positional_embedding.index_select(0, self.off)
            x = _embed(dec, self.tok, pos, self.dtype)
        else:
            x = _step_out(dec.blocks[i - 1], self.outs[i - 1][0], self.attn[i - 1], self.slabs,
                          i - 1, self.n_head)
        if i == len(dec.blocks):
            return _logits(self.params, x, gather_logits=True)
        return _step_in(dec.blocks[i], x, self.slabs, i, self.n_head, self.use_gated,
                        self.have_xt_kv, self.sequential_xt)

    def _capture(self, dev: torch.device) -> None:
        pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        self.graphs = [torch.cuda.CUDAGraph() for _ in self.outs]
        with torch.cuda.stream(side):
            for i, g in enumerate(self.graphs):
                g.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    self.outs[i] = self._segment(i)
                finally:
                    g.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)

    def run(self, tokens: torch.Tensor, cache: Cache, offset: int) -> torch.Tensor:
        if cache["xa_k"] is not self.slabs["xa_k"]:  # a new batch: its slabs in
            for n, slab in self.slabs.items():
                slab.copy_(cache[n])
                cache[n] = slab
        self.tok.copy_(tokens)
        self.off.fill_(offset)
        for i in range(len(self.outs)):
            if self.graphs is None:
                self.outs[i] = self._segment(i)
            else:
                self.graphs[i].replay()
            if i < len(self.attn):
                _, q, k_raw, v_raw = self.outs[i]
                attn = decode_attn.fused_step(q, k_raw, v_raw, cache["k"][i], cache["v"][i],
                                              offset, self.n_self)[0]
                self.attn[i].copy_(attn)
        return self.outs[-1]


# ---------------------------------------------------------------------------
# Initialization and the decode-time parameter copy
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_params(
    generator: torch.Generator, dims: ModelDimensions,
    extras: ModelExtras = ModelExtras(), device=None,
) -> Whisper:
    """A randomly initialized float32 ``Whisper`` on ``device`` (the card
    unless named; see :func:`..utils.resolve_device`).

    The JAX package's distributions: linear weights N(0, 1/d_in), zero
    biases, unit LayerNorms, conv weights N(0, 1/(3 d_in)), token embedding
    N(0, 1/D), positional embedding 0.01 N(0, 1), gates zero (a fresh
    Flamingo layer is the identity). ``generator`` must live on
    ``device``; the values differ from JAX's for the same seed."""
    device = resolve_device(device)
    with device:
        model = Whisper(dims, extras).to(device)

    def normal(t: torch.Tensor, std: float) -> None:
        t.normal_(0.0, std, generator=generator)

    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            normal(mod.weight, 1.0 / math.sqrt(mod.in_features))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Conv1d):
            normal(mod.weight, 1.0 / math.sqrt(3 * mod.in_channels))
            mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, GatedXAttnSubBlock):
            mod.attn_gate.zero_()
        elif isinstance(mod, ResidualAttentionBlock) and mod.gated:
            mod.ff_gate.zero_()
    normal(model.decoder.token_embedding.weight, 1.0 / math.sqrt(dims.n_text_state))
    normal(model.decoder.positional_embedding, 0.01)
    return model.eval()


def _quantize_linear(p: nn.Linear, row_tp=None) -> None:
    """``row_tp``: the mesh of a row-parallel layer, whose per-output-channel
    amax spans the input features of every rank (``all_reduce`` max)."""
    amax_reduce = None
    if row_tp is not None:
        def amax_reduce(a):
            return row_tp.all_reduce(a, MODEL_AXIS, "max")
    w_q, w_s = quantize_linear_params(p.weight, amax_reduce)
    p.weight = None  # the int8 copy replaces it
    p.register_buffer("w_q", w_q, persistent=False)
    p.register_buffer("w_s", w_s, persistent=False)


@torch.no_grad()
def quantize_decode_params(params: Whisper) -> Whisper:
    """Quantize, IN PLACE, the decoder weights the incremental decode loop
    re-reads every token (``DecodingOptions(quantize=...)``); takes the
    decode copy that :func:`prepare_decode_params` makes and returns it.

    Each linear gets an int8 ``w_q`` with per-output-channel float32
    ``w_s`` in place of its weight: self-attention q, k, v and out (the
    JAX package quantizes its fused QKV weight; per-output-channel scales
    make the int8 values and scales the same), cross-attention q and out,
    the MLP, the gated per-stream q and out and the gated FFN. The lm head
    gets an int8 copy of the embedding with per-vocabulary-row scales
    (``lm_head_q``/``lm_head_s``) for the logits only: the embedding
    gather keeps the table. Read once at prefill and kept as they are:
    cross-attention and gated k/v, ``xt_projection``, the positions and
    every LayerNorm. Under tensor parallelism a row-parallel weight's
    scales span the full input dimension, as in JAX (its amax is reduced
    over the model axis); the other scales are per output channel and
    local already."""
    dec = params.decoder
    for blk in dec.blocks:
        for lin in (blk.attn.query, blk.attn.key, blk.attn.value,
                    blk.cross_attn.query, blk.cross_attn.out, blk.mlp[0]):
            _quantize_linear(lin)
        _quantize_linear(blk.attn.out, _tp(blk.attn))
        _quantize_linear(blk.mlp[2], _tp(blk.mlp))
        if blk.gated:
            for sub in blk.gated_x_attn_layers:
                _quantize_linear(sub.attn.query)
                _quantize_linear(sub.attn.out, _tp(sub.attn))
            _quantize_linear(blk.ff[0])
            _quantize_linear(blk.ff[2], _tp(blk.ff))
    lm_q, lm_s = quantize_int8(dec.token_embedding.weight, dim=-1)
    dec.register_buffer("lm_head_q", lm_q, persistent=False)
    dec.register_buffer("lm_head_s", lm_s.squeeze(-1), persistent=False)
    dec.lm_head_f32 = lm_q.float()  # the logits matmul's operand: the int8 values
    return params


@torch.no_grad()
def prepare_decode_params(params: Whisper, dtype: torch.dtype, quantize: bool = False) -> Whisper:
    """The decode loop's one-time parameter copy: every float32 decoder
    weight cast to the compute ``dtype`` (as the JAX package casts its fp32
    masters), then, with ``quantize``, :func:`quantize_decode_params`; the
    tied embedding's float32 operand for the logits matmul cached. The
    encoder is shared, not copied: the decode loop does not run it. With
    ``dtype`` float32 and no quantization the model itself is returned.
    One place for this keeps speculative decoding token-identical to
    greedy."""
    if dtype == torch.float32 and not quantize:
        return params
    out = copy.deepcopy(params, memo={id(params.encoder): params.encoder})
    for p in out.decoder.parameters():
        if p.dtype == torch.float32:
            p.data = p.data.to(dtype)
    if quantize:
        return quantize_decode_params(out)
    out.decoder.lm_head_f32 = out.decoder.token_embedding.weight.detach().float()
    return out
