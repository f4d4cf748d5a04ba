"""Legacy model components from the reference's experimental variants.

Port of ``whisper_flamingo_tpu/models/legacy.py`` (the auxiliary modules of
the reference's ``model_all.py`` and ``model_tmp.py``):

- :func:`resnet1d_apply`: a 1-D conv ResNet over token embeddings
  (conv-BN-ReLU-conv-BN residual blocks, inference BatchNorm; the module
  :class:`ResNet1D` keys ``layers.{i}.{0,1,3,4}`` as the reference's);
- :func:`reprogramming_apply`: cross-attention that re-programs Whisper
  token embeddings into an LLM (BERT) embedding space, over a source shared
  by the batch (``_m1``, (S, D)) or batched (``_m2``, (B, S, D));
  :class:`Reprogramming` names its linears after the JAX parameters
  (``q``, ``k``, ``v``, ``out``): no checkpoint of it is imported;
- the AdaKWS keyword spotter: a character LSTM over each keyword gives
  AdaIN statistics for two keyword-adaptive transformer blocks over the
  audio features, then a max pool and a binary classifier per keyword.
  :class:`AdaKWS` carries the reference's keys (``embedding``,
  ``lstm.weight_ih_l{k}``, ``fc_mu``, ``fc_sigma``,
  ``kw_module{1,2}.self_attn.{in_proj_weight,out_proj}``, ``fc1``, ``fc2``,
  ``classifier``), so :func:`load_adakws_torch` is a key filter.

No parameter requires grad (the modules are inference-only here). The
compute is plain functions over the modules, with the JAX package's
numerics: the LSTM is a Python loop over time with the gates in the order
i, f, g, o and one summed bias; attention scales q and k by d_head^-0.25.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import qkv_attention
from ..utils import resolve_device
from .visual import batch_norm
from .whisper import linear

# ---------------------------------------------------------------------------
# ResNet1D over embeddings
# ---------------------------------------------------------------------------


class ResNet1D(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Sequential(
                nn.Conv1d(input_dim, hidden_dim, 3, padding=1), nn.BatchNorm1d(hidden_dim),
                nn.ReLU(), nn.Conv1d(hidden_dim, input_dim, 3, padding=1),
                nn.BatchNorm1d(input_dim),
            )
            for _ in range(num_layers)
        )
        self.requires_grad_(False)


def _conv1d_same(p: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    return F.conv1d(x, p.weight.to(x.dtype), p.bias.to(x.dtype), padding=1)


def resnet1d_apply(params: ResNet1D, x: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B, T, D) through conv-BN-ReLU-conv-BN residual blocks."""
    x = x.transpose(1, 2)  # (B, D, T)
    for blk in params.layers:
        out = F.relu(batch_norm(blk[1], _conv1d_same(blk[0], x)))
        out = batch_norm(blk[4], _conv1d_same(blk[3], out))
        x = F.relu(out + x)
    return x.transpose(1, 2)


@torch.no_grad()
def init_resnet1d(generator: torch.Generator, input_dim: int, hidden_dim: int,
                  num_layers: int, device=None) -> ResNet1D:
    """Conv weights N(0, 1 / (3 d_in)), zero biases, identity BatchNorms."""
    device = resolve_device(device)
    with device:
        model = ResNet1D(input_dim, hidden_dim, num_layers).to(device)
    for mod in model.modules():
        if isinstance(mod, nn.Conv1d):
            mod.weight.normal_(0.0, 1.0 / math.sqrt(3 * mod.in_channels), generator=generator)
            mod.bias.zero_()
    return model.eval()


# ---------------------------------------------------------------------------
# Reprogramming layer
# ---------------------------------------------------------------------------


class Reprogramming(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_keys: Optional[int] = None,
                 d_llm: Optional[int] = None):
        super().__init__()
        d_keys = d_keys or (d_model // n_heads)
        d_llm = d_llm or d_model
        self.q = nn.Linear(d_model, d_keys * n_heads)
        self.k = nn.Linear(d_llm, d_keys * n_heads)
        self.v = nn.Linear(d_llm, d_keys * n_heads)
        self.out = nn.Linear(d_keys * n_heads, d_llm)
        self.requires_grad_(False)


def reprogramming_apply(params: Reprogramming, target: torch.Tensor, source: torch.Tensor,
                        value: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Cross-attend ``target`` (B, L, d_model) into an embedding space.
    ``source`` / ``value``: (S, d_llm) shared by the batch (``_m1``) or
    (B, S, d_llm) batched (``_m2``). Returns (B, L, d_llm)."""
    b, l, _ = target.shape
    q = linear(params.q, target).reshape(b, l, n_heads, -1)
    k = linear(params.k, source)
    v = linear(params.v, value)
    scale = 1.0 / math.sqrt(q.shape[-1])
    if source.dim() == 2:
        k = k.reshape(source.shape[0], n_heads, -1)
        v = v.reshape(value.shape[0], n_heads, -1)
        scores = torch.einsum("blhd,shd->bhls", q, k) * scale
        out = torch.einsum("bhls,shd->blhd", torch.softmax(scores, dim=-1), v)
    else:
        k = k.reshape(b, source.shape[1], n_heads, -1)
        v = v.reshape(b, value.shape[1], n_heads, -1)
        scores = torch.einsum("blhd,bshd->bhls", q, k) * scale
        out = torch.einsum("bhls,bshd->blhd", torch.softmax(scores, dim=-1), v)
    return linear(params.out, out.reshape(b, l, -1))


def _init_linears(model: nn.Module, generator: torch.Generator) -> None:
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.in_features), generator=generator)
            mod.bias.zero_()


@torch.no_grad()
def init_reprogramming(generator: torch.Generator, d_model: int, n_heads: int,
                       d_keys: Optional[int] = None, d_llm: Optional[int] = None,
                       device=None) -> Reprogramming:
    """Linear weights N(0, 1/d_in), zero biases."""
    device = resolve_device(device)
    with device:
        model = Reprogramming(d_model, n_heads, d_keys, d_llm).to(device)
    _init_linears(model, generator)
    return model.eval()


# ---------------------------------------------------------------------------
# AdaKWS keyword spotter
# ---------------------------------------------------------------------------


class KeywordAdaptiveModule(nn.Module):
    def __init__(self, d_model: int, n_heads: int, dim_ff: int):
        super().__init__()
        self.self_attn = nn.MultiheadAttention(d_model, n_heads)
        self.fc1 = nn.Linear(d_model, dim_ff)
        self.fc2 = nn.Linear(dim_ff, d_model)


class AdaKWS(nn.Module):
    def __init__(self, vocab_size: int, d_model: int = 768, embed_dim: int = 128,
                 hidden_dim: int = 256, num_lstm_layers: int = 4, dim_ff: int = 2048,
                 n_heads: int = 8):
        super().__init__()
        self.n_heads = n_heads
        self.embedding = nn.Embedding(vocab_size, embed_dim)
        self.lstm = nn.LSTM(embed_dim, hidden_dim, num_lstm_layers, batch_first=True)
        self.fc_mu = nn.Linear(hidden_dim, d_model)
        self.fc_sigma = nn.Linear(hidden_dim, d_model)
        self.kw_module1 = KeywordAdaptiveModule(d_model, n_heads, dim_ff)
        self.kw_module2 = KeywordAdaptiveModule(d_model, n_heads, dim_ff)
        self.classifier = nn.Linear(d_model, 2)
        self.requires_grad_(False)


def lstm_layer(lstm: nn.LSTM, k: int, xs: torch.Tensor):
    """Layer ``k`` of ``lstm`` over (B, T, D_in): (outputs (B, T, H), final h)."""
    w_ih, w_hh = getattr(lstm, f"weight_ih_l{k}"), getattr(lstm, f"weight_hh_l{k}")
    bias = getattr(lstm, f"bias_ih_l{k}") + getattr(lstm, f"bias_hh_l{k}")
    b, hdim = xs.shape[0], w_hh.shape[1]
    h = xs.new_zeros((b, hdim))
    c = xs.new_zeros((b, hdim))
    outs = []
    for t in range(xs.shape[1]):
        gates = xs[:, t] @ w_ih.t() + h @ w_hh.t() + bias
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs, dim=1), h


def adain(z: torch.Tensor, mu_v: torch.Tensor, sigma_v: torch.Tensor,
          eps: float = 1e-5) -> torch.Tensor:
    """Adaptive instance norm over time (axis 1), population variance."""
    mu_z = z.mean(dim=1, keepdim=True)
    sigma_z = z.var(dim=1, keepdim=True, unbiased=False).sqrt() + eps
    return sigma_v * ((z - mu_z) / sigma_z) + mu_v


def _kw_module_apply(p: KeywordAdaptiveModule, x: torch.Tensor, mu_v, sigma_v,
                     n_heads: int) -> torch.Tensor:
    d = x.shape[-1]
    w, b = p.self_attn.in_proj_weight, p.self_attn.in_proj_bias
    x_norm = adain(x, mu_v, sigma_v)
    q, k, v = (F.linear(x_norm, w[i * d:(i + 1) * d], b[i * d:(i + 1) * d]) for i in range(3))
    x = x + linear(p.self_attn.out_proj, qkv_attention(q, k, v, n_heads))
    x_norm = adain(x, mu_v, sigma_v)
    return x + linear(p.fc2, F.relu(linear(p.fc1, x_norm)))


def adakws_apply(params: AdaKWS, audio_features: torch.Tensor,
                 keyword_tokens: torch.Tensor) -> torch.Tensor:
    """audio (B, T, D) + keywords (B, K, L) character ids -> logits (B, K, 2)."""
    b, t, d = audio_features.shape
    _, k, l = keyword_tokens.shape
    h = params.embedding.weight[keyword_tokens.reshape(b * k, l).long()]
    for layer in range(params.lstm.num_layers):
        h, h_final = lstm_layer(params.lstm, layer, h)
    mu_v = linear(params.fc_mu, h_final)[:, None]  # (B*K, 1, D)
    sigma_v = linear(params.fc_sigma, h_final)[:, None]

    # keywords folded into the batch
    z = audio_features[:, None].expand(b, k, t, d).reshape(b * k, t, d)
    z = _kw_module_apply(params.kw_module1, z, mu_v, sigma_v, params.n_heads)
    z = _kw_module_apply(params.kw_module2, z, mu_v, sigma_v, params.n_heads)
    return linear(params.classifier, z.amax(dim=1)).reshape(b, k, 2)


@torch.no_grad()
def init_adakws(generator: torch.Generator, vocab_size: int, d_model: int = 768,
                embed_dim: int = 128, hidden_dim: int = 256, num_lstm_layers: int = 4,
                dim_ff: int = 2048, device=None) -> AdaKWS:
    """The JAX package's distributions: embedding N(0, 1), linear and LSTM
    weights N(0, 1/d_in), zero biases."""
    device = resolve_device(device)
    with device:
        model = AdaKWS(vocab_size, d_model, embed_dim, hidden_dim, num_lstm_layers,
                       dim_ff).to(device)
    model.embedding.weight.normal_(0.0, 1.0, generator=generator)
    _init_linears(model, generator)
    for name, p in model.lstm.named_parameters():
        if name.startswith("weight"):
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
        else:
            p.zero_()
    for kw in (model.kw_module1, model.kw_module2):
        attn = kw.self_attn
        attn.in_proj_weight.normal_(0.0, 1.0 / math.sqrt(d_model), generator=generator)
        attn.in_proj_bias.zero_()
    return model.eval()


def load_adakws_torch(state: Mapping[str, Any], vocab_size: int, device=None,
                      **kw) -> AdaKWS:
    """A torch AdaKWS checkpoint (the reference loads it onto
    ``Whisper.keyword_spotter``): keys with a ``text_encoder.`` prefix lose
    it; the keys of :class:`AdaKWS` found are loaded over a seed-0 init
    (``kw`` as :func:`init_adakws`), the others ignored."""
    model = init_adakws(torch.Generator().manual_seed(0), vocab_size, device="cpu", **kw)
    p = {k.split("text_encoder.", 1)[-1]: v for k, v in state.items()}
    own = model.state_dict()
    model.load_state_dict({k: torch.as_tensor(p[k]).float() for k in own if k in p},
                          strict=False)
    return model.to(resolve_device(device))
