"""Text conditioners: the ``xt`` streams read by the gated cross-attention.

Port of ``whisper_flamingo_tpu/models/bert.py``. The reference runs a HF
BERT over the translation strings of every batch (``bert-base-chinese`` or
``bert-base-multilingual-cased``, one pass per translation language); the
conditioners turn lists of strings into (B, S, D) float32 tensors on their
device:

- :class:`HFBertConditioner`: :class:`BertModel`, a BERT encoder written
  in PyTorch (what ``FlaxBertModel``'s ``last_hidden_state`` computes), over
  a tokenizer. Weights come from a local HF directory or cache
  (``pytorch_model.bin``), or from a random init for offline runs. Nothing
  is downloaded;
- :class:`PrecomputedConditioner`: a lookup of embeddings stored by the
  sha1 of their text.

The port needs no ``transformers`` for BERT itself: only a pretrained (or
locally cached) tokenizer imports it, lazily. The JAX package left BERT
to XLA (Flax, no Pallas kernel), so attention here is plain PyTorch: the
flash64 kernel takes no mask and cannot serve padded rows.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import profiling
from ..utils import resolve_device

Device = Optional[Union[str, torch.device]]


@dataclass(frozen=True)
class BertDims:
    """A BERT encoder's widths, as a HF ``config.json`` names them."""

    vocab_size: int
    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    intermediate_size: int
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02

    @staticmethod
    def from_config_json(path: str) -> "BertDims":
        """The widths of a HF ``config.json`` (read without ``transformers``);
        only the exact-GELU BERT is supported."""
        with open(path) as f:
            raw = json.load(f)
        if raw.get("hidden_act", "gelu") != "gelu":
            raise ValueError(f"{path}: hidden_act {raw['hidden_act']!r} (only 'gelu', the exact "
                             "erf form, is supported)")
        names = {f.name for f in dataclasses.fields(BertDims)}
        return BertDims(**{k: v for k, v in raw.items() if k in names})


class _Dense(nn.Module):
    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.dense = nn.Linear(n_in, n_out)


class _DenseNorm(nn.Module):
    def __init__(self, n_in: int, n_out: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(n_in, n_out)
        self.LayerNorm = nn.LayerNorm(n_out, eps=eps)


class _SelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.query, self.key, self.value = nn.Linear(d, d), nn.Linear(d, d), nn.Linear(d, d)


class _Attention(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.self = _SelfAttention(d)
        self.output = _DenseNorm(d, d, eps)


class _Layer(nn.Module):
    def __init__(self, dims: BertDims):
        super().__init__()
        d, eps = dims.hidden_size, dims.layer_norm_eps
        self.attention = _Attention(d, eps)
        self.intermediate = _Dense(d, dims.intermediate_size)
        self.output = _DenseNorm(dims.intermediate_size, d, eps)


class _Embeddings(nn.Module):
    def __init__(self, dims: BertDims):
        super().__init__()
        d = dims.hidden_size
        self.word_embeddings = nn.Embedding(dims.vocab_size, d)
        self.position_embeddings = nn.Embedding(dims.max_position_embeddings, d)
        self.token_type_embeddings = nn.Embedding(dims.type_vocab_size, d)
        self.LayerNorm = nn.LayerNorm(d, eps=dims.layer_norm_eps)


class _Encoder(nn.Module):
    def __init__(self, dims: BertDims):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(dims) for _ in range(dims.num_hidden_layers))


class BertModel(nn.Module):
    """The BERT encoder without its pooler: ``forward(input_ids,
    attention_mask)`` is the last hidden state (B, S, D) in float32.

    Token types are all 0 and positions ``arange(S)``, as the conditioner
    calls it. Post-LN layers: self-attention softmax(q k^T / sqrt(d_head) +
    bias) v, the bias 0 where ``attention_mask`` is 1 and float32's minimum
    where it is 0 (over keys; padded positions still get outputs), the
    output dense, the residual and LayerNorm; then the intermediate dense,
    the exact erf GELU, the output dense, the residual and LayerNorm.
    The parameters carry the HF key names (``bert.`` prefix stripped)."""

    def __init__(self, dims: BertDims):
        super().__init__()
        self.dims = dims
        self.embeddings = _Embeddings(dims)
        self.encoder = _Encoder(dims)

    def init_weights(self, seed: int = 0) -> "BertModel":
        """Random weights as Flax's BERT draws them: embeddings and dense
        kernels from N(0, ``initializer_range``), zero biases, LayerNorms at
        1 and 0. Drawn on the CPU from ``seed``, so a seed gives the same
        weights on every device."""
        gen = torch.Generator().manual_seed(seed)
        std = self.dims.initializer_range
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (nn.Linear, nn.Embedding)):
                    mod.weight.copy_(torch.normal(0.0, std, mod.weight.shape, generator=gen))
                    if isinstance(mod, nn.Linear):
                        mod.bias.zero_()
                elif isinstance(mod, nn.LayerNorm):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
        return self

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        dims = self.dims
        b, s = input_ids.shape
        h, d = dims.num_attention_heads, dims.hidden_size
        dh = d // h
        emb = self.embeddings
        x = (emb.word_embeddings(input_ids) + emb.token_type_embeddings.weight[0]
             + emb.position_embeddings.weight[:s])
        x = emb.LayerNorm(x)
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                           torch.finfo(torch.float32).min).to(x.dtype)

        def heads(t):
            return t.view(b, s, h, dh).transpose(1, 2)

        for layer in self.encoder.layer:
            sa = layer.attention.self
            q = heads(sa.query(x)) / math.sqrt(dh)
            probs = torch.softmax(q @ heads(sa.key(x)).transpose(-1, -2) + bias, dim=-1)
            ctx = (probs @ heads(sa.value(x))).transpose(1, 2).reshape(b, s, d)
            out = layer.attention.output
            x = out.LayerNorm(out.dense(ctx) + x)
            inner = F.gelu(layer.intermediate.dense(x))
            x = layer.output.LayerNorm(layer.output.dense(inner) + x)
        return x


def bert_params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """:class:`BertModel`'s state dict from a ``FlaxBertModel`` params tree
    (arrays as numpy): Flax kernels are (in, out) and are transposed; the
    pooler is dropped."""
    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    out: Dict[str, torch.Tensor] = {}

    def norm(key, p):
        out[f"{key}.weight"], out[f"{key}.bias"] = t(p["scale"]), t(p["bias"])

    def dense(key, p):
        out[f"{key}.weight"], out[f"{key}.bias"] = t(p["kernel"]).T.contiguous(), t(p["bias"])

    emb = params["embeddings"]
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        out[f"embeddings.{name}.weight"] = t(emb[name]["embedding"])
    norm("embeddings.LayerNorm", emb["LayerNorm"])
    for i, layer in params["encoder"]["layer"].items():
        pre, att = f"encoder.layer.{int(i)}", layer["attention"]
        for name in ("query", "key", "value"):
            dense(f"{pre}.attention.self.{name}", att["self"][name])
        dense(f"{pre}.attention.output.dense", att["output"]["dense"])
        norm(f"{pre}.attention.output.LayerNorm", att["output"]["LayerNorm"])
        dense(f"{pre}.intermediate.dense", layer["intermediate"]["dense"])
        dense(f"{pre}.output.dense", layer["output"]["dense"])
        norm(f"{pre}.output.LayerNorm", layer["output"]["LayerNorm"])
    return out


def bert_state_from_hf(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """:class:`BertModel`'s state dict from a HF PyTorch BERT state dict
    (``pytorch_model.bin`` as ``torch.load`` reads it): the ``bert.``
    prefix stripped, the old ``LayerNorm.gamma``/``beta`` names renamed,
    the pooler, the pre-training heads and ``position_ids`` dropped."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        key = key[len("bert."):] if key.startswith("bert.") else key
        if not key.startswith(("embeddings.", "encoder.")) or key.endswith("position_ids"):
            continue
        key = key.replace("LayerNorm.gamma", "LayerNorm.weight").replace("LayerNorm.beta",
                                                                         "LayerNorm.bias")
        out[key] = value.float()
    return out


class TextConditioner:
    """Interface: a list of strings -> (B, S, D) float32 embeddings on the
    conditioner's device."""

    dim: int

    def encode(self, texts: Sequence[str]) -> torch.Tensor:
        raise NotImplementedError

    def encode_multi(self, all_texts: Sequence[Sequence[str]]) -> torch.Tensor:
        """(n_langs lists of B strings) -> (n_langs, B, S, D), zero-padded to
        the longest language's S."""
        encoded = [self.encode(list(texts)) for texts in all_texts]
        s_max = max(e.shape[1] for e in encoded)
        out = encoded[0].new_zeros((len(encoded), encoded[0].shape[0], s_max, self.dim))
        for i, e in enumerate(encoded):
            out[i, :, : e.shape[1]] = e
        return out


class HFBertConditioner(TextConditioner):
    """BERT over raw strings on ``device`` (the card unless named).

    ``model_name`` is the reference's ``cfg.bert_encoder``
    (``bert-base-chinese`` / ``bert-base-multilingual-cased``) or a local
    directory. ``pretrained=True`` loads its ``config.json``,
    ``pytorch_model.bin`` and tokenizer (``transformers.AutoTokenizer``,
    imported here) from that directory or the local HF cache, and raises if
    any is missing. ``pretrained=False`` draws random weights from ``seed``:
    over the cached config and tokenizer when HF has them locally, else a
    small BERT (vocab 1024, width ``hidden_size`` or 96, 2 layers, 2 heads,
    intermediate 256, ``max_length`` positions) over :class:`_ByteTokenizer`.

    Each batch is padded to a multiple of ``pad_multiple`` tokens, at most
    ``max_length``: that sets the S of the (B, S, D) stream the gated
    cross-attention reads. BERT computes in float32; ``dtype`` is accepted
    for the JAX signature and not used, as there."""

    def __init__(
        self,
        model_name: str = "bert-base-multilingual-cased",
        max_length: int = 512,
        pad_multiple: int = 16,
        pretrained: bool = True,
        dtype=None,
        hidden_size: int = 0,
        device: Device = None,
        seed: int = 0,
    ):
        self.max_length = max_length
        self.pad_multiple = pad_multiple
        self.device = resolve_device(device)
        local = _local_dir(model_name)
        if pretrained:
            if local is None:
                raise FileNotFoundError(
                    f"no local copy of {model_name!r} (a directory, or the HF cache, holding "
                    "config.json and pytorch_model.bin); nothing is downloaded")
            weights = os.path.join(local, "pytorch_model.bin")
            if not os.path.isfile(weights):
                raise FileNotFoundError(f"{local} has no pytorch_model.bin")
            dims = BertDims.from_config_json(os.path.join(local, "config.json"))
            self.tokenizer = _hf_tokenizer(local)
            model = BertModel(dims)
            model.load_state_dict(bert_state_from_hf(
                torch.load(weights, map_location="cpu", weights_only=True)))
        else:
            dims = None
            if local is not None:  # the cached config and tokenizer, random weights
                try:
                    self.tokenizer = _hf_tokenizer(local)
                    dims = BertDims.from_config_json(os.path.join(local, "config.json"))
                except (ImportError, OSError, ValueError):
                    dims = None
            if dims is None:
                dims = BertDims(vocab_size=1024, hidden_size=hidden_size or 96,
                                num_hidden_layers=2, num_attention_heads=2,
                                intermediate_size=256, max_position_embeddings=max_length)
                self.tokenizer = _ByteTokenizer(dims.vocab_size)
            model = BertModel(dims).init_weights(seed)
        self.model = model.to(self.device).eval()
        self.dim = dims.hidden_size

    def tokenize(self, texts: Sequence[str]):
        """(input_ids, attention_mask) as int64 numpy arrays, padded to the
        bucketed length."""
        enc = self.tokenizer(list(texts), padding=True, truncation=True,
                             max_length=self.max_length, return_tensors="np")
        ids = np.asarray(enc["input_ids"], np.int64)
        mask = np.asarray(enc["attention_mask"], np.int64)
        target = min(-(-ids.shape[1] // self.pad_multiple) * self.pad_multiple, self.max_length)
        if ids.shape[1] < target:
            pad = ((0, 0), (0, target - ids.shape[1]))
            ids, mask = np.pad(ids, pad), np.pad(mask, pad)
        return ids, mask

    @torch.no_grad()
    def encode(self, texts: Sequence[str]) -> torch.Tensor:
        with profiling.span("conditioner.tokenize"):
            ids, mask = self.tokenize(texts)
        with profiling.span("conditioner.bert"):
            return self.model(torch.from_numpy(ids).to(self.device),
                              torch.from_numpy(mask).to(self.device))


class PrecomputedConditioner(TextConditioner):
    """Lookup of precomputed (S, D) embeddings keyed by :meth:`key` of their
    text; a batch is zero-padded to its longest entry, cut at
    ``max_length``."""

    def __init__(self, store: Dict[str, np.ndarray], dim: int, max_length: int = 512,
                 device: Device = None):
        self.store = store
        self.dim = dim
        self.max_length = max_length
        self.device = resolve_device(device)

    @staticmethod
    def key(text: str) -> str:
        return hashlib.sha1(text.encode("utf-8")).hexdigest()

    def encode(self, texts: Sequence[str]) -> torch.Tensor:
        embs = [self.store[self.key(t)] for t in texts]
        s_max = min(max(e.shape[0] for e in embs), self.max_length)
        out = np.zeros((len(embs), s_max, self.dim), np.float32)
        for i, e in enumerate(embs):
            s = min(e.shape[0], s_max)
            out[i, :s] = e[:s]
        return torch.from_numpy(out).to(self.device)


class _ByteTokenizer:
    """Minimal offline tokenizer (UTF-8 bytes -> ids) for random-init runs:
    [1] + bytes + [2], cut to ``max_length``, zero-padded."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def __call__(self, texts, padding=True, truncation=True, max_length=512,
                 return_tensors="np"):
        rows = [
            [1] + [2 + (b % (self.vocab_size - 3)) for b in t.encode("utf-8")][: max_length - 2]
            + [2]
            for t in texts
        ]
        n = max(len(r) for r in rows)
        ids = np.zeros((len(rows), n), np.int32)
        mask = np.zeros((len(rows), n), np.int32)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def _local_dir(model_name: str) -> Optional[str]:
    """The directory holding ``model_name``'s ``config.json``: the name
    itself when it is such a directory, else its snapshot in the local HF
    hub cache (``HF_HUB_CACHE``, or ``hub`` under ``HF_HOME`` or
    ``~/.cache/huggingface``); ``None`` when there is none."""
    if os.path.isfile(os.path.join(model_name, "config.json")):
        return model_name
    home = os.environ.get("HF_HOME") or os.path.join(os.path.expanduser("~"), ".cache",
                                                     "huggingface")
    repo = os.path.join(os.environ.get("HF_HUB_CACHE") or os.path.join(home, "hub"),
                        "models--" + model_name.replace("/", "--"))
    snapshots = []
    ref = os.path.join(repo, "refs", "main")
    if os.path.isfile(ref):
        with open(ref) as f:
            snapshots.append(os.path.join(repo, "snapshots", f.read().strip()))
    snapshots += sorted(glob.glob(os.path.join(repo, "snapshots", "*")))
    return next((s for s in snapshots if os.path.isfile(os.path.join(s, "config.json"))), None)


def _hf_tokenizer(local: str):
    """``transformers.AutoTokenizer`` of a local directory (no network)."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(f"the tokenizer of {local} needs the transformers package") from e
    return AutoTokenizer.from_pretrained(local, local_files_only=True)
