"""Plain float32 training steps over chunked batches: Whisper-Flamingo's step
2 (a frozen Whisper and a frozen AV-HuBERT trunk, the gated layers learn) and
a data-parallel step's global batch.

A step's batch comes as chunks: the ranks' batches of a data-parallel step
(each padded to its own longest clip, as each rank's collator pads it), or
blocks of rows of one batch (which change nothing: no row reads another).
The step's loss is the masked negative log-likelihood summed over every
chunk over the label positions (not -100) of every chunk; its gradient is
accumulated chunk by chunk.

- with ``trunk`` (the AV step): the trunk (:mod:`avhubert_ref`) over the
  chunk's padded video and the Whisper encoder (:mod:`whisper_ref`) over its
  SpecAugmented mel run without gradients; the chunk's ``mode`` is the
  step's modality draw: ``both``, ``audio`` (the video features zeroed) or
  ``video`` (the encoder features zeroed); the video features go through
  ``xt_projection`` and the decoder's positions into the gated blocks;
- without: the encoder is differentiated too (full fine-tuning);
- AdamW as in :mod:`train_ref` over the ``trainable`` parameters only,
  weight decay where ``decay(name)`` says; every other parameter is read
  and never written.

TF32 is off for the whole step. ``lowp="fp8"`` is the control, as in
:mod:`whisper_ref` and :mod:`avhubert_ref`.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

import torch

from . import avhubert_ref, train_ref, whisper_ref

MODES = ("both", "audio", "video")


def flamingo_trainable(name: str) -> bool:
    """The gated layers of Whisper-Flamingo's step 2: each decoder block's
    gated cross-attention, its LayerNorm and tanh gate, and the gated FFN."""
    parts = name.split(".")
    return (len(parts) > 3 and parts[:2] == ["decoder", "blocks"]
            and parts[3] in ("gated_x_attn_layers", "ff_ln", "ff", "ff_gate"))


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _nll_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    mask = labels != -100
    nll = -torch.log_softmax(logits, dim=-1).gather(
        -1, torch.where(mask, labels, 0)[..., None])[..., 0]
    return (nll * mask).sum()


def _logits(params, dims, chunk, trunk, lowp) -> torch.Tensor:
    mel = train_ref.spec_augment(chunk["mel"], chunk["frames"], chunk["draws"],
                                 chunk["n_freq_mask"])
    if trunk is None:
        feats = whisper_ref.encoder(params, dims, mel, lowp)
        return whisper_ref.decoder_logits(params, dims, chunk["dec_input_ids"], feats, lowp=lowp)
    tsd, tcfg = trunk
    with torch.no_grad():
        feats = whisper_ref.encoder(params, dims, mel, lowp)
        vfeats = avhubert_ref.trunk(tsd, tcfg, chunk["video"], lowp)
    if chunk["mode"] == "audio":
        vfeats = torch.zeros_like(vfeats)
    elif chunk["mode"] == "video":
        feats = torch.zeros_like(feats)
    xt = whisper_ref.prepare_streams(params, vfeats[None], lowp)
    return whisper_ref.decoder_logits(params, dims, chunk["dec_input_ids"], feats, xt, lowp)


def train_steps(sd: Dict[str, torch.Tensor], dims: Dict[str, int], steps: List[List[dict]],
                train: dict, trainable: Callable[[str], bool], decay: Callable[[str], bool],
                trunk=None, lowp: Optional[str] = None) -> dict:
    """Run ``len(steps)`` AdamW steps from ``sd`` (fp32, left as it is); each
    step a list of chunks (``mel``, ``frames``, ``draws``, ``n_freq_mask``,
    ``dec_input_ids``, ``labels``; with ``trunk`` = (trunk state, trunk
    shape) also ``video`` and ``mode``). Returns each step's loss and, by
    trainable parameter, the norm of the first step's gradient, the change
    over all the steps (``delta``) and its norm."""
    names = [n for n in sd if trainable(n)]
    params = dict(sd)
    for n in names:
        params[n] = sd[n].detach().clone().requires_grad_(True)
    m = {n: torch.zeros_like(sd[n]) for n in names}
    v = {n: torch.zeros_like(sd[n]) for n in names}
    b1, b2, eps = 0.9, 0.999, float(train["adam_epsilon"])
    losses, first_grad = [], None
    with no_tf32():
        for t, chunks in enumerate(steps, start=1):
            count = sum(int((c["labels"] != -100).sum()) for c in chunks)
            grads = [torch.zeros_like(sd[n]) for n in names]
            loss = 0.0
            for chunk in chunks:
                part = _nll_sum(_logits(params, dims, chunk, trunk, lowp), chunk["labels"])
                part = part / max(count, 1)
                for g, d in zip(grads, torch.autograd.grad(part, [params[n] for n in names])):
                    g.add_(d)
                loss += float(part.detach())
                del part
            losses.append(loss)
            if first_grad is None:
                first_grad = {n: float(g.double().norm()) for n, g in zip(names, grads)}
            lr = train_ref.warmup_lr(float(train["learning_rate"]), int(train["warmup_steps"]),
                                     int(train["num_train_steps"]), t - 1)
            with torch.no_grad():
                for n, g in zip(names, grads):
                    p = params[n]
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    u = (m[n] / (1 - b1 ** t)) / ((v[n] / (1 - b2 ** t)).sqrt() + eps)
                    if decay(n):
                        u = u + float(train["weight_decay"]) * p
                    p.sub_(lr * u)
            del grads
    del m, v
    delta = {n: params[n].detach() - sd[n] for n in names}
    del params
    change = {n: float(d.double().norm()) for n, d in delta.items()}
    return {"losses": losses, "first_grad": first_grad, "change": change, "delta": delta}
