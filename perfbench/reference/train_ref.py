"""Plain float32 fine-tuning steps: teacher-forced cross-entropy through
:mod:`whisper_ref`, autograd, and AdamW written out.

- loss: the mean, over the label positions that are not -100, of the
  negative log-softmax of the label's logit;
- AdamW (optax's order): m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
  u = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps), plus ``weight_decay``
  x p on every weight but biases and LayerNorm parameters, then
  p -= lr_t u, with lr_t the linear warm-up's value at the count of updates
  already applied (0 at the first);
- the SpecAugment masks: zero fill of the draws' frequency bands (on the
  clip's real frames) and time spans, as given.

``lowp="fp8"`` (the control) runs every weight product on fp8-rounded
operands in the forward, with the rounding passed straight through in the
backward.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import whisper_ref

NORM_NAMES = ("attn_ln", "cross_attn_ln", "mlp_ln", "ln_post", "ln", "ff_ln")


def decays(name: str) -> bool:
    """Weight decay applies to every weight but biases and LayerNorms."""
    parts = name.split(".")
    return not (parts[-1] == "bias" or parts[-2] in NORM_NAMES)


def warmup_lr(lr: float, warmup: int, total: int, count: int) -> float:
    if count < warmup:
        return lr * count / max(warmup, 1)
    return lr * (1.0 - min(count - warmup, total - warmup) / max(total - warmup, 1))


def spec_augment(mel: torch.Tensor, frames: torch.Tensor, draws: torch.Tensor,
                 n_freq_mask: int) -> torch.Tensor:
    """mel (B, n_mels, T); ``draws`` (B, masks, 3) of (w, width, start)."""
    out = mel.clone()
    for b in range(mel.shape[0]):
        for i in range(draws.shape[1]):
            w, width, start = (int(v) for v in draws[b, i])
            if w <= 0:
                continue
            if i < n_freq_mask:
                out[b, start: start + width, : int(frames[b])] = 0.0
            elif int(frames[b]) - w > 0:
                out[b, :, start: start + width] = 0.0
    return out


def ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    mask = labels != -100
    nll = -torch.log_softmax(logits, dim=-1).gather(
        -1, torch.where(mask, labels, 0)[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1)


def train_steps(sd: Dict[str, torch.Tensor], dims: Dict[str, int], batches: List[dict],
                train: dict, lowp: Optional[str] = None) -> dict:
    """Run ``len(batches)`` AdamW steps from ``sd`` (fp32, left as it is).
    Returns each step's loss and, by parameter name, the norm of the first
    step's gradient, the parameters' change over all the steps (``delta``)
    and its norm."""
    params = {n: t.detach().clone().requires_grad_(True) for n, t in sd.items()}
    m = {n: torch.zeros_like(t) for n, t in sd.items()}
    v = {n: torch.zeros_like(t) for n, t in sd.items()}
    b1, b2, eps = 0.9, 0.999, float(train["adam_epsilon"])
    losses, first_grad = [], None
    for t, batch in enumerate(batches, start=1):
        mel = spec_augment(batch["mel"], batch["frames"], batch["draws"],
                           batch["n_freq_mask"])
        feats = whisper_ref.encoder(params, dims, mel, lowp)
        logits = whisper_ref.decoder_logits(params, dims, batch["dec_input_ids"], feats,
                                            lowp=lowp)
        loss = ce_loss(logits, batch["labels"])
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = {n: float(g.double().norm()) for n, g in zip(params, grads)}
        lr = warmup_lr(float(train["learning_rate"]), int(train["warmup_steps"]),
                       int(train["num_train_steps"]), t - 1)
        with torch.no_grad():
            for (n, p), g in zip(params.items(), grads):
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (m[n] / (1 - b1 ** t)) / ((v[n] / (1 - b2 ** t)).sqrt() + eps)
                if decays(n):
                    u = u + float(train["weight_decay"]) * p
                p.sub_(lr * u)
        del grads, logits, feats, loss
    del m, v
    delta = {n: p.detach() - sd[n] for n, p in params.items()}
    del params
    change = {n: float(d.double().norm()) for n, d in delta.items()}
    return {"losses": losses, "first_grad": first_grad, "change": change, "delta": delta}
