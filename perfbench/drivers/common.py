"""What the drivers share: the program's models built on the benchmark's
weights, seeded inputs, and the reference's view of a configuration."""

from __future__ import annotations

import string
from typing import Dict, List, Sequence

import numpy as np
import torch

from .. import weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
WHISPER_SALT, BERT_SALT = 0, 1


def whisper_state(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    spec = weights.whisper_spec(cfg["dims"], cfg["extras"], cfg.get("gate_value", 0.0))
    return weights.make_state(spec, seed, device, WHISPER_SALT)


def bert_state(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return weights.make_state(weights.bert_spec(cfg["bert"]), seed, device, BERT_SALT)


def build_whisper(cfg: dict, seed: int, device):
    """The port's ``Whisper`` holding the benchmark's weights (fp32 masters)."""
    from whisper_flamingo_tpu_torch.models.dims import ModelDimensions
    from whisper_flamingo_tpu_torch.models.whisper import ModelExtras, Whisper

    dims = ModelDimensions(**cfg["dims"])
    extras = ModelExtras(**cfg["extras"])
    with torch.device(device):
        model = Whisper(dims, extras).to(device)
    state = whisper_state(cfg, seed, device)
    model.load_state_dict(state, strict=True)
    del state
    return model.eval()


def build_conditioner(cfg: dict, seed: int, device):
    """The port's ``HFBertConditioner`` over a BERT of the configuration's
    widths (the benchmark's weights) and the offline byte tokenizer."""
    from whisper_flamingo_tpu_torch.models import bert

    dims = bert.BertDims(**cfg["bert"])
    cond = bert.HFBertConditioner(pretrained=False, device=device,
                                  max_length=cfg["bert_max_length"],
                                  pad_multiple=cfg["bert_pad_multiple"])
    with torch.device(device):
        model = bert.BertModel(dims).to(device)
    state = bert_state(cfg, seed, device)
    model.load_state_dict(state, strict=True)
    del state
    cond.model = model.eval()
    cond.tokenizer = bert._ByteTokenizer(dims.vocab_size)
    cond.dim = dims.hidden_size
    return cond


def texts_of_lengths(rng: np.random.Generator, token_lengths: Sequence[int]) -> List[str]:
    """Printable ASCII strings whose byte tokenization is ``token_lengths``
    long (one byte a token, plus the two markers)."""
    alphabet = np.frombuffer((string.ascii_letters + string.digits + " .,").encode(), np.uint8)
    return [bytes(rng.choice(alphabet, size=n - 2)).decode() for n in token_lengths]


def stratified(lo: int, hi: int, n: int) -> List[int]:
    """``n`` lengths spread evenly over [lo, hi], both ends included."""
    return [int(round(lo + (hi - lo) * i / (n - 1))) for i in range(n)] if n > 1 else [hi]


def audio_batch(gen: torch.Generator, rows: int, samples: int, std: float, device) -> torch.Tensor:
    return torch.randn((rows, samples), generator=gen, device=device) * std


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
