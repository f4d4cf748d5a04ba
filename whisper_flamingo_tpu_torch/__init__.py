"""whisper_flamingo_tpu_torch: the PyTorch / CUDA port of whisper_flamingo_tpu.

On an NVIDIA H100 (Hopper): the batched 30 s decode path (the log-mel
frontend, the Whisper encoder and decoder with Flamingo gated
cross-attention, KV-cached greedy / sampling / beam decoding, the
tokenizer) and long-form transcription (``transcribe``: the sliding
window with the temperature fallback and prompt chaining, word
timestamps by cross-attention DTW, the subtitle writers, the CLI
``python -m whisper_flamingo_tpu_torch``), with the text normalizers and
error-rate metrics, and audio-only Whisper fine-tuning (``config``,
``data/``, ``training/``, ``profiling``, ``recipes/``), and serving: the
int8 / int8kv modes (``DecodingOptions(quantize=...)``), speculative
decoding (``speculative``, ``transcribe(draft_model=...)``) and the
``serving`` module's ``BatchTranscriber`` and ``ContinuousBatcher``; the
text conditioner (``models/bert``) and the text recipes; the audio-visual
path (``models/visual``, the lip-video ResNet; ``models/avhubert``, the
AV-HuBERT trunk and ``AVWhisper``; the AV train step and the ``av_train``
and ``decode_av`` recipes) and the legacy modules (``models/legacy``). The
kernels of those paths (encoder attention forward and backward, decode
attention, the decode MLP, the DTW wavefront) are CUDA C++ for ``sm_90a``
under ``csrc/``, built with ``nvcc`` at first use.

Entry points run on the card unless the caller passes ``device="cpu"``;
with no card and no device named they raise. Fine-tuning runs as

    python -m whisper_flamingo_tpu_torch.recipes.whisper_ft <config.yaml> [key=value ...]

on the card unless the config or an override says ``device=cpu``
(``configs/smoke/ft.yaml device=cpu`` trains the debug dims on the CPU);
``python3 chip_smoke.py`` drives it on the card. The package imports
torch, numpy, tiktoken, regex and yaml, never JAX or the JAX package.

Data and tensor parallelism (``parallel/``: the rank bootstrap, the
(data, model) mesh with the Megatron layout, the model's collectives, the
multi-rank dry run) runs every training recipe and ``DecodingTask`` on a
mesh of processes launched by ``torchrun``.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Union

import torch

from .audio import load_audio, log_mel_spectrogram, pad_or_trim  # noqa: F401
from .decoding import DecodingOptions, DecodingResult, DecodingTask, decode, detect_language  # noqa: F401
from .models.dims import MODEL_DIMS, ModelDimensions, available_models  # noqa: F401
from .models.whisper import ModelExtras, Whisper, init_params  # noqa: F401
from .serving import BatchTranscriber, ContinuousBatcher  # noqa: F401
from .speculative import SpeculativeDecodingTask, decode_speculative  # noqa: F401
from .transcribe import transcribe
from .utils import resolve_device

__version__ = "0.1.0"


def load_model(
    name: str,
    device: Optional[Union[str, torch.device]] = None,
    download_root: Optional[str] = None,
    in_memory: bool = False,
    dropout_rate: float = 0.0,
    add_adapter: bool = False,
    adapter_dim: int = 256,
    add_gated_x_attn: int = 0,
    bert_dim: int = 768,
    num_langs: int = 0,
    seed: int = 0,
    dtype: Optional[torch.dtype] = None,
) -> Whisper:
    """Build a Whisper model on ``device`` (the card unless named).

    ``name`` is a size from :data:`available_models` (or ``"debug"``),
    loaded from ``<download_root>/<name>.pt`` when that file exists and
    otherwise randomly initialized from ``seed`` with a warning (there is
    no download), or a path to an OpenAI ``.pt`` / Lightning ``.ckpt``,
    loaded with ``strict=False`` so new gated x-attn weights keep their
    initialization. ``in_memory`` is accepted for signature parity."""
    from .registry import alignment_heads_for, checkpoint_path
    from .training.checkpoints import load_torch_checkpoint

    dev = resolve_device(device)
    extras = ModelExtras(
        dropout_rate=dropout_rate, add_adapter=add_adapter, adapter_dim=adapter_dim,
        add_gated_x_attn=add_gated_x_attn, bert_dim=bert_dim, num_langs=num_langs,
    )
    alignment_heads = None
    if os.path.isfile(name):
        ckpt_path, dims = name, None
    elif name in MODEL_DIMS:
        dims = MODEL_DIMS[name]
        alignment_heads = alignment_heads_for(name, dims.n_text_layer, dims.n_text_head)
        ckpt_path = checkpoint_path(name, download_root)
        if ckpt_path is None and name != "debug":
            warnings.warn(
                f"no checkpoint for {name!r} (looked for <download_root>/{name}.pt); "
                "using random initialization"
            )
    else:
        raise RuntimeError(f"Model {name} not found; available models = {available_models}")

    if ckpt_path is not None:
        model, dims = load_torch_checkpoint(ckpt_path, dims, extras, seed=seed, device=dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = init_params(gen, dims, extras, device=dev)
    model.dtype = dtype or torch.float32
    model.alignment_heads = alignment_heads
    return model


# inference entry points on the model handle
Whisper.decode = decode
Whisper.detect_language = detect_language
Whisper.transcribe = transcribe
