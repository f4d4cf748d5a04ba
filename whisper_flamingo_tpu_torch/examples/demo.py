"""Whisper-Flamingo demo: the reference Colab notebook's flow as a script,
a port of the JAX package's ``examples/demo.py``.

1. load a (gated x-attn) model,
2. batch-decode 30 s segments with beam search,
3. score WER with the fairseq-style protocol (normalized text).

With no arguments it runs on synthetic audio with a randomly initialized
debug model (nothing is downloaded); ``--model`` names a size or a
checkpoint and ``--audio`` wav files for real transcription. The card is
the default device; ``--platform cpu`` (the JAX script's flag) asks for
the CPU.

    python -m whisper_flamingo_tpu_torch.examples.demo [--model small] [--beam_size 15]
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

import numpy as np
import torch

import whisper_flamingo_tpu_torch as whisper
from whisper_flamingo_tpu_torch.metrics import wer_cer
from whisper_flamingo_tpu_torch.normalizers import BasicTextNormalizer


def device_of(platform: Optional[str]) -> str:
    """``--platform cpu`` -> the CPU; anything else (or nothing) -> the card."""
    return "cpu" if platform == "cpu" else "cuda"


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="debug")
    parser.add_argument("--audio", nargs="*", default=[])
    parser.add_argument("--language", default="en")
    parser.add_argument("--beam_size", type=int, default=None)
    parser.add_argument("--platform", default=None, help="cpu for a run on the CPU")
    args = parser.parse_args(argv)
    device = device_of(args.platform)

    model = whisper.load_model(args.model, device=device)
    print(f"model={args.model} dims={model.dims.n_audio_state}x{model.dims.n_audio_layer}")

    if args.audio:
        waves = [whisper.load_audio(path) for path in args.audio]
    else:
        print("no audio given; using synthetic noise (debug demo)")
        rng = np.random.default_rng(0)
        waves = [rng.standard_normal(16000 * 5).astype(np.float32) * 0.05 for _ in range(2)]

    mels = torch.stack([
        whisper.log_mel_spectrogram(whisper.pad_or_trim(w), n_mels=model.dims.n_mels,
                                    device=device)
        for w in waves
    ])
    options = whisper.DecodingOptions(
        language=args.language,
        beam_size=args.beam_size,
        without_timestamps=True,
        sample_len=32 if args.model == "debug" else None,
        fp16=args.model != "debug",
    )
    results = whisper.decode(model, mels, options)
    normalizer = BasicTextNormalizer(remove_diacritics=True)
    rows = []
    for i, r in enumerate(results):
        print(f"[{i}] avg_logprob={r.avg_logprob:.3f}  text={r.text!r}")
        rows.append({"index": i, "avg_logprob": r.avg_logprob, "text": r.text,
                     "tokens": list(r.tokens)})

    if len(results) >= 2:
        wer, cer = wer_cer([normalizer(results[0].text)], [normalizer(results[1].text)])
        print(f"(demo metric plumbing: wer={wer:.3f} cer={cer:.3f})")
        rows.append({"wer": wer, "cer": cer})
    return rows


if __name__ == "__main__":
    main()
