"""Command-line transcription: ``python -m whisper_flamingo_tpu_torch <wav>``.

Port of ``whisper_flamingo_tpu/cli.py``, with the same flags and these
differences:

- ``--device`` (default ``cuda``) is honoured: the model, the mel, the
  decode and the word timing run there; ``--device cpu`` runs on the CPU;
- ``--fp16 True`` selects bfloat16 compute on the card;
- ``--threads`` sets torch's CPU threads, as the reference CLI does;
- ``--model`` (and ``--draft_model``) also take ``debug``, the small
  random model of the tests.

``--quantize int8`` / ``int8kv`` selects the int8 serving modes;
``--draft_model`` (with ``--draft_len``) decodes the greedy rung
speculatively.

A file that fails to transcribe is reported and skipped, as in the JAX
package.
"""

from __future__ import annotations

import argparse
import os
import traceback
import warnings

from .tokenizer import LANGUAGES, TO_LANGUAGE_CODE
from .utils import optional_float, optional_int, optional_str, str2bool
from .writers import get_writer


def cli():
    import torch

    from . import MODEL_DIMS, available_models, load_model, transcribe

    def valid_model_name(name):
        if name in MODEL_DIMS or os.path.exists(name):
            return name
        raise ValueError(
            f"model should be one of {available_models} or path to a model checkpoint"
        )

    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    parser.add_argument("audio", nargs="+", type=str, help="audio file(s) to transcribe")
    parser.add_argument("--model", default="small", type=valid_model_name)
    parser.add_argument("--model_dir", type=str, default=None,
                        help="directory holding <model>.pt; random weights when absent")
    parser.add_argument("--device", type=str, default="cuda",
                        help="device to run on (cuda, or cpu)")
    parser.add_argument("--output_dir", "-o", type=str, default=".")
    parser.add_argument("--output_format", "-f", type=str, default="all",
                        choices=["txt", "vtt", "srt", "tsv", "json", "all"])
    parser.add_argument("--verbose", type=str2bool, default=True)
    parser.add_argument("--task", type=str, default="transcribe",
                        choices=["transcribe", "translate"])
    parser.add_argument("--language", type=str, default=None,
                        choices=sorted(LANGUAGES.keys())
                        + sorted([k.title() for k in TO_LANGUAGE_CODE.keys()]))
    parser.add_argument("--temperature", type=float, default=0)
    parser.add_argument("--best_of", type=optional_int, default=5)
    parser.add_argument("--beam_size", type=optional_int, default=5)
    parser.add_argument("--patience", type=optional_float, default=None)
    parser.add_argument("--length_penalty", type=optional_float, default=None)
    parser.add_argument("--suppress_tokens", type=str, default="-1")
    parser.add_argument("--initial_prompt", type=str, default=None)
    parser.add_argument("--condition_on_previous_text", type=str2bool, default=True)
    parser.add_argument("--fp16", type=str2bool, default=True,
                        help="bfloat16 compute on the card")
    parser.add_argument("--temperature_increment_on_fallback", type=optional_float, default=0.2)
    parser.add_argument("--compression_ratio_threshold", type=optional_float, default=2.4)
    parser.add_argument("--logprob_threshold", type=optional_float, default=-1.0)
    parser.add_argument("--no_speech_threshold", type=optional_float, default=0.6)
    parser.add_argument("--word_timestamps", type=str2bool, default=False)
    parser.add_argument("--prepend_punctuations", type=str, default="\"'“¿([{-")
    parser.add_argument("--append_punctuations", type=str, default="\"'.。,，!！?？:：”)]}、")
    parser.add_argument("--highlight_words", type=str2bool, default=False)
    parser.add_argument("--max_line_width", type=optional_int, default=None)
    parser.add_argument("--max_line_count", type=optional_int, default=None)
    parser.add_argument("--max_words_per_line", type=optional_int, default=None)
    parser.add_argument("--quantize", type=optional_str, default=None,
                        choices=(None, "int8", "int8kv"),
                        help="store the decode-loop weights and K/V slabs int8; int8kv also "
                             "the decode self cache (the beam-mode variant)")
    parser.add_argument("--draft_model", type=optional_str, default=None,
                        help="draft model name or path for speculative greedy decoding "
                             "(e.g. tiny)")
    parser.add_argument("--draft_len", type=int, default=4,
                        help="tokens drafted per speculative round")
    parser.add_argument("--threads", type=int, default=0,
                        help="torch CPU threads (0: torch's default)")

    args = parser.parse_args().__dict__
    if (threads := args.pop("threads")) > 0:
        torch.set_num_threads(threads)
    device: str = args.pop("device")
    model_name: str = args.pop("model")
    model_dir: str = args.pop("model_dir")
    output_dir: str = args.pop("output_dir")
    output_format: str = args.pop("output_format")
    os.makedirs(output_dir, exist_ok=True)

    if model_name.endswith(".en") and args["language"] not in {"en", "English"}:
        if args["language"] is not None:
            warnings.warn(
                f"{model_name} is an English-only model but received "
                f"'{args['language']}'; using English instead."
            )
        args["language"] = "en"

    temperature = args.pop("temperature")
    if (increment := args.pop("temperature_increment_on_fallback")) is not None:
        temperature = tuple(float(t) for t in _arange(temperature, 1.0 + 1e-6, increment))
    else:
        temperature = [temperature]

    model = load_model(model_name, device=device, download_root=model_dir)
    if (draft_name := args.pop("draft_model")) is not None:
        args["draft_model"] = load_model(draft_name, device=device, download_root=model_dir)
    else:
        args.pop("draft_len")

    writer = get_writer(output_format, output_dir)
    word_options = ["highlight_words", "max_line_count", "max_line_width",
                    "max_words_per_line"]
    if not args["word_timestamps"]:
        for option in word_options:
            if args[option]:
                parser.error(f"--{option} requires --word_timestamps True")
    writer_args = {arg: args.pop(arg) for arg in word_options}

    for audio_path in args.pop("audio"):
        try:
            result = transcribe(model, audio_path, temperature=temperature, **args)
            writer(result, audio_path, writer_args)
        except Exception as e:
            traceback.print_exc()
            print(f"Skipping {audio_path} due to {type(e).__name__}: {str(e)}")


def _arange(start, stop, step):
    out = []
    x = start
    while x < stop:
        out.append(x)
        x += step
    return out


if __name__ == "__main__":
    cli()
