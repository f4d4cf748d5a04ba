"""Long-form transcription: a 30-second window slides over the log-mel
spectrogram, with the temperature-ladder fallback, prompt chaining and
optional word timestamps.

Port of ``whisper_flamingo_tpu/transcribe.py``. The seek / fallback /
prompt state machine (timestamp-pair slicing, seek advance, prompt resets,
the guard against a seek that does not move) follows the JAX package
statement for statement: those rules are the output spec. The mel is
computed once on the model's device and each window is decoded there by
:func:`.decoding.decode`; word timing runs :mod:`.timing` on the same
window.

With ``draft_model`` the greedy rung of the temperature ladder (t = 0, no
beam) decodes speculatively (:func:`.speculative.decode_speculative`,
token-identical); the sampling rungs decode plainly.

Each window's options set ``bucket_prompt_lengths`` as JAX's do: the
chained prompt keeps its newest power-of-two count of tokens. Left out:
the compile budget (a TPU workaround).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Tuple, Union

import numpy as np

from .audio import (
    FRAMES_PER_SECOND,
    HOP_LENGTH,
    N_FRAMES,
    N_SAMPLES,
    SAMPLE_RATE,
    log_mel_spectrogram,
    pad_or_trim,
)
from .decoding import DecodingOptions, DecodingResult, decode
from .timing import add_word_timestamps
from .tokenizer import LANGUAGES, get_tokenizer
from .utils import exact_div, format_timestamp, make_safe

if TYPE_CHECKING:
    from .models.whisper import Whisper


def transcribe(
    model: "Whisper",
    audio: Union[str, np.ndarray],
    *,
    verbose: Optional[bool] = None,
    temperature: Union[float, Tuple[float, ...]] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    compression_ratio_threshold: Optional[float] = 2.4,
    logprob_threshold: Optional[float] = -1.0,
    no_speech_threshold: Optional[float] = 0.6,
    condition_on_previous_text: bool = True,
    initial_prompt: Optional[str] = None,
    word_timestamps: bool = False,
    prepend_punctuations: str = "\"'“¿([{-",
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
    draft_model: Optional["Whisper"] = None,
    draft_len: int = 4,
    **decode_options,
):
    """Transcribe audio of any length on the model's device; ``draft_model``
    (with ``draft_len`` tokens per round) speculates the greedy rung.

    Returns ``dict(text=..., segments=[...], language=...)`` with the JAX
    package's segment fields (and ``words`` per segment with
    ``word_timestamps``)."""
    # pad 30 seconds of silence to the input audio, for slicing
    mel = log_mel_spectrogram(audio, model.dims.n_mels, padding=N_SAMPLES, device=model.device)
    content_frames = mel.shape[-1] - N_FRAMES

    if decode_options.get("language", None) is None:
        if not model.is_multilingual:
            decode_options["language"] = "en"
        else:
            if verbose:
                print(
                    "Detecting language using up to the first 30 seconds. "
                    "Use `language=` to specify the language"
                )
            mel_segment = pad_or_trim(mel, N_FRAMES)
            _, probs = model.detect_language(mel_segment)
            decode_options["language"] = max(probs, key=probs.get)
            if verbose is not None:
                print(f"Detected language: {LANGUAGES[decode_options['language']].title()}")

    language: str = decode_options["language"]
    task: str = decode_options.get("task", "transcribe")
    tokenizer = get_tokenizer(
        model.is_multilingual,
        num_languages=model.num_languages,
        language=language,
        task=task,
    )

    def decode_with_fallback(segment) -> DecodingResult:
        temperatures = (
            [temperature] if isinstance(temperature, (int, float)) else temperature
        )
        decode_result = None
        for t in temperatures:
            kwargs = {**decode_options}
            if t > 0:
                kwargs.pop("beam_size", None)
                kwargs.pop("patience", None)
            else:
                kwargs.pop("best_of", None)

            options = DecodingOptions(**kwargs, temperature=t, bucket_prompt_lengths=True)
            if draft_model is not None and t == 0 and kwargs.get("beam_size") is None:
                # speculation's argmax guarantee needs t = 0
                from .speculative import decode_speculative

                decode_result = decode_speculative(model, draft_model, segment, options,
                                                   draft_len)
            else:
                decode_result = decode(model, segment, options)

            needs_fallback = False
            if (
                compression_ratio_threshold is not None
                and decode_result.compression_ratio > compression_ratio_threshold
            ):
                needs_fallback = True  # too repetitive
            if (
                logprob_threshold is not None
                and decode_result.avg_logprob < logprob_threshold
            ):
                needs_fallback = True  # average log probability is too low
            if (
                no_speech_threshold is not None
                and decode_result.no_speech_prob > no_speech_threshold
            ):
                needs_fallback = False  # silence
            if not needs_fallback:
                break
        return decode_result

    seek = 0
    input_stride = exact_div(N_FRAMES, model.dims.n_audio_ctx)  # 2 mel frames/token
    time_precision = input_stride * HOP_LENGTH / SAMPLE_RATE  # 0.02 s/token
    all_tokens: list = []
    all_segments: list = []
    prompt_reset_since = 0

    if initial_prompt is not None:
        initial_prompt_tokens = tokenizer.encode(" " + initial_prompt.strip())
        all_tokens.extend(initial_prompt_tokens)
    else:
        initial_prompt_tokens = []

    def new_segment(*, start: float, end: float, tokens: np.ndarray, result: DecodingResult):
        tokens = [int(t) for t in tokens]
        text_tokens = [token for token in tokens if token < tokenizer.eot]
        return {
            "seek": seek,
            "start": start,
            "end": end,
            "text": tokenizer.decode(text_tokens),
            "tokens": tokens,
            "temperature": result.temperature,
            "avg_logprob": result.avg_logprob,
            "compression_ratio": result.compression_ratio,
            "no_speech_prob": result.no_speech_prob,
        }

    last_speech_timestamp = 0.0
    prev_loop_seek = -1
    while seek < content_frames:
        if seek == prev_loop_seek:
            # a degenerate <|0.00|><|0.00|> pair would otherwise freeze the
            # seek pointer: skip the window instead of looping forever
            seek += N_FRAMES
            continue
        prev_loop_seek = seek
        time_offset = float(seek * HOP_LENGTH / SAMPLE_RATE)
        mel_segment = mel[:, seek : seek + N_FRAMES]
        segment_size = min(N_FRAMES, content_frames - seek)
        segment_duration = segment_size * HOP_LENGTH / SAMPLE_RATE
        mel_segment = pad_or_trim(mel_segment, N_FRAMES)

        decode_options["prompt"] = all_tokens[prompt_reset_since:]
        result = decode_with_fallback(mel_segment)
        tokens = np.asarray(result.tokens)

        if no_speech_threshold is not None:
            should_skip = result.no_speech_prob > no_speech_threshold
            if logprob_threshold is not None and result.avg_logprob > logprob_threshold:
                # don't skip despite no_speech_prob if logprob is high enough
                should_skip = False
            if should_skip:
                seek += segment_size
                continue

        previous_seek = seek
        current_segments = []

        timestamp_tokens = tokens >= tokenizer.timestamp_begin
        single_timestamp_ending = (
            len(tokens) >= 2
            and timestamp_tokens[-2:].tolist() == [False, True]
        )

        consecutive = np.where(timestamp_tokens[:-1] & timestamp_tokens[1:])[0] + 1
        if len(consecutive) > 0:
            # the output contains two consecutive timestamp tokens
            slices = consecutive.tolist()
            if single_timestamp_ending:
                slices.append(len(tokens))
            last_slice = 0
            for current_slice in slices:
                sliced_tokens = tokens[last_slice:current_slice]
                start_timestamp_pos = int(sliced_tokens[0]) - tokenizer.timestamp_begin
                end_timestamp_pos = int(sliced_tokens[-1]) - tokenizer.timestamp_begin
                current_segments.append(
                    new_segment(
                        start=time_offset + start_timestamp_pos * time_precision,
                        end=time_offset + end_timestamp_pos * time_precision,
                        tokens=sliced_tokens,
                        result=result,
                    )
                )
                last_slice = current_slice
            if single_timestamp_ending:
                # no speech after the last timestamp
                seek += segment_size
            else:
                # ignore the unfinished segment; seek to the last timestamp
                last_timestamp_pos = int(tokens[last_slice - 1]) - tokenizer.timestamp_begin
                seek += last_timestamp_pos * input_stride
        else:
            duration = segment_duration
            timestamps = tokens[timestamp_tokens]
            if len(timestamps) > 0 and int(timestamps[-1]) != tokenizer.timestamp_begin:
                last_timestamp_pos = int(timestamps[-1]) - tokenizer.timestamp_begin
                duration = last_timestamp_pos * time_precision
            current_segments.append(
                new_segment(
                    start=time_offset,
                    end=time_offset + duration,
                    tokens=tokens,
                    result=result,
                )
            )
            seek += segment_size

        if word_timestamps:
            add_word_timestamps(
                segments=current_segments,
                model=model,
                tokenizer=tokenizer,
                mel=mel_segment,
                num_frames=segment_size,
                prepend_punctuations=prepend_punctuations,
                append_punctuations=append_punctuations,
                last_speech_timestamp=last_speech_timestamp,
            )
            word_end_timestamps = [w["end"] for s in current_segments for w in s["words"]]
            if len(word_end_timestamps) > 0:
                last_speech_timestamp = word_end_timestamps[-1]
            if not single_timestamp_ending and len(word_end_timestamps) > 0:
                seek_shift = round(
                    (word_end_timestamps[-1] - time_offset) * FRAMES_PER_SECOND
                )
                if seek_shift > 0:
                    seek = previous_seek + seek_shift

        if verbose:
            for segment in current_segments:
                start, end, text = segment["start"], segment["end"], segment["text"]
                print(make_safe(f"[{format_timestamp(start)} --> {format_timestamp(end)}] {text}"))

        # if a segment is instantaneous or does not contain text, clear it
        for segment in current_segments:
            if segment["start"] == segment["end"] or segment["text"].strip() == "":
                segment["text"] = ""
                segment["tokens"] = []
                segment["words"] = []

        all_segments.extend(
            {"id": i, **segment}
            for i, segment in enumerate(current_segments, start=len(all_segments))
        )
        all_tokens.extend(
            token for segment in current_segments for token in segment["tokens"]
        )

        if not condition_on_previous_text or result.temperature > 0.5:
            # don't feed prompt tokens if a high temperature was used
            prompt_reset_since = len(all_tokens)

    return dict(
        text=tokenizer.decode(all_tokens[len(initial_prompt_tokens):]),
        segments=all_segments,
        language=language,
    )
