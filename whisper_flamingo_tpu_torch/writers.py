"""Transcription result writers: TXT / VTT / SRT / TSV / JSON.

A copy of ``whisper_flamingo_tpu/writers.py`` (the port imports nothing of
the JAX package): the same formats, the same subtitle options
(``max_line_width`` / ``max_line_count`` / ``max_words_per_line`` /
``highlight_words``) and the same bytes. A word-layout pass groups word
timings into cue blocks (lists of word records whose text may embed the
line breaks); a caption pass renders the blocks into ``(start, end,
text)`` triples, the karaoke expansion included, that the per-format
emitters print.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Iterator, List, Optional, TextIO, Tuple

from .utils import format_timestamp

# A cue block: consecutive word records rendered as one subtitle. Word
# text inside a block may carry an embedded "\n" marking a line break.
Cue = List[dict]
Caption = Tuple[str, str, str]  # (start, end, text), timestamps formatted

_PAUSE_SECONDS = 3.0  # silence that forces a new cue when not preserving segments
_UNBOUNDED = 1000  # effective "no limit" for width / words-per-line


def _chunked_words(segments: List[dict], chunk_size: int) -> Iterator[Tuple[dict, bool]]:
    """Walk every word timing across all segments in order.

    Yields ``(record, starts_chunk)`` where ``record`` is a private copy
    of the word dict and ``starts_chunk`` flags the first word of each
    ``chunk_size``-word run within its segment (the ``max_words_per_line``
    grouping; segment starts always begin a fresh chunk).
    """
    for segment in segments:
        for idx, word in enumerate(segment.get("words", [])):
            yield dict(word), idx % chunk_size == 0


def _layout_words(
    segments: List[dict],
    width: int,
    count: Optional[int],
    chunk_size: int,
    preserve_segments: bool,
) -> List[Cue]:
    """Group word timings into cue blocks under the line-breaking rules.

    A word extends the current line when it fits within ``width`` and no
    boundary interrupts; otherwise it opens a new line (embedding "\\n"
    in its text) or — when the block already holds ``count`` lines, a
    long pause intervenes, or a new segment begins while preserving
    segment boundaries — closes the block and starts the next one.
    """
    cues: List[Cue] = []
    block: Cue = []
    line_len = 0  # characters on the line being filled
    lines = 1  # lines already in the open block
    prev_start = segments[0]["words"][0]["start"]

    for record, starts_chunk in _chunked_words(segments, chunk_size):
        pause = (not preserve_segments) and record["start"] - prev_start > _PAUSE_SECONDS
        segment_break = starts_chunk and bool(block) and preserve_segments
        fits = line_len + len(record["word"]) <= width

        if line_len > 0 and fits and not pause and not segment_break:
            # continue the current line
            line_len += len(record["word"])
        else:
            record["word"] = record["word"].strip()
            block_full = bool(block) and count is not None and (
                pause or lines >= count
            )
            if block_full or segment_break:
                cues.append(block)
                block, lines = [], 1
            elif line_len > 0:
                # open a new line inside the same block
                lines += 1
                record["word"] = "\n" + record["word"]
            line_len = len(record["word"].strip())
        block.append(record)
        prev_start = record["start"]

    if block:
        cues.append(block)
    return cues


def _underline(token: str) -> str:
    """Wrap the visible part of a word token in ``<u>``, leaving any
    leading whitespace (including an embedded line break) outside."""
    body = token.lstrip()
    pad = token[: len(token) - len(body)]
    return f"{pad}<u>{body}</u>"


def _render_cues(
    cues: List[Cue], stamp: Callable[[float], str], highlight: bool
) -> Iterator[Caption]:
    """Render cue blocks to captions.

    Plain mode emits one caption per block. Karaoke mode
    (``highlight_words``) emits one caption per word with that word
    underlined, plus un-highlighted hold captions covering any timing
    gap between consecutive words.
    """
    for block in cues:
        start, end = stamp(block[0]["start"]), stamp(block[-1]["end"])
        text = "".join(w["word"] for w in block)
        if not highlight:
            yield start, end, text
            continue
        cursor = start
        for i, word in enumerate(block):
            w_start, w_end = stamp(word["start"]), stamp(word["end"])
            if cursor != w_start:
                yield cursor, w_start, text
            yield w_start, w_end, "".join(
                _underline(w["word"]) if j == i else w["word"]
                for j, w in enumerate(block)
            )
            cursor = w_end


class ResultWriter:
    extension: str

    def __init__(self, output_dir: str):
        self.output_dir = output_dir

    def __call__(self, result: dict, audio_path: str, options: Optional[dict] = None, **kwargs):
        stem = os.path.splitext(os.path.basename(audio_path))[0]
        destination = os.path.join(self.output_dir, f"{stem}.{self.extension}")
        with open(destination, "w", encoding="utf-8") as f:
            self.write_result(result, file=f, options=options, **kwargs)

    def write_result(self, result: dict, file: TextIO, options: Optional[dict] = None, **kwargs):
        raise NotImplementedError


class WriteTXT(ResultWriter):
    extension = "txt"

    def write_result(self, result: dict, file: TextIO, options=None, **kwargs):
        for segment in result["segments"]:
            print(segment["text"].strip(), file=file, flush=True)


class SubtitlesWriter(ResultWriter):
    always_include_hours: bool
    decimal_marker: str

    def iterate_result(self, result: dict, options: Optional[dict] = None, *,
                       max_line_width: Optional[int] = None,
                       max_line_count: Optional[int] = None,
                       highlight_words: bool = False,
                       max_words_per_line: Optional[int] = None) -> Iterator[Caption]:
        opts = options or {}
        width = max_line_width or opts.get("max_line_width")
        count = max_line_count or opts.get("max_line_count")
        highlight = highlight_words or opts.get("highlight_words", False)
        chunk_size = max_words_per_line or opts.get("max_words_per_line")
        # without both width and count, cue blocks follow segment boundaries
        preserve_segments = count is None or width is None

        segments = result["segments"]
        if segments and segments[0].get("words"):
            cues = _layout_words(
                segments,
                width or _UNBOUNDED,
                count,
                chunk_size or _UNBOUNDED,
                preserve_segments,
            )
            yield from _render_cues(cues, self.format_timestamp, highlight)
        else:
            # no word timings: one caption per segment
            for segment in segments:
                yield (
                    self.format_timestamp(segment["start"]),
                    self.format_timestamp(segment["end"]),
                    segment["text"].strip().replace("-->", "->"),
                )

    def format_timestamp(self, seconds: float) -> str:
        return format_timestamp(
            seconds=seconds,
            always_include_hours=self.always_include_hours,
            decimal_marker=self.decimal_marker,
        )


class WriteVTT(SubtitlesWriter):
    extension = "vtt"
    always_include_hours = False
    decimal_marker = "."

    def write_result(self, result: dict, file: TextIO, options=None, **kwargs):
        print("WEBVTT\n", file=file)
        for start, end, text in self.iterate_result(result, options, **kwargs):
            print(f"{start} --> {end}\n{text}\n", file=file, flush=True)


class WriteSRT(SubtitlesWriter):
    extension = "srt"
    always_include_hours = True
    decimal_marker = ","

    def write_result(self, result: dict, file: TextIO, options=None, **kwargs):
        for i, (start, end, text) in enumerate(
            self.iterate_result(result, options, **kwargs), start=1
        ):
            print(f"{i}\n{start} --> {end}\n{text}\n", file=file, flush=True)


class WriteTSV(ResultWriter):
    """TSV of start/end integer milliseconds and text (machine-friendly;
    parity with the reference's rationale comment)."""

    extension = "tsv"

    def write_result(self, result: dict, file: TextIO, options=None, **kwargs):
        print("start", "end", "text", sep="\t", file=file)
        for segment in result["segments"]:
            print(round(1000 * segment["start"]), file=file, end="\t")
            print(round(1000 * segment["end"]), file=file, end="\t")
            print(segment["text"].strip().replace("\t", " "), file=file, flush=True)


class WriteJSON(ResultWriter):
    extension = "json"

    def write_result(self, result: dict, file: TextIO, options=None, **kwargs):
        json.dump(result, file, default=float)


_WRITERS = {
    "txt": WriteTXT,
    "vtt": WriteVTT,
    "srt": WriteSRT,
    "tsv": WriteTSV,
    "json": WriteJSON,
}


def get_writer(output_format: str, output_dir: str) -> Callable:
    if output_format == "all":
        every = [cls(output_dir) for cls in _WRITERS.values()]

        def write_all(result: dict, file: TextIO, options=None, **kwargs):
            for writer in every:
                writer(result, file, options, **kwargs)

        return write_all

    return _WRITERS[output_format](output_dir)
