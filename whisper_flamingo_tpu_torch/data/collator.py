"""ONE configurable collator for every training family.

Copy of ``whisper_flamingo_tpu/data/collator.py``: mels padded to the batch
maximum along time with zeros, ``labels`` padded with -100 and
``dec_input_ids`` with EOT, optional passthroughs, and the asymmetric
teacher/student token streams of prompt distillation.

``pad_multiple_frames=100`` and ``pad_multiple_tokens=8`` look like XLA
compile bucketing, but they are kept: the zero mel frames they add are
attended to by the unmasked encoder, so they change the numbers, and
parity with the JAX package needs them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

EOT = 50257
LABEL_PAD = -100


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple if multiple > 1 else n


def _pad_tokens(seqs: List[List[int]], target: int, value: int) -> np.ndarray:
    out = np.full((len(seqs), target), value, dtype=np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = np.asarray(s, dtype=np.int32)
    return out


@dataclass
class WhisperCollator:
    """Pad a list of feature dicts into fixed-shape numpy batches."""

    pad_multiple_frames: int = 100  # mel-frame quantization (1 = batch max)
    pad_multiple_tokens: int = 8  # token-length quantization
    pad_multiple_video: int = 50  # video-frame quantization (2 s @ 25 fps)
    max_frames: Optional[int] = 3000
    label_pad: int = LABEL_PAD
    eot: int = EOT

    def __call__(self, features: List[Dict[str, Any]]) -> Dict[str, Any]:
        batch: Dict[str, Any] = {}

        mels = [np.asarray(f["input_ids"]) for f in features]
        max_frames = max(m.shape[-1] for m in mels)
        max_frames = _round_up(max_frames, self.pad_multiple_frames)
        if self.max_frames:
            max_frames = min(max_frames, self.max_frames)
        padded = np.zeros((len(mels), mels[0].shape[0], max_frames), np.float32)
        for i, m in enumerate(mels):
            t = min(m.shape[-1], max_frames)
            padded[i, :, :t] = m[..., :t]
        batch["input_ids"] = padded

        token_streams = [
            ("labels", self.label_pad),
            ("dec_input_ids", self.eot),
            ("teacher_labels", self.label_pad),
            ("teacher_dec_input_ids", self.eot),
        ]
        # labels and dec_input_ids share one padded length (reference
        # utils.py:80-86 pads both to max(labels+dec_input_ids))
        for group in (("labels", "dec_input_ids"), ("teacher_labels", "teacher_dec_input_ids")):
            present = [k for k in group if k in features[0]]
            if not present:
                continue
            max_len = max(len(f[k]) for f in features for k in present)
            max_len = _round_up(max_len, self.pad_multiple_tokens)
            for k in present:
                value = dict(token_streams)[k]
                batch[k] = _pad_tokens([list(f[k]) for f in features], max_len, value)

        if any("video" in f for f in features):
            # lip-video frames (T, H, W); 750-frame/30 s contract
            # (reference whisper/audio.py:19 N_VIDEO_FRAMES), its padded
            # length quantized like the JAX package's. Any-row keying, like the passthroughs
            # below: a row missing the modality contributes zero frames
            # (video_lens 0 — the modality-drop convention), instead of a
            # first-row check that would KeyError or drop the field.
            hw = next(
                np.asarray(f["video"]).shape[1:] for f in features if "video" in f
            )
            vids = [
                np.asarray(f["video"])
                if "video" in f
                else np.zeros((0, *hw), np.float32)
                for f in features
            ]
            max_t = min(
                _round_up(
                    max(max(v.shape[0] for v in vids), 1), self.pad_multiple_video
                ),
                750,
            )
            vbatch = np.zeros((len(vids), max_t, *hw), np.float32)
            for i, v in enumerate(vids):
                t = min(v.shape[0], max_t)
                vbatch[i, :t] = v[:t]
            batch["video"] = vbatch
            batch["video_lens"] = np.asarray(
                [min(v.shape[0], max_t) for v in vids], np.int32
            )
            if any("fbank" in f for f in features):
                # stacked log-filterbank (T, 104) at the 25 fps video
                # rate (the AV-HuBERT avsr audio stream) — pad to the
                # SAME quantized length so the two modalities stay
                # frame-aligned through the fusion concat; missing rows
                # are all-zero (modality drop)
                width = next(
                    np.asarray(f["fbank"]).shape[1]
                    for f in features
                    if "fbank" in f
                )
                fbs = [
                    np.asarray(f["fbank"], np.float32)
                    if "fbank" in f
                    else np.zeros((0, width), np.float32)
                    for f in features
                ]
                fbatch = np.zeros((len(fbs), max_t, width), np.float32)
                for i, fb in enumerate(fbs):
                    t = min(fb.shape[0], max_t)
                    fbatch[i, :t] = fb[:t]
                batch["fbank"] = fbatch
                batch["fbank_lens"] = np.asarray(
                    [min(fb.shape[0], max_t) for fb in fbs], np.int32
                )

        # int passthroughs: keyed on presence in ANY feature — a batch can
        # mix prompted and unprompted rows (empty prompt -> no prompt_lens
        # emitted, whisper_prompt semantics), and a first-row check would
        # either KeyError or silently drop the field
        int_defaults = {"wav_lens": 0, "audio_frames": 0, "prompt_lens": 0}
        for passthrough, default in int_defaults.items():
            if any(passthrough in f for f in features):
                batch[passthrough] = np.asarray(
                    [f.get(passthrough, default) for f in features], dtype=np.int32
                )
        str_defaults = {
            "translations": "",
            "all_translations": [],  # list-typed (one entry per language)
            "prompt": "", "ids": "", "text": "",
        }
        for strkey, default in str_defaults.items():
            if any(strkey in f for f in features):
                batch[strkey] = [f.get(strkey, default) for f in features]
        return batch
