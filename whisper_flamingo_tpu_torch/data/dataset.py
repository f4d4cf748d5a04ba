"""Datasets and the example-preparation pipeline.

Port of ``whisper_flamingo_tpu/data/dataset.py``: the reference's shared
``__getitem__`` recipe

    normalize text -> (prob.) noise-mix -> pad_or_trim -> log-mel ->
    SpecAugment -> dec_input_ids = sot_sequence(+notimestamps) + tokens,
    labels = shifted + EOT, prompt/translation attachments per family

as one :class:`SpeechDataset` over an :class:`AsrSource`, with the
synthetic, manifest, JSON and HuggingFace ``datasets`` sources. The
per-example numpy rng is the JAX
package's, so the same seed, index and epoch give the same noise and
SpecAugment draws; the mel is the port's ``audio.log_mel_spectrogram`` on
the CPU (host-side example preparation, as in the JAX package).
:class:`DataLoader` batches through a sampler and a collator;
:class:`PrefetchLoader` prepares batches in a background thread.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..audio import N_SAMPLES, log_mel_spectrogram, pad_or_trim
from ..ops.spec_augment import PRESETS, spec_augment_np
from ..tokenizer import Tokenizer
from .noise import add_noise


@dataclass
class AsrExample:
    audio: np.ndarray  # float32 waveform @16 kHz
    text: str
    id: str = ""
    translations: List[str] = field(default_factory=list)
    prompt: str = ""
    # lip-video frames (T, H, W) float32, 25 fps — the AV surface
    # (reference audio.py:19 N_VIDEO_FRAMES contract); None for audio-only
    video: Optional[np.ndarray] = None


class AsrSource:
    """Abstract example source."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> AsrExample:
        raise NotImplementedError

    def lengths(self) -> List[int]:
        """Per-utterance audio lengths in samples (for length bucketing)."""
        return [len(self[i].audio) for i in range(len(self))]


class SyntheticAsrSource(AsrSource):
    """Deterministic random utterances (tests, benchmarks, smoke train)."""

    def __init__(
        self,
        n: int = 32,
        seed: int = 0,
        min_sec: float = 1.0,
        max_sec: float = 8.0,
        vocab: Sequence[str] = ("hello", "world", "speech", "model", "test"),
        n_translations: int = 0,
    ):
        self.n = n
        self.seed = seed
        self.min_sec = min_sec
        self.max_sec = max_sec
        self.vocab = list(vocab)
        self.n_translations = n_translations

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int) -> AsrExample:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        dur = rng.uniform(self.min_sec, self.max_sec)
        audio = rng.standard_normal(int(dur * 16000)).astype(np.float32) * 0.05
        words = rng.choice(self.vocab, size=rng.integers(2, 8))
        text = " ".join(words)
        return AsrExample(
            audio=audio,
            text=text,
            id=f"synthetic-{idx}",
            translations=[f"trans{k} {text}" for k in range(self.n_translations)],
        )


class ManifestAsrSource(AsrSource):
    """TSV/CSV manifest: columns id, wav_path, text[, translation...]."""

    def __init__(self, manifest_path: str, audio_root: str = "",
                 load_video: bool = True):
        self.rows: List[Dict[str, str]] = []
        self.audio_root = audio_root
        # audio-only consumers can skip the ~22 MB-per-utterance lip-video
        # .npy loads even when the manifest carries a video_path column
        self.load_video = load_video
        with open(manifest_path, newline="") as f:
            delim = "\t" if manifest_path.endswith(".tsv") else ","
            for row in csv.DictReader(f, delimiter=delim):
                self.rows.append(row)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> AsrExample:
        from ..audio import load_audio

        row = self.rows[idx]
        path = os.path.join(self.audio_root, row["wav_path"])
        translations = [
            v for k, v in sorted(row.items()) if k.startswith("translation") and v
        ]
        video = None
        if self.load_video and row.get("video_path"):
            # .npy lip-video features (MuAViC preprocessing output)
            video = np.load(
                os.path.join(self.audio_root, row["video_path"])
            ).astype(np.float32)
        return AsrExample(
            audio=load_audio(path),
            text=row.get("text", ""),
            id=row.get("id", str(idx)),
            translations=translations,
            prompt=row.get("prompt", ""),
            video=video,
        )


class JsonAsrSource(AsrSource):
    """JSON-list source (the ML-SUPERB layout, reference
    config/audio-text/ml-superb.yaml:36-37): a JSON array of objects with
    audio-path and text keys."""

    def __init__(self, json_path: str, audio_key: str = "wav_path",
                 text_key: str = "text", audio_root: str = ""):
        import json

        with open(json_path) as f:
            data = json.load(f)
        self.rows = list(data.values()) if isinstance(data, dict) else list(data)
        self.audio_key = audio_key
        self.text_key = text_key
        self.audio_root = audio_root

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> AsrExample:
        from ..audio import load_audio

        row = self.rows[idx]
        return AsrExample(
            audio=load_audio(os.path.join(self.audio_root, row[self.audio_key])),
            text=row.get(self.text_key, ""),
            id=str(row.get("id", idx)),
        )


# Per-dataset field quirks of the reference scripts. Keys: text_key;
# translation_keys (the conditioning streams, in order); prompt_keys
# (joined with "_": the kloka prompt is "language_dialect"); filter_nonempty
# (drop rows whose field is empty: the empty-"chinese" rows of kloka);
# split_names (our split -> (dataset suffix, HF split): the kloka train and
# eval corpora are separate datasets whose HF split is always "train").
HF_DATASET_PRESETS = {
    "google/fleurs": {"text_key": "transcription"},
    "formospeech/kloka_crawled_asr": {
        "text_key": "text",
        "translation_keys": ("chinese",),
        "prompt_keys": ("language", "dialect"),
        "filter_nonempty": "chinese",
        "split_names": {
            "train": ("_train", "train"),
            "validation": ("_eval", "train"),
            "test": ("_eval", "train"),
        },
    },
    "formospeech/yttd_taigi_trs": {"text_key": "text"},
}


class HFAsrSource(AsrSource):
    """HuggingFace ``datasets`` source (librispeech_asr, google/fleurs,
    formospeech/*), a port of the JAX package's, with its quirks:

    - the preset whose name prefixes ``name`` gives the field maps
      (overridable per instance);
    - ``config`` may be a "+"-joined list of config names, each loaded and
      then concatenated (kloka dialects);
    - rows whose ``filter_nonempty`` field is empty are dropped per config,
      with the count printed;
    - ``split_names`` remaps the split: a name that already ends in this
      split's suffix keeps it and only the HF split changes; any other
      name gets the suffix appended (a name with another split's suffix
      then names no dataset and fails at load, instead of serving the
      wrong corpus);
    - audio off 16 kHz is resampled linearly to it.

    ``datasets`` is imported at construction (it needs a local cache
    offline)."""

    def __init__(
        self,
        name: str,
        split: str,
        config: Optional[str] = None,
        text_key: Optional[str] = None,
        audio_key: str = "audio",
        translation_keys: Optional[Sequence[str]] = None,
        prompt_keys: Optional[Sequence[str]] = None,
        filter_nonempty: Optional[str] = None,
        **load_kwargs,
    ):
        import datasets

        preset = next((v for k, v in HF_DATASET_PRESETS.items() if name.startswith(k)), {})
        self.text_key = text_key or preset.get("text_key", "text")
        self.audio_key = audio_key
        self.translation_keys = (translation_keys if translation_keys is not None
                                 else preset.get("translation_keys", ()))
        self.prompt_keys = prompt_keys if prompt_keys is not None else preset.get("prompt_keys", ())
        filter_nonempty = filter_nonempty or preset.get("filter_nonempty")

        split_names = preset.get("split_names")
        if split_names and split in split_names:
            suffix, hf_split = split_names[split]
            if name.endswith(suffix):
                split = hf_split
            else:
                name, split = name + suffix, hf_split

        configs = [c.strip() for c in config.split("+")] if config else [None]
        parts = []
        for cfg_name in configs:
            ds = datasets.load_dataset(name, cfg_name, split=split, **load_kwargs)
            if filter_nonempty:
                n0 = len(ds)
                ds = ds.filter(lambda ex: str(ex.get(filter_nonempty, "") or "").strip() != "")
                print(f"{name}[{cfg_name}]: {n0} rows, "
                      f"{len(ds)} after non-empty {filter_nonempty!r} filter")
            parts.append(ds)
        self.ds = parts[0] if len(parts) == 1 else datasets.concatenate_datasets(parts)

    def __len__(self) -> int:
        return len(self.ds)

    def __getitem__(self, idx: int) -> AsrExample:
        row = self.ds[int(idx)]
        audio = row[self.audio_key]
        wav = np.asarray(audio["array"], dtype=np.float32)
        if audio.get("sampling_rate", 16000) != 16000:
            from ..audio import resample_linear

            wav = resample_linear(wav, audio["sampling_rate"], 16000)
        return AsrExample(
            audio=wav,
            text=row[self.text_key],
            id=str(row.get("id", idx)),
            translations=[str(row[k]) for k in self.translation_keys if k in row],
            prompt="_".join(str(row[k]) for k in self.prompt_keys if k in row),
        )


@dataclass
class SpeechDataset:
    """Applies the shared example-preparation recipe to an AsrSource."""

    source: AsrSource
    tokenizer: Tokenizer
    audio_max_length: int = N_SAMPLES
    pad_to_max: bool = False  # False: pad-to-batch-max via the collator
    spec_augment: str = ""  # "", "ls-basic", "ls-double"
    noise_prob: float = 0.0
    noise_wavs: Sequence[Any] = ()
    noise_snr: Any = 0
    n_mels: int = 80
    prompt_use: bool = False
    max_prompt_len: int = 100  # reference whisper_prompt_librispeech.py:39
    translations_use: bool = False
    text_normalizer: Any = None
    seed: int = 3407
    training: bool = True
    epoch: int = 0  # mixed into the per-example rng; see set_epoch

    def set_epoch(self, epoch: int) -> None:
        """Advance the augmentation rng stream: without an epoch component
        every utterance would get the *same* SpecAugment masks and noise
        draw in every epoch (the reference draws fresh randomness per
        access, whisper_ft_librispeech.py:58-102)."""
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.source)

    def mel_lengths(self) -> List[int]:
        return [
            min(l, self.audio_max_length) // 160 for l in self.source.lengths()
        ]

    def __getitem__(self, idx: int, ex: Optional[AsrExample] = None) -> Dict[str, Any]:
        # subclasses that need the raw example (video, teacher prompt) can
        # pass their already-fetched one: sources may decode audio from
        # disk per access, so a second fetch doubles host-side prep cost
        if ex is None:
            ex = self.source[idx]
        rng = np.random.default_rng(
            (self.seed * 1000003 + idx) * 1000033 + self.epoch
        )
        text = ex.text
        if self.text_normalizer is not None:
            text = self.text_normalizer(text)

        wav = ex.audio
        # noise applies whenever configured — the reference mixes babble at
        # EVAL time too (the 0 dB test condition, README.md:113-117); the
        # recipe's loader decides the per-split noise_prob
        if self.noise_prob > 0 and rng.random() < self.noise_prob and len(self.noise_wavs):
            wav = add_noise(wav * 32768.0, self.noise_wavs, self.noise_snr, rng).astype(
                np.float32
            ) / 32768.0
        wav = wav[: self.audio_max_length]
        audio_frames = len(wav) // 160
        if self.pad_to_max:
            wav = pad_or_trim(wav, self.audio_max_length)

        mel = log_mel_spectrogram(wav, self.n_mels, device="cpu").numpy()  # (n_mels, T)
        if self.training and self.spec_augment:
            preset = PRESETS[self.spec_augment]
            mel = spec_augment_np(
                mel.T, audio_frames, rng=rng, **preset
            ).T.astype(np.float32)

        # token streams (reference whisper_ft_librispeech.py:90-95)
        sot_seq = list(self.tokenizer.sot_sequence_including_notimestamps)
        text_tokens = self.tokenizer.encode(" " + text.strip() if text else "")
        dec_input_ids = sot_seq + text_tokens
        labels = dec_input_ids[1:] + [self.tokenizer.eot]

        feat: Dict[str, Any] = {
            "input_ids": mel,
            "dec_input_ids": dec_input_ids,
            "labels": labels,
            "wav_lens": len(wav),
            "audio_frames": audio_frames,
            "ids": ex.id,
            "text": text,
        }
        if getattr(self, "emit_wav", False):
            # the PROCESSED waveform (noise-mixed, trimmed) for consumers
            # that featurize it again — e.g. the avsr fbank stream must
            # see the same babble mix as the mel (VideoSpeechDataset pops
            # this; it never reaches the collator)
            feat["wav"] = wav

        if self.prompt_use and ex.prompt:
            # prompt splicing parity: whisper_prompt_librispeech.py:146-162
            prompt_tokens = self.tokenizer.encode(" " + ex.prompt.strip())
            prompt_tokens = prompt_tokens[-self.max_prompt_len:]
            prefix = [self.tokenizer.sot_prev] + prompt_tokens
            feat["dec_input_ids"] = prefix + dec_input_ids
            feat["labels"] = [-100] * len(prefix) + labels
            feat["prompt_lens"] = len(prefix)

        if self.translations_use:
            feat["all_translations"] = list(ex.translations)
        return feat


class DataLoader:
    """Minimal batch iterator: batch sampler + dataset + collator."""

    def __init__(self, dataset, batch_sampler, collator):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collator = collator

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.batch_sampler)

    def __iter__(self):
        for batch_idx in self.batch_sampler:
            yield self.collator([self.dataset[i] for i in batch_idx])


class PrefetchLoader:
    """Background-thread prefetch over any loader: host-side example prep
    (mel, SpecAugment, tokenization) overlaps with device steps — the
    equivalent of the reference's DataLoader worker processes
    (`num_workers=16`, config/audio/librispeech.yaml:7) without the fork
    overhead."""

    def __init__(self, loader, prefetch: int = 2):
        self.loader = loader
        self.prefetch = prefetch

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error = []
        stop = threading.Event()

        def worker():
            try:
                for item in self.loader:
                    # bounded put that re-checks `stop`: a consumer that
                    # abandons iteration early (e.g. a max_batches
                    # validate loop) must not leave this thread blocked
                    # on a full queue forever, pinning the loader and
                    # its batches
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except Exception as e:  # propagate to the consumer
                error.append(e)
            finally:
                # the sentinel must use the same stop-aware bounded put:
                # a merely-slow consumer can have the queue full here, and
                # dropping the sentinel would leave it blocked on q.get()
                # forever after draining the remaining items
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()  # generator closed early: release the producer
