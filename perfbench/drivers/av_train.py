"""Whisper-Flamingo step 2: the gated layers trained over a frozen Whisper and
a frozen AV-HuBERT trunk, through the functions ``recipes/av_train.py``
uses: ``training/steps.make_av_train_step``, ``whisper_flamingo_optimizer``
over ``flamingo_trainable_mask``, ``cast_frozen_bf16`` (the recipe's
``maybe_cast_frozen``) for the frozen Whisper, ``cast_video_bf16`` for the
trunk, and batches from ``data/collator.WhisperCollator`` over items laid
out as ``VideoSpeechDataset`` lays them out.

Traffic keys: ``pool`` batches of ``batch`` clips made from the seed. The
``pool`` x ``batch`` clip lengths spread evenly over ``clip_seconds`` (the
configuration's 15 s cap), sorted by ``SortedBatchSampler`` into batches of
like lengths, the batches' order shuffled from the seed; each clip
``audio_std`` N(0, 1) audio, its log-mel as the data pipeline makes it,
``fps`` frames a second of seeded lip crops of the configuration's
``video`` size (pixels uniform in 0..255, normalised), and a target of
random text ids whose length (with the start-of-transcript tokens) spreads
evenly over ``target_tokens``. The collator pads each batch's mel to 100
frames and its video to 50; ``spec_augment`` names the preset whose masks
the seed draws (applied on the device). One modality draw a step, from a
generator the seed fixes, at the configuration's ``prob_av`` / ``prob_a``.
Every seed does the same work, in another order.

Set-up builds the train state once and drives it through its first three
steps, which it makes one of each modality (the draws' seed is the first
from the cell's seed whose three draws cover all three), then through each
other batch of the pool once, so that every shape is warm; the window goes
on with the same objects, reads no loss, and ends at the first step
boundary at or after ``--seconds``, the device drained.

The check replays the first three steps with the plain reference
(``reference.av_train_ref``, in blocks of rows) from the same weights,
inputs and modality draws, and compares as ``finetune`` does (each step's
loss, each gated parameter's first gradient norm, each gated parameter's
change after three steps by its norm and as a vector), plus
``frozen_changed``: the frozen parameters and statistics of the Whisper and
of the trunk that differ, after the window, from the seeded values in the
dtype they are stored in.

In traced runs the generator opens the ranges ``trunk`` and ``encoder``
around the program's trunk and Whisper encoder inside the step (looked up
at call time in ``training/steps``), and installs the program's span sink
over the window: the counters of the window's modality draws go to the
notes.
"""

from __future__ import annotations

import contextlib
import time
from statistics import median

import numpy as np
import torch

from .. import av_train_flops
from ..reference import av_train_ref
from . import av_decode, common, finetune

SAMPLE_RATE = 16000
FIRST_STEPS = 3
REF_ROWS = 4  # rows a block of the reference's step
COUNTERS = ("train.av_both", "train.av_audio", "train.av_video")


def build_trunk(cfg: dict, seed: int, device):
    """The port's ``VideoEncoder`` of the configuration's shape holding the
    benchmark's trunk weights (fp32)."""
    from whisper_flamingo_tpu_torch.models.avhubert import VideoEncoder, VideoEncoderConfig

    with torch.device(device):
        trunk = VideoEncoder(VideoEncoderConfig(**cfg["trunk"])).to(device)
    state = av_decode.trunk_state(cfg, seed, device)
    missing, unexpected = trunk.load_state_dict(state, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
        raise KeyError(f"trunk weights do not match: {missing[:4]} {unexpected[:4]}")
    return trunk.eval()


def mode_of(u: float, train: dict) -> str:
    """``make_av_train_step``'s modality for the draw ``u``."""
    if u < train["prob_av"]:
        return "both"
    return "audio" if u < train["prob_av"] + train["prob_a"] else "video"


def draw_seed(seed: int, train: dict, n: int = FIRST_STEPS):
    """The first generator seed from ``seed`` whose first ``n`` draws give
    every modality, and those modalities."""
    for k in range(10_000):
        s = int(seed) * 10_000 + k
        g = torch.Generator().manual_seed(s)
        modes = [mode_of(float(torch.rand((), generator=g)), train) for _ in range(n)]
        if set(modes) == set(av_train_ref.MODES):
            return s, modes
    raise ValueError("no draw seed gives every modality")


def row_blocks(batch: dict, rows: int) -> list:
    """``batch``'s tensors cut into blocks of ``rows`` rows (other values
    shared)."""
    n = batch["mel"].shape[0]
    return [{k: (v[i: i + rows] if torch.is_tensor(v) else v) for k, v in batch.items()}
            for i in range(0, n, rows)]


class Driver(finetune.Driver):

    # -- inputs ------------------------------------------------------------------

    def _items(self, rng: np.random.Generator):
        t, tok, v = self.traffic, self.cfg["tokens"], self.cfg["video"]
        n = int(t["batch"]) * int(t["pool"])
        lo, hi = t["clip_seconds"]
        hop = 160
        seconds = [lo + (hi - lo) * i / (n - 1) for i in range(n)]
        lengths = common.stratified(*t["target_tokens"], n)
        sot = list(tok["sot_sequence_notimestamps"])
        items = []
        for s, length in zip(rng.permutation(seconds), rng.permutation(lengths)):
            samples = int(round(s * SAMPLE_RATE / hop)) * hop
            wav = rng.standard_normal(samples, dtype=np.float32) * t["audio_std"]
            pixels = rng.integers(0, 256, (int(round(s * t["fps"])), v["height"], v["width"]),
                                  dtype=np.uint8)
            video = (pixels.astype(np.float32) / 255.0 - v["pixel_mean"]) / v["pixel_std"]
            text = rng.integers(0, tok["eot"], size=int(length) - len(sot)).tolist()
            dec = sot + text
            items.append({"wav": wav, "video": video, "dec_input_ids": dec,
                          "labels": dec[1:] + [tok["eot"]]})
        return items

    def _batches(self):
        from whisper_flamingo_tpu_torch.audio import log_mel_spectrogram
        from whisper_flamingo_tpu_torch.data.collator import WhisperCollator
        from whisper_flamingo_tpu_torch.data.samplers import SortedBatchSampler
        from whisper_flamingo_tpu_torch.ops.spec_augment import PRESETS

        self.preset = PRESETS[self.traffic["spec_augment"]]
        rng = np.random.default_rng(self.seed)
        gen = torch.Generator().manual_seed(self.seed)
        collate = WhisperCollator()
        n_mels = self.cfg["dims"]["n_mels"]
        items = self._items(rng)
        feats = [{"input_ids": log_mel_spectrogram(it["wav"], n_mels,
                                                   device=self.device).cpu().numpy(),
                  "dec_input_ids": it["dec_input_ids"], "labels": it["labels"],
                  "video": it["video"]} for it in items]
        sampler = SortedBatchSampler(int(self.traffic["batch"]),
                                     [f["input_ids"].shape[-1] for f in feats])
        pool = []
        for b in rng.permutation(len(sampler.batch_list)):
            keys = sampler.batch_list[b]
            frames = np.array([len(items[k]["wav"]) // 160 for k in keys])
            pool.append({"items": [items[k] for k in keys],
                         "batch": collate([feats[k] for k in keys]), "frames": frames,
                         "draws": self._draws(gen, frames, n_mels)})
        return pool

    # -- set-up --------------------------------------------------------------------

    def setup(self) -> None:
        from whisper_flamingo_tpu_torch.models.dims import ModelDimensions
        from whisper_flamingo_tpu_torch.recipes.av_train import cast_video_bf16
        from whisper_flamingo_tpu_torch.training.optim import (
            flamingo_trainable_mask,
            whisper_flamingo_optimizer,
        )
        from whisper_flamingo_tpu_torch.training.steps import (
            TrainState,
            cast_frozen_bf16,
            make_av_train_step,
        )

        cfg, tr = self.cfg, self.cfg["train"]
        self.pool = self._batches()
        model = common.build_whisper(cfg, self.seed, self.device)
        video = build_trunk(cfg, self.seed, self.device)
        if self.dtype == torch.bfloat16 and tr["frozen_params_bf16"]:
            cast_frozen_bf16(model, flamingo_trainable_mask(model))
        if self.dtype == torch.bfloat16 and tr["freeze_video_model"]:
            cast_video_bf16(video)
        tx, _ = whisper_flamingo_optimizer(model, tr["learning_rate"],
                                           weight_decay=tr["weight_decay"],
                                           adam_epsilon=tr["adam_epsilon"],
                                           warmup_steps=tr["warmup_steps"],
                                           total_steps=tr["num_train_steps"])
        self.state, self.video = TrainState.create(model, tx), video
        self.step_fn = make_av_train_step(
            ModelDimensions(**cfg["dims"]), prob_av=tr["prob_av"], prob_a=tr["prob_a"],
            freeze_video=bool(tr["freeze_video_model"]), dtype=self.dtype, remat=tr["remat"])
        seed, self.modes = draw_seed(self.seed, tr)
        self.gen = torch.Generator().manual_seed(seed)
        self.readings = {"losses": []}
        for i in range(FIRST_STEPS):
            self.readings["losses"].append(float(self._step(i)["loss"]))
            if i == 0:
                self.readings["first_grad"] = {
                    n: float(m.double().norm()) / (1 - tx.b1) for n, m in zip(tx.names, tx.mu)}
        start = common.whisper_state(cfg, self.seed, self.device)
        delta = {n: p.detach() - start[n] for n, p in zip(tx.names, tx.params)}
        self.readings["change"] = {n: float(d.double().norm()) for n, d in delta.items()}
        self.readings["delta"] = {n: d.cpu() for n, d in delta.items()}
        del start, delta
        self.done = max(FIRST_STEPS, len(self.pool))
        for i in range(FIRST_STEPS, self.done):  # every other batch's shapes, warm
            self._step(i)
        common.sync(self.device)

    def _step(self, i: int) -> dict:
        from whisper_flamingo_tpu_torch.ops.spec_augment import spec_augment_apply

        item = self.pool[i % len(self.pool)]
        batch = dict(item["batch"])
        mel = torch.as_tensor(batch["input_ids"]).to(self.device, non_blocking=True)
        with self.rec.range("spec_augment"):
            frames = torch.as_tensor(item["frames"]).to(self.device)
            mel = spec_augment_apply(mel.transpose(1, 2), frames, item["draws"],
                                     self.preset["n_freq_mask"]).transpose(1, 2)
        batch["input_ids"] = mel
        with self.rec.range("train_step"):
            self.state, metrics = self.step_fn(self.state, self.video, batch, self.gen)
        return metrics

    # -- the window ------------------------------------------------------------------

    @contextlib.contextmanager
    def _ranges(self):
        """``trunk`` and ``encoder`` around the step's frozen forwards, in
        traced runs."""
        if not self.rec.traced:
            yield
            return
        from whisper_flamingo_tpu_torch.training import steps

        saved = {}
        for name, label in (("avhubert_encoder_apply", "trunk"), ("encoder_apply", "encoder")):
            orig = saved[name] = getattr(steps, name)

            def wrapped(*args, _orig=orig, _label=label, **kwargs):
                with self.rec.range(_label):
                    return _orig(*args, **kwargs)

            setattr(steps, name, wrapped)
        try:
            yield
        finally:
            for name, orig in saved.items():
                setattr(steps, name, orig)

    def unit_flops(self, i: int) -> float:
        batch = self.pool[i % len(self.pool)]["batch"]
        return av_train_flops.step_flops(self.cfg, batch["input_ids"].shape[0],
                                         batch["input_ids"].shape[-1],
                                         batch["dec_input_ids"].shape[-1],
                                         batch["video"].shape[1])

    def run_window(self) -> dict:
        from whisper_flamingo_tpu_torch import profiling

        from ..instrument import instrument

        rec, seconds, units = self.rec, self.seconds, self.units
        sink = profiling.collect() if rec.traced else contextlib.nullcontext()
        n = 0
        with instrument(rec), self._ranges(), sink as spans, rec.profiling():
            t0 = time.perf_counter()
            with rec.range("window"):
                while True:
                    self._step(self.done + n)
                    n += 1
                    elapsed = time.perf_counter() - t0
                    if (units and n >= units) or (not units and elapsed >= seconds):
                        break
                common.sync(self.device)
            window_s = time.perf_counter() - t0
        stats = {"window_s": window_s, "units": n, "attempted": n, "failed": 0,
                 "flops": sum(self.unit_flops(self.done + i) for i in range(n)),
                 "e2e": {"train_step_ms": 1e3 * window_s / n}}
        # the program's counters: the span report's recorder keeps them when
        # it shadows this sink
        counters = getattr(rec, "counters", None) or (spans.counters if spans else {})
        if counters:
            stats["notes"] = {k: counters.get(k, 0) for k in COUNTERS}
        return stats

    @torch.no_grad()
    def _frozen_changed(self) -> int:
        """Frozen tensors of the Whisper and the trunk that differ from the
        seeded values in their stored dtype."""
        model = self.state.model
        sd = common.whisper_state(self.cfg, self.seed, self.device)
        changed = sum(not torch.equal(p, sd[n].to(p.dtype))
                      for n, p in model.named_parameters() if not p.requires_grad)
        del sd
        tsd = av_decode.trunk_state(self.cfg, self.seed, self.device)
        changed += sum(not torch.equal(t, tsd[n].to(t.dtype))
                       for n, t in self.video.state_dict().items() if n in tsd)
        return int(changed)

    def release(self) -> None:
        self.frozen_changed = self._frozen_changed()
        del self.state, self.step_fn, self.video
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------------------

    def reference_steps(self) -> list:
        """The first three steps as the reference's blocks of rows, each with
        its video and the step's modality."""
        out = []
        for i, batch in enumerate(self.reference_batches()):
            item = self.pool[i % len(self.pool)]
            batch["video"] = torch.as_tensor(item["batch"]["video"]).to(self.device)
            batch["mode"] = self.modes[i]
            out.append(row_blocks(batch, REF_ROWS))
        return out

    @torch.no_grad()
    def check(self, limits: dict) -> list:
        cfg, tr = self.cfg, self.cfg["train"]
        sd = common.whisper_state(cfg, self.seed, self.device)
        trunk = (av_decode.trunk_state(cfg, self.seed, self.device), cfg["trunk"])
        steps = self.reference_steps()

        def run(lowp=None):
            return av_train_ref.train_steps(sd, cfg["dims"], steps, tr,
                                            av_train_ref.flamingo_trainable, lambda n: True,
                                            trunk=trunk, lowp=lowp)

        with torch.enable_grad():
            ref = run()
            got = run("fp8") if self.control == "fp8" else self.readings
        del sd, trunk, steps
        grads = ref["first_grad"]
        med = median(grads.values())
        self.kept = sum(g >= 1e-3 * med for g in grads.values())
        self.losses = {"program": got["losses"], "reference": ref["losses"]}
        self.numbers = dict(finetune.compare(got, ref), frozen_changed=float(self.frozen_changed))
        return [(name, self.numbers[name], limit) for name, limit in limits.items()]

    def notes(self) -> dict:
        return {"parameters_compared": self.kept, "losses": self.losses, "modes": self.modes,
                **self.numbers}
