"""Fine-tuning: the CE train step of ``training/steps.make_ce_train_step``
with the configuration's AdamW, on batches from ``data/collator.
WhisperCollator``, SpecAugment applied on the device.

Traffic keys: ``pool`` distinct batches of ``batch`` items made from the
seed; each item ``audio_std`` N(0, 1) audio of a length spread evenly over
``clip_seconds`` (the configuration's cap), its log-mel as the data pipeline
makes it (the clip's own frames, the collator padding the batch to its
longest, rounded to 100 frames), and a target of random text ids whose
length (with the start-of-transcript tokens) spreads evenly over
``target_tokens``; ``spec_augment`` names the preset whose masks the seed
draws for each batch. Every seed does the same work.

Set-up builds the train state once and drives it through its first three
steps, on three different batches, through the window's own call, and keeps
each parameter's change over them on the host; the window goes on with the
same object, reads no loss (as ``Trainer.fit`` between its log steps, the
host runs ahead of the device), and ends at the first step boundary at or
after ``--seconds``, the device drained. The check replays those three
steps with the plain reference from the same weights and inputs and
compares each step's loss, the first gradient's norm per parameter (from
the optimizer's first moment after one step), each parameter's change
after three steps by its norm (``change_norm_gap``) and as a vector
(``change_gap``: the norm of the program's change less the reference's,
which sees a change of the wrong sign or on the wrong parameter), each
against the reference's norm of that parameter or of the median parameter,
whichever is larger; parameters whose reference gradient is under a
thousandth of the median one's (moved by round-off alone) are left out.
"""

from __future__ import annotations

import time
from statistics import median

import numpy as np
import torch

from .. import flops as F
from ..reference import mel_ref, train_ref
from . import common

SAMPLE_RATE = 16000
FIRST_STEPS = 3


class Driver:
    def __init__(self, cfg, traffic, seed, rec, device, control=False, seconds=0.0, units=0):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.rec, self.device, self.control = rec, torch.device(device), control
        self.seconds, self.units = seconds, units
        self.dtype = common.DTYPES[cfg["dtype"]]

    # -- inputs ------------------------------------------------------------------

    def _items(self, rng: np.random.Generator):
        t, tok = self.traffic, self.cfg["tokens"]
        n = int(t["batch"])
        lo, hi = t["clip_seconds"]
        hop = 160
        samples = [int(round(s * SAMPLE_RATE / hop)) * hop
                   for s in common.stratified(lo, hi, n)]
        lengths = common.stratified(*t["target_tokens"], n)
        sot = list(tok["sot_sequence_notimestamps"])
        items = []
        for s, length in zip(rng.permutation(samples), rng.permutation(lengths)):
            wav = (rng.standard_normal(int(s), dtype=np.float32) * t["audio_std"])
            text = rng.integers(0, tok["eot"], size=int(length) - len(sot)).tolist()
            dec = sot + text
            items.append({"wav": wav, "dec_input_ids": dec, "labels": dec[1:] + [tok["eot"]]})
        return items

    def _draws(self, gen: torch.Generator, frames: np.ndarray, n_mels: int) -> torch.Tensor:
        """Each row's SpecAugment geometry (w, width, start) from the seed,
        in the layout of ``ops.spec_augment.spec_augment_draws``."""
        p = self.preset
        b = len(frames)
        out = []
        for i in range(b):
            row = []
            for n, max_w, span in ((p["n_freq_mask"], p["max_freq_width"], n_mels),
                                   (p["n_time_mask"], p["max_time_width"], int(frames[i]))):
                for _ in range(n):
                    w, width = (int(x) for x in torch.randint(0, max_w, (2,), generator=gen))
                    high = max(span - w, 1)
                    start = int(torch.randint(0, high, (1,), generator=gen))
                    row.append((w, width, start))
            out.append(row)
        return torch.tensor(out, dtype=torch.int64)

    def _batches(self):
        from whisper_flamingo_tpu_torch.audio import log_mel_spectrogram
        from whisper_flamingo_tpu_torch.data.collator import WhisperCollator
        from whisper_flamingo_tpu_torch.ops.spec_augment import PRESETS

        self.preset = PRESETS[self.traffic["spec_augment"]]
        rng = np.random.default_rng(self.seed)
        gen = torch.Generator().manual_seed(self.seed)
        collate = WhisperCollator()
        n_mels = self.cfg["dims"]["n_mels"]
        pool = []
        for _ in range(int(self.traffic["pool"])):
            items = self._items(rng)
            feats = [{"input_ids": log_mel_spectrogram(it["wav"], n_mels,
                                                       device=self.device).cpu().numpy(),
                      "dec_input_ids": it["dec_input_ids"], "labels": it["labels"]}
                     for it in items]
            batch = collate(feats)
            frames = np.array([len(it["wav"]) // 160 for it in items])
            pool.append({"items": items, "batch": batch, "frames": frames,
                         "draws": self._draws(gen, frames, n_mels)})
        return pool

    # -- set-up --------------------------------------------------------------------

    def setup(self) -> None:
        from whisper_flamingo_tpu_torch.training.optim import whisper_optimizer
        from whisper_flamingo_tpu_torch.training.steps import TrainState, make_ce_train_step

        cfg, tr = self.cfg, self.cfg["train"]
        self.pool = self._batches()
        model = common.build_whisper(cfg, self.seed, self.device)
        tx, _ = whisper_optimizer(model, tr["learning_rate"], weight_decay=tr["weight_decay"],
                                  adam_epsilon=tr["adam_epsilon"],
                                  warmup_steps=tr["warmup_steps"],
                                  total_steps=tr["num_train_steps"])
        self.state = TrainState.create(model, tx)
        from whisper_flamingo_tpu_torch.models.dims import ModelDimensions

        self.step_fn = make_ce_train_step(ModelDimensions(**cfg["dims"]), dtype=self.dtype,
                                          remat=tr["remat"])
        self.readings = {"losses": []}
        for i in range(FIRST_STEPS):
            self.readings["losses"].append(float(self._step(i)["loss"]))
            if i == 0:
                b1 = tx.b1
                self.readings["first_grad"] = {
                    n: float(m.double().norm()) / (1 - b1) for n, m in zip(tx.names, tx.mu)}
        start = common.whisper_state(cfg, self.seed, self.device)
        delta = {n: p.detach() - start[n] for n, p in model.named_parameters()}
        self.readings["change"] = {n: float(d.double().norm()) for n, d in delta.items()}
        self.readings["delta"] = {n: d.cpu() for n, d in delta.items()}
        del start, delta
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
            self.state, metrics = self.step_fn(self.state, batch)
        return metrics

    # -- the window ------------------------------------------------------------------

    def run_window(self) -> dict:
        from ..instrument import instrument

        rec, seconds, units = self.rec, self.seconds, self.units
        n = 0
        with instrument(rec), rec.profiling():
            t0 = time.perf_counter()
            with rec.range("window"):
                while True:
                    self._step(FIRST_STEPS + n)
                    n += 1
                    elapsed = time.perf_counter() - t0
                    if (units and n >= units) or (not units and elapsed >= seconds):
                        break
                common.sync(self.device)
            window_s = time.perf_counter() - t0
        frames = self.pool[0]["batch"]["input_ids"].shape[-1]
        text = self.pool[0]["batch"]["dec_input_ids"].shape[-1]
        flops = 3 * F.model_flops(self.cfg["dims"], int(self.traffic["batch"]), frames, text)
        return {"window_s": window_s, "units": n, "attempted": n, "failed": 0,
                "flops": n * flops, "e2e": {"train_step_ms": 1e3 * window_s / n}}

    def release(self) -> None:
        del self.state, self.step_fn
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------------------

    def reference_batches(self) -> list:
        dev, out = self.device, []
        n_mels = self.cfg["dims"]["n_mels"]
        for i in range(FIRST_STEPS):
            item = self.pool[i % len(self.pool)]
            frames_max = item["batch"]["input_ids"].shape[-1]
            mel = torch.zeros((len(item["items"]), n_mels, frames_max), device=dev)
            for r, it in enumerate(item["items"]):
                m = mel_ref.log_mel(torch.from_numpy(it["wav"]).to(dev)[None], n_mels)[0]
                mel[r, :, : m.shape[-1]] = m[:, :frames_max]
            out.append({
                "mel": mel, "frames": torch.as_tensor(item["frames"]),
                "draws": item["draws"], "n_freq_mask": self.preset["n_freq_mask"],
                "dec_input_ids": torch.as_tensor(item["batch"]["dec_input_ids"]).long().to(dev),
                "labels": torch.as_tensor(item["batch"]["labels"]).long().to(dev),
            })
        return out

    @torch.no_grad()
    def check(self, limits: dict) -> list:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        sd = common.whisper_state(self.cfg, self.seed, self.device)
        with torch.enable_grad():
            ref = train_ref.train_steps(sd, self.cfg["dims"], self.reference_batches(),
                                        self.cfg["train"])
            got = self.readings
            if self.control == "fp8":
                got = train_ref.train_steps(sd, self.cfg["dims"], self.reference_batches(),
                                            self.cfg["train"], lowp="fp8")
        del sd
        grads = ref["first_grad"]
        med = median(grads.values())
        self.kept = sum(g >= 1e-3 * med for g in grads.values())
        self.losses = {"program": got["losses"], "reference": ref["losses"]}
        self.numbers = compare(got, ref)
        return [(name, self.numbers[name], limit) for name, limit in limits.items()]

    def notes(self) -> dict:
        return {"parameters_compared": self.kept, "losses": self.losses, **self.numbers}


def leaf_gap(got: dict, ref: dict, keep) -> float:
    """The worst parameter's |norm - reference norm| over the larger of its
    reference norm and the median parameter's."""
    med = median(ref[n] for n in keep)
    return max(abs(got[n] - ref[n]) / max(ref[n], med) for n in keep)


def change_gap(got: dict, ref: dict, ref_norm: dict, keep) -> float:
    """The worst parameter's norm of (program's change - reference's) over
    the larger of its reference change's norm and the median parameter's."""
    med = median(ref_norm[n] for n in keep)
    return max(float((got[n].to(ref[n].device, torch.float64) - ref[n].double()).norm())
               / max(ref_norm[n], med) for n in keep)


def compare(got: dict, ref: dict) -> dict:
    grads = ref["first_grad"]
    med = median(grads.values())
    keep = [n for n in grads if grads[n] >= 1e-3 * med]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    return {
        "loss_gap": loss_gap,
        "grad_norm_gap": leaf_gap(got["first_grad"], grads, keep),
        "change_norm_gap": leaf_gap(got["change"], ref["change"], keep),
        "change_gap": change_gap(got["delta"], ref["delta"], ref["change"], keep),
    }
