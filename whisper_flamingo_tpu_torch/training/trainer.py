"""Training orchestration: loop, validation, checkpointing, resume.

Port of ``whisper_flamingo_tpu/training/trainer.py`` (the reference's
PyTorch-Lightning layer as a plain loop around the train step):

- a validate-before-train pass, as every reference script runs;
- periodic teacher-forced validation: loss, token accuracy, WER and CER
  per split over normalized text;
- top-k checkpoints on a monitored metric plus ``last`` for resume, as
  ``torch.save`` files holding the parameters, the optimizer state (Adam
  moments or Adafactor's factored statistics, the accumulation buffer),
  the schedule count, the step and the
  torch RNG states; a resumed run continues bit-identically;
- metrics to JSONL.

Under a mesh (``Trainer(mesh=...)``, one process per rank): every rank
reads the same global batch, runs the host hook on it and steps on its
rows (:func:`..parallel.mesh.shard_batch`, a ragged batch padded as the
JAX trainer's ``_device_batch``); :meth:`Trainer.fit` slices the model
and the optimizer (:meth:`Trainer.shard_state`); validation gathers the
ranks' predictions and drops the padded rows; checkpoints hold the
gathered full parameters and optimizer state, so they load on one device
or under another mesh, and only the primary rank writes them and the
metrics. Resume loads the full state before :meth:`Trainer.fit` shards
it, as in JAX.

Left out: wandb (the JSONL is the record). One change from the JAX loop:
a resumed :meth:`Trainer.fit` continues the data stream at the batch
after the checkpoint's step (the JAX loop restarted the epoch), so a
resumed run sees the batches an uninterrupted run would.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..config import TrainConfig
from ..metrics import token_accuracy, wer_cer
from ..models.dims import ModelDimensions
from ..normalizers import BasicTextNormalizer
from ..parallel.distributed import is_primary
from ..parallel.mesh import DATA_AXIS, gather_params, shard_batch, shard_params
from ..tokenizer import get_tokenizer
from .steps import TrainState


class MetricsLogger:
    """JSONL metric sink: one object per line with the step and the time.
    With ``write`` false (a rank other than the primary) it writes nothing."""

    def __init__(self, log_dir: str, run_id: str, write: bool = True):
        self.path = os.path.join(log_dir, f"{run_id}.metrics.jsonl")
        self._fh = None
        if write:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(self.path, "a")

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        if self._fh is None:
            return
        rec = {"step": int(step), "time": time.time(), **{
            k: (float(v) if isinstance(v, (int, float, np.floating, torch.Tensor)) else v)
            for k, v in metrics.items()
        }}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()


class CheckpointManager:
    """Top-k + last checkpointing of the full training state.

    ``step-XXXXXXXX.pt`` holds one save; ``last.pt`` is the newest (a hard
    link to it, so each save writes its bytes once); ``last.meta.json``
    keeps the top-k scores so pruning survives restarts.

    Under a mesh (a sharded model), :meth:`save` is a collective (every
    rank gathers the full parameters and optimizer state) and only the
    primary rank writes."""

    def __init__(self, directory: str, monitor: str = "val/loss", mode: str = "min",
                 save_top_k: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self._scores: List[tuple] = []  # (score, path)
        meta = os.path.join(self.directory, "last.meta.json")
        if os.path.exists(meta):  # restart: reload the top-k bookkeeping
            with open(meta) as f:
                for score, path in json.load(f).get("scores", []):
                    full = os.path.join(self.directory, path)
                    if os.path.exists(full):
                        self._scores.append((float(score), full))

    @staticmethod
    def _state_dict(state: TrainState) -> Dict[str, Any]:
        rng = {"cpu": torch.get_rng_state()}
        if torch.cuda.is_available():
            rng["cuda"] = torch.cuda.get_rng_state_all()
        sharded = getattr(state.model, "mesh", None) is not None
        return {
            "params": gather_params(state.model) if sharded else state.model.state_dict(),
            "opt_state": state.optimizer.full_state_dict(),
            "step": int(state.step),
            "rng": rng,
        }

    def _write_meta(self, step: int, metrics: Dict[str, float]) -> None:
        with open(os.path.join(self.directory, "last.meta.json"), "w") as f:
            json.dump({
                "step": step,
                "metrics": {k: float(v) for k, v in metrics.items()},
                "scores": [(s, os.path.basename(p)) for s, p in self._scores],
            }, f)

    def save(self, state: TrainState, metrics: Dict[str, float], step: int) -> None:
        score = float(metrics.get(self.monitor, np.nan))
        path = os.path.join(self.directory, f"step-{step:08d}.pt")
        last = os.path.join(self.directory, "last.pt")
        tmp = f"{path}.tmp"
        full = self._state_dict(state)
        if not is_primary():
            return
        torch.save(full, tmp)
        os.replace(tmp, path)
        os.link(path, f"{last}.tmp")
        os.replace(f"{last}.tmp", last)
        if not np.isnan(score):
            # re-saving the same step (val grid + final) updates in place
            self._scores = [(s, p) for s, p in self._scores if p != path]
            self._scores.append((score, path))
            self._scores.sort(key=lambda t: t[0], reverse=(self.mode == "max"))
            while len(self._scores) > self.save_top_k:
                _, worst = self._scores.pop()
                if os.path.exists(worst):
                    os.remove(worst)
        self._write_meta(step, metrics)

    def restore_last(self, template: TrainState) -> Optional[TrainState]:
        """Load ``last`` into ``template`` (a fresh state with the same
        model and optimizer configuration) and return it; ``None`` when
        there is no checkpoint. A checkpoint whose optimizer state does not
        fit the template raises. The template is whole (not yet sharded):
        checkpoints hold full tensors."""
        if getattr(template.model, "mesh", None) is not None:
            raise ValueError("restore_last: resume into the full state, then shard it")
        last = os.path.join(self.directory, "last.pt")
        if not os.path.exists(last):
            return None
        full = torch.load(last, map_location=template.model.device, weights_only=True)
        template.model.load_state_dict(full["params"])
        template.optimizer.load_state_dict(full["opt_state"])
        template.step = int(full["step"])
        torch.set_rng_state(full["rng"]["cpu"].cpu())
        if "cuda" in full["rng"] and torch.cuda.is_available():
            torch.cuda.set_rng_state_all([s.cpu() for s in full["rng"]["cuda"]])
        return template


@dataclass
class Trainer:
    """Drives a train step over a data iterable."""

    cfg: TrainConfig
    dims: ModelDimensions
    train_step: Callable  # (state, batch) -> (state, metrics)
    eval_step: Callable  # (model, batch) -> (loss, pred_tokens)
    prepare_batch: Optional[Callable] = None  # host hook (e.g. conditioning xt)
    mesh: Any = None  # parallel.mesh.Mesh: batches split over data, params over model
    logger: Optional[MetricsLogger] = None
    checkpoints: Optional[CheckpointManager] = None
    normalizer: Any = field(default_factory=lambda: BasicTextNormalizer(remove_diacritics=True))

    def __post_init__(self):
        if self.logger is None:
            self.logger = MetricsLogger(self.cfg.log_output_dir, self.cfg.train_id,
                                        write=is_primary())
        if self.checkpoints is None:
            self.checkpoints = CheckpointManager(
                os.path.join(self.cfg.check_output_dir, self.cfg.train_id),
                monitor=self.cfg.monitor,
                save_top_k=int(self.cfg.extras.get("save_top_k", 3)),
            )
        # the data pipeline's encoding: English-only models use the gpt2
        # vocabulary, large-v3 adds a 100th language
        multilingual = self.dims.is_multilingual
        self.tokenizer = get_tokenizer(
            multilingual,
            num_languages=self.dims.num_languages if multilingual else 99,
            language=self.cfg.lang if multilingual else None,
            task="transcribe" if multilingual else None,
        )

    # -- validation --------------------------------------------------------

    def validate(self, model, loaders: Dict[str, Iterable],
                 max_batches: Optional[int] = None) -> Dict[str, float]:
        """Teacher-forced eval over named splits; returns flat metrics:
        loss, post-EOT-masked token accuracy, WER and CER over normalized
        text."""
        out: Dict[str, float] = {}
        for split, loader in loaders.items():
            losses, accs, hyps, refs = [], [], [], []
            for i, batch in enumerate(loader):
                if max_batches is not None and i >= max_batches:
                    break
                if self.prepare_batch is not None:
                    batch = self.prepare_batch(batch)
                loss, preds = self.eval_step(model, self._rows(batch))
                losses.append(float(loss))
                labels = np.asarray(batch["labels"])
                preds = preds.cpu().numpy()
                if self.mesh is not None:
                    preds = np.concatenate(self.mesh.all_gather_object(preds, DATA_AXIS))
                preds = preds[: labels.shape[0]]  # drop the rows padded for the mesh
                accs.append(token_accuracy(preds, labels, eot=self.tokenizer.eot))
                for row_pred, row_label in zip(preds, labels):
                    mask = row_label != -100
                    hyp_tokens = [int(t) for t in row_pred[mask] if t != self.tokenizer.eot]
                    ref_tokens = [int(t) for t in row_label[mask] if t != self.tokenizer.eot]
                    hyps.append(self.normalizer(self.tokenizer.decode(hyp_tokens)))
                    refs.append(self.normalizer(self.tokenizer.decode(ref_tokens)))
            if not losses:
                continue
            if self.cfg.extras.get("print_samples"):
                for h, r in list(zip(hyps, refs))[:4]:
                    print(f"[{split}] PRED: {h}\n[{split}]  REF: {r}")
            wer, cer = wer_cer(hyps, refs)
            out[f"{split}/loss"] = float(np.mean(losses))
            out[f"{split}/acc"] = float(np.mean(accs))
            out[f"{split}/wer"] = wer
            out[f"{split}/cer"] = cer
        return out

    def _rows(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of a global batch (the batch itself with no mesh)."""
        return batch if self.mesh is None else shard_batch(batch, self.mesh)

    def shard_state(self, state: TrainState) -> TrainState:
        """Slice the model and its optimizer state onto the mesh, in place
        (the state itself with no mesh, or when sharded already)."""
        if self.mesh is None or getattr(state.model, "mesh", None) is self.mesh:
            return state
        shard_params(state.model, self.mesh)
        state.optimizer.shard(self.mesh, state.model.tp_dims)
        return state

    # -- training loop -----------------------------------------------------

    def fit(
        self,
        state: TrainState,
        train_loader: Iterable,
        val_loaders: Optional[Dict[str, Iterable]] = None,
        max_steps: Optional[int] = None,
        val_max_batches: Optional[int] = None,
        log_every: int = 50,
    ) -> TrainState:
        cfg = self.cfg
        max_steps = max_steps or cfg.num_train_steps
        val_every = cfg.validate_every_n_batches
        state = self.shard_state(state)

        if val_loaders:  # validate-before-train pass
            metrics = self.validate(state.model, val_loaders, val_max_batches)
            self.logger.log(state.step, {"phase": "preval", **metrics})

        t0 = time.time()
        window_tokens = 0
        it = iter(_cycle(train_loader, start=state.step))
        while state.step < max_steps:
            batch = next(it)
            if self.prepare_batch is not None:
                batch = self.prepare_batch(batch)
            window_tokens += int(np.prod(np.shape(batch["dec_input_ids"])))
            state, metrics = self.train_step(state, self._rows(batch))
            step = state.step
            if step % log_every == 0:
                dt = time.time() - t0
                self.logger.log(step, {
                    **{k: float(v) for k, v in metrics.items()},
                    "tokens_per_sec": window_tokens / max(dt, 1e-9),
                })
                t0, window_tokens = time.time(), 0
            if val_loaders and val_every and step % val_every == 0:
                vmetrics = self.validate(state.model, val_loaders, val_max_batches)
                self.logger.log(step, vmetrics)
                self.checkpoints.save(state, vmetrics, step)

        # final validation + checkpoint (the loop may end off the val grid)
        final_metrics: Dict[str, float] = {}
        if val_loaders:
            final_metrics = self.validate(state.model, val_loaders, val_max_batches)
            self.logger.log(state.step, {"phase": "final", **final_metrics})
        self.checkpoints.save(state, final_metrics, state.step)
        return state

    def maybe_resume(self, state: TrainState) -> TrainState:
        """Resume from ``last`` when the config asks for it: parameters,
        optimizer state, schedule position and step."""
        if not self.cfg.resume_training:
            return state
        restored = self.checkpoints.restore_last(state)
        return state if restored is None else restored


def _cycle(loader: Iterable, start: int = 0):
    """Batches over epochs, from batch ``start`` of the stream (epoch
    ``start // len(loader)``); ``set_epoch`` before each epoch."""
    n = len(loader)
    epoch, skip = divmod(start, n)
    while True:
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)
        for i, item in enumerate(loader):
            if i >= skip:
                yield item
        skip = 0
        epoch += 1
