"""Data-parallel fine-tuning across the cards of one host: ``finetune``'s job
(``training/steps.make_ce_train_step``, AdamW, ``WhisperCollator`` batches,
SpecAugment on the device) with one process a rank and one card each,
joined by ``parallel/distributed`` (NCCL when each rank has a card of its
own, ``pick_backend``) under a data mesh: ``parallel/mesh.make_mesh``,
``shard_params`` and ``WhisperOptimizer.shard``, as ``Trainer.fit`` sets a
run up. Each step averages the ranks' gradients in one flat all-reduce;
the loss is the global masked mean.

Traffic keys: ``ranks`` (the cards), and on each rank ``finetune``'s keys:
``pool`` batches of ``batch`` clips, made from the cell's seed and the
rank, so the global batch is ``ranks`` x ``batch``. The weights are the
seed's, the same on every rank.

This process is rank 0 and measures; the other ranks are processes of
``distributed.start``. Every rank sets up (its batches, the model, the
mesh, the first three steps); rank 0 keeps the readings of the first three
steps as ``finetune`` does. Before each step of the window rank 0 tells the
others, over a gloo group of the host, whether there is one, so every rank
runs the same steps; ``train_step_ms`` is rank 0's window over its steps.
The process group and the control group carry a timeout, and the ranks'
join a deadline: a rank that fails or hangs ends the run with an error.

The check replays the first three steps with the plain reference on the
global batch (``reference.av_train_ref``: each rank's batch a chunk, as
its collator padded it; the loss the masked mean over all of them) and
compares as ``finetune`` does. In traced runs (rank 0 only) the generator
opens the range ``allreduce`` around every collective of the mesh
(``Mesh.all_reduce``: the gradient average, the label count, the loss) and
installs the program's span sink over the window: the window's
``train.allreduce_bytes`` goes to the notes.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import time
from statistics import median

import torch
import torch.distributed as dist

from .. import flops as F
from ..reference import av_train_ref, train_ref
from ..trace import Recorder
from . import common, finetune

TIMEOUT_S = 300.0  # the process group's set-up and each collective
JOIN_S = 120.0  # the other ranks' exit after the window
FIRST_STEPS = finetune.FIRST_STEPS
ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def rank_seed(seed: int, rank: int) -> int:
    """The seed of a rank's batches: distinct for every rank and cell seed."""
    return int(seed) * 8 + rank


class Rank:
    """One rank's share: ``finetune``'s batches and step under the data mesh."""

    def __init__(self, cfg, traffic, seed, rank, world, rec, device):
        self.cfg, self.seed, self.rank, self.world = cfg, int(seed), rank, world
        self.ft = finetune.Driver(cfg, traffic, rank_seed(seed, rank), rec, device)

    def setup(self) -> None:
        from whisper_flamingo_tpu_torch.models.dims import ModelDimensions
        from whisper_flamingo_tpu_torch.parallel.mesh import make_mesh, shard_params
        from whisper_flamingo_tpu_torch.training.optim import whisper_optimizer
        from whisper_flamingo_tpu_torch.training.steps import TrainState, make_ce_train_step

        ft, cfg, tr = self.ft, self.cfg, self.cfg["train"]
        self.control = dist.new_group(backend="gloo",
                                      timeout=datetime.timedelta(seconds=TIMEOUT_S))
        mesh = make_mesh(self.world, 1)
        ft.pool = ft._batches()
        model = common.build_whisper(cfg, self.seed, ft.device)
        tx, _ = whisper_optimizer(model, tr["learning_rate"], weight_decay=tr["weight_decay"],
                                  adam_epsilon=tr["adam_epsilon"],
                                  warmup_steps=tr["warmup_steps"],
                                  total_steps=tr["num_train_steps"])
        shard_params(model, mesh)
        tx.shard(mesh, model.tp_dims)
        ft.state = TrainState.create(model, tx)
        ft.step_fn = make_ce_train_step(ModelDimensions(**cfg["dims"]), dtype=ft.dtype,
                                        remat=tr["remat"])
        self.readings = {"losses": []}
        for i in range(FIRST_STEPS):
            self.readings["losses"].append(float(ft._step(i)["loss"]))
            if i == 0 and self.rank == 0:
                self.readings["first_grad"] = {
                    n: float(m.double().norm()) / (1 - tx.b1) for n, m in zip(tx.names, tx.mu)}
        if self.rank == 0:
            start = common.whisper_state(cfg, self.seed, ft.device)
            delta = {n: p.detach() - start[n] for n, p in model.named_parameters()}
            self.readings["change"] = {n: float(d.double().norm()) for n, d in delta.items()}
            self.readings["delta"] = {n: d.cpu() for n, d in delta.items()}
            del start, delta
        common.sync(ft.device)
        dist.barrier(group=self.control)

    def go(self, more: bool) -> bool:
        """Rank 0's word on whether another step runs, on every rank."""
        flag = torch.tensor([int(more)])
        dist.broadcast(flag, src=0, group=self.control)
        return bool(flag.item())

    def follow(self) -> int:
        """A rank other than 0: the window's steps, as many as rank 0 runs."""
        n = 0
        while self.go(False):
            self.ft._step(FIRST_STEPS + n)
            n += 1
        common.sync(self.ft.device)
        return n


def _other_rank(rank: int, device, cfg, traffic, seed, world) -> int:
    """A spawned rank's whole run; returns its window's steps."""
    r = Rank(cfg, traffic, seed, rank, world, Recorder(False, device), device)
    r.setup()
    return r.follow()


class Driver:
    def __init__(self, cfg, traffic, seed, rec, device, control=False, seconds=0.0, units=0):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.rec, self.device, self.control = rec, torch.device(device), control
        self.seconds, self.units = seconds, units
        self.world = int(traffic["ranks"])

    def setup(self) -> None:
        from whisper_flamingo_tpu_torch.parallel import distributed

        kind = self.device.type
        self.env = {k: os.environ.get(k) for k in ENV}
        self.others = distributed.start(
            _other_rank, self.world, (self.cfg, self.traffic, self.seed, self.world),
            device=kind, threads=1 if kind == "cpu" else 0, ranks=range(1, self.world),
            timeout_s=TIMEOUT_S)
        try:
            dev = distributed.join_local(0, self.world, self.others.port, kind, TIMEOUT_S)
            self.device = dev
            self.rank = Rank(self.cfg, self.traffic, self.seed, 0, self.world, self.rec, dev)
            self.rank.setup()
        except BaseException:
            self._close()
            raise

    def _close(self) -> None:
        from whisper_flamingo_tpu_torch.parallel import distributed

        try:
            distributed.shutdown()
        finally:
            self.others.stop()
            for k, v in self.env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    # -- the window ------------------------------------------------------------------

    @contextlib.contextmanager
    def _allreduce_range(self):
        """``allreduce`` around the mesh's collectives, in traced runs."""
        if not self.rec.traced:
            yield
            return
        from whisper_flamingo_tpu_torch.parallel.mesh import Mesh

        orig = Mesh.all_reduce

        def wrapped(mesh, *args, **kwargs):
            with self.rec.range("allreduce"):
                return orig(mesh, *args, **kwargs)

        Mesh.all_reduce = wrapped
        try:
            yield
        finally:
            Mesh.all_reduce = orig

    def run_window(self) -> dict:
        from whisper_flamingo_tpu_torch import profiling

        from ..instrument import instrument

        rec, seconds, units, r = self.rec, self.seconds, self.units, self.rank
        sink = profiling.collect() if rec.traced else contextlib.nullcontext()
        n = 0
        with instrument(rec), self._allreduce_range(), sink as spans, rec.profiling():
            t0 = time.perf_counter()
            with rec.range("window"):
                while r.go(True):
                    r.ft._step(FIRST_STEPS + n)
                    n += 1
                    elapsed = time.perf_counter() - t0
                    if (units and n >= units) or (not units and elapsed >= seconds):
                        break
                r.go(False)
                common.sync(self.device)
            window_s = time.perf_counter() - t0
        self.steps = n
        batch = r.ft.pool[0]["batch"]
        flops = 3 * F.model_flops(self.cfg["dims"], batch["input_ids"].shape[0],
                                  batch["input_ids"].shape[-1], batch["dec_input_ids"].shape[-1])
        stats = {"window_s": window_s, "units": n, "attempted": n, "failed": 0,
                 "flops": n * flops, "e2e": {"train_step_ms": 1e3 * window_s / n}}
        # the span report's recorder keeps the program's counters when it
        # shadows this sink
        counters = getattr(rec, "counters", None) or (spans.counters if spans else {})
        if counters:
            stats["notes"] = {"train.allreduce_bytes": counters.get("train.allreduce_bytes", 0)}
        return stats

    def release(self) -> None:
        """The other ranks' exit (each ran rank 0's steps), then the group's."""
        ft = self.rank.ft
        del ft.state, ft.step_fn
        try:
            steps = self.others.join(JOIN_S)
        finally:
            self._close()
        steps[0] = self.steps
        if len(set(steps.values())) > 1:
            raise RuntimeError(f"the ranks ran different numbers of steps: {steps}")
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------------------

    def reference_steps(self) -> list:
        """The first three steps' global batches: each rank's batch, made
        again from its seed, one chunk."""
        ranks = [self.rank.ft]
        for rank in range(1, self.world):
            ft = finetune.Driver(self.cfg, self.traffic, rank_seed(self.seed, rank),
                                 self.rec, self.device)
            ft.pool = ft._batches()
            ranks.append(ft)
        per_rank = [ft.reference_batches() for ft in ranks]
        return [list(chunks) for chunks in zip(*per_rank)]

    @torch.no_grad()
    def check(self, limits: dict) -> list:
        cfg, tr = self.cfg, self.cfg["train"]
        sd = common.whisper_state(cfg, self.seed, self.device)
        steps = self.reference_steps()

        def run(lowp=None):
            return av_train_ref.train_steps(sd, cfg["dims"], steps, tr, lambda n: True,
                                            train_ref.decays, lowp=lowp)

        with torch.enable_grad():
            ref = run()
            got = run("fp8") if self.control == "fp8" else self.rank.readings
        del sd, steps
        grads = ref["first_grad"]
        med = median(grads.values())
        self.kept = sum(g >= 1e-3 * med for g in grads.values())
        self.losses = {"program": got["losses"], "reference": ref["losses"]}
        self.numbers = finetune.compare(got, ref)
        return [(name, self.numbers[name], limit) for name, limit in limits.items()]

    def notes(self) -> dict:
        return {"parameters_compared": self.kept, "losses": self.losses, "ranks": self.world,
                **self.numbers}
