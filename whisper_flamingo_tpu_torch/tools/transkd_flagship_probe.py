"""TransKD at flagship scale on one card: step time, memory and the
optimizer's state bytes of a teacher-student pair.

Port of the JAX package's ``tools/transkd_flagship_probe.py``. The teacher
is always the gated (Flamingo) model (one conditioning stream of 64
positions at ``bert_dim`` 768), every weight bf16 and frozen; the student
is a plain Whisper whose encoder is frozen in bf16 (it reuses the
teacher's encoder output when the widths match, ``share_teacher_features``)
and whose decoder trains in fp32 masters. One step is ``make_kd_train_step``
in bf16 with ``remat="full"`` on a batch of 30 s mels and 128 tokens,
random weights from seeds and a random batch from numpy seed 0.

    python -m whisper_flamingo_tpu_torch.tools.transkd_flagship_probe
    python -m whisper_flamingo_tpu_torch.tools.transkd_flagship_probe \\
        <teacher> <student> <batch> [adamw|adafactor] [--steps N] [--warmup N] [--device cpu]

With no arguments it runs :data:`LADDER`, each rung in its own subprocess
(an out-of-memory rung must not fragment the allocator for the next) and
prints one line per rung. With a rung it runs :func:`run_config` in this
process and prints ``OK`` and its JSON: ms per step, the resident bytes
(parameters, optimizer state and batch) and the peak device memory in GB,
the optimizer's state bytes and its time a step (``optimizer_ms``), the
flash64 forward launches per step,
the losses, and whether the teacher and the student's encoder kept their
bits. The card is the default device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

LADDER = [
    ("small", "small", 8, "adamw"),  # the reference's own protocol
    ("large-v2", "medium", 4, "adamw"),
    ("large-v2", "large-v2", 2, "adafactor"),
]
XT_LEN, BERT_DIM, TOKENS = 64, 768, 128


def _snapshot(model, names) -> Dict[str, torch.Tensor]:
    params = dict(model.named_parameters())
    return {n: params[n].detach().to("cpu", copy=True) for n in names}


def _unchanged(model, snap: Dict[str, torch.Tensor]) -> bool:
    params = dict(model.named_parameters())
    return all(torch.equal(params[n].detach().cpu(), t) for n, t in snap.items())


def run_config(teacher_name: str, student_name: str, batch: int, optimizer: str = "adamw",
               *, steps: int = 6, warmup: int = 1, device: Optional[str] = None
               ) -> Dict[str, Any]:
    """One rung: ``warmup`` steps, then ``steps`` timed steps."""
    from .. import load_model
    from ..ops import flash64
    from ..training.optim import encoder_frozen_mask, whisper_optimizer
    from ..training.steps import TrainState, cast_frozen_bf16, make_kd_train_step
    from ..utils import resolve_device

    dev = resolve_device(device)
    teacher = load_model(teacher_name, device=dev, seed=0, add_gated_x_attn=1, num_langs=1,
                         bert_dim=BERT_DIM)
    cast_frozen_bf16(teacher, {n: False for n, _ in teacher.named_parameters()})
    student = load_model(student_name, device=dev, seed=1)
    frozen_enc = encoder_frozen_mask(student)
    cast_frozen_bf16(student, frozen_enc)
    tdims, sdims = teacher.dims, student.dims
    share = tdims.n_audio_state == sdims.n_audio_state
    tx, _ = whisper_optimizer(student, 1e-5, total_steps=1000, trainable_mask=frozen_enc,
                              optimizer=optimizer)
    step = make_kd_train_step(sdims, teacher_dims=tdims, freeze_student_encoder=True,
                              share_teacher_features=share, dtype=torch.bfloat16, remat="full")
    rng = np.random.default_rng(0)
    arrays = {
        "input_ids": torch.from_numpy(
            rng.standard_normal((batch, tdims.n_mels, 3000)).astype(np.float32)),
        "dec_input_ids": torch.from_numpy(rng.integers(0, 1000, (batch, TOKENS)).astype(np.int64)),
        "labels": torch.from_numpy(rng.integers(0, 1000, (batch, TOKENS)).astype(np.int64)),
        "xt": torch.from_numpy(
            rng.standard_normal((1, batch, XT_LEN, BERT_DIM)).astype(np.float32)
        ).to(torch.bfloat16),
    }
    arrays = {k: v.to(dev) for k, v in arrays.items()}
    frozen_names = [n for n, _ in student.named_parameters() if not frozen_enc[n]]
    teacher_snap = _snapshot(teacher, [n for n, _ in teacher.named_parameters()])
    student_snap = _snapshot(student, frozen_names)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # the optimizer's time a step: on the card the span between CUDA events
    # around ``tx.step()`` (from the end of the backward on the device's
    # timeline to the end of the update, host gaps included), on the CPU
    # the host clock
    spans: List[Any] = []
    inner_step = tx.step

    def timed_step() -> bool:
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            applied = inner_step()
            end.record()
            spans.append((start, end))
        else:
            t0 = time.perf_counter()
            applied = inner_step()
            spans.append((time.perf_counter() - t0) * 1e3)
        return applied

    tx.step = timed_step
    state = TrainState.create(student, tx)
    losses = []
    for _ in range(warmup):
        state, m = step(state, teacher, arrays)
        losses.append(float(m["loss"]))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = flash64.flash64_forward.launches
    sync()
    spans.clear()  # the warmup's
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, teacher, arrays)
        losses.append(float(m["loss"]))  # reads the loss: waits for the step
    sync()
    ms = (time.perf_counter() - t0) / steps * 1e3
    opt_ms = [s.elapsed_time(e) for s, e in spans] if cuda else spans
    launches = (flash64.flash64_forward.launches - launches0) / steps
    state_bytes = tx.state_bytes()
    resident = (sum(p.numel() * p.element_size() for m_ in (student, teacher)
                    for p in m_.parameters())
                + state_bytes + sum(v.numel() * v.element_size() for v in arrays.values()))
    return {
        "teacher": teacher_name, "student": student_name, "batch": batch,
        "optimizer": optimizer, "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "step_ms": ms, "steps": steps, "warmup": warmup,
        "resident_gb": resident / 2**30,
        "peak_gb": torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None,
        "optimizer_state_bytes": state_bytes,
        "optimizer_ms": float(np.median(opt_ms)), "optimizer_ms_all": opt_ms,
        "trainable_params": sum(p.numel() for p in tx.params),
        "flash64_fwd_launches_per_step": launches,
        "flash64_shape": [batch * tdims.n_audio_head, tdims.n_audio_ctx, 64],
        "share_feats": share, "losses": losses,
        "losses_finite": bool(np.all(np.isfinite(losses))),
        "teacher_unchanged": _unchanged(teacher, teacher_snap),
        "student_encoder_unchanged": _unchanged(student, student_snap),
    }


def run_subprocess(teacher: str, student: str, batch: int, optimizer: str,
                   extra: List[str] = (), timeout: float = 2400.0) -> Dict[str, Any]:
    """One rung in a fresh process: its result, or ``{"error": ...}``."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, *filter(None, [os.environ.get("PYTHONPATH")])]))
    cmd = [sys.executable, "-m", "whisper_flamingo_tpu_torch.tools.transkd_flagship_probe",
           teacher, student, str(batch), optimizer, *extra]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env,
                           cwd=root)
    except subprocess.TimeoutExpired:
        return {"error": f"timeout after {timeout} s"}
    ok = [line for line in r.stdout.splitlines() if line.startswith("OK ")]
    if r.returncode == 0 and ok:
        return json.loads(ok[-1][3:])
    tail = (r.stderr or r.stdout).strip().splitlines()
    err = next((line for line in reversed(tail) if "OutOfMemory" in line or "Error" in line),
               tail[-1] if tail else "no output")
    return {"error": err[:300]}


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("teacher", nargs="?")
    parser.add_argument("student", nargs="?")
    parser.add_argument("batch", nargs="?", type=int)
    parser.add_argument("optimizer", nargs="?", default="adamw")
    parser.add_argument("--steps", type=int, default=6)
    parser.add_argument("--warmup", type=int, default=1)
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    if args.teacher is not None:
        res = run_config(args.teacher, args.student, args.batch, args.optimizer,
                         steps=args.steps, warmup=args.warmup, device=args.device)
        print("OK " + json.dumps(res), flush=True)
        return [res]
    extra = [f"--steps={args.steps}", f"--warmup={args.warmup}"]
    if args.device:
        extra.append(f"--device={args.device}")
    out = []
    for teacher, student, batch, opt in LADDER:
        res = run_subprocess(teacher, student, batch, opt, extra)
        name = f"teacher={teacher}(gated,bf16) student={student} b{batch} {opt}"
        if "error" in res:
            print(f"{name}: FAILED ({res['error']})", flush=True)
        else:
            print(f"{name}: OK step={res['step_ms']:.0f} ms resident={res['resident_gb']:.2f} GB "
                  f"peak={res['peak_gb']} GB state={res['optimizer_state_bytes']} B "
                  f"optimizer={res['optimizer_ms']:.1f} ms "
                  f"share_feats={res['share_feats']}", flush=True)
        out.append(dict(res, rung=[teacher, student, batch, opt]))
    return out


if __name__ == "__main__":
    main()
