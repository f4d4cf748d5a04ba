"""The multi-rank dry run: the port's counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``.

:func:`dryrun_multichip` spawns ``n`` ranks (gloo; on the CPU, or sharing
the card) on an (n/2 x 2) mesh (n x 1 below 4 ranks) and runs the JAX legs,
on their dims and batches, each held against the same computation on one
rank with no mesh:

- ``_leg_train``: one Flamingo fine-tune step (gated x-attn, ``xt``
  conditioning, AdamW), loss to rtol 1e-4;
- ``_leg_beam_decode``: beam-3 decode on the ``debug`` dims, tokens equal
  and ``avg_logprob`` within 1e-3;
- ``_leg_kd_train``: one TransKD step (teacher and student sharded), loss
  to rtol 1e-4;
- ``_leg_int8_decode``: int8 greedy decode on the ``debug`` dims
  (the JAX test ``test_int8_decode_under_dp_tp_mesh``'s case), tokens
  equal.

Every rank checks its own legs and any failure fails the run. Run it as
``python -m whisper_flamingo_tpu_torch.parallel.dryrun [n] [--device cpu]``
(the card unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch

from .distributed import spawn
from .mesh import make_mesh, shard_batch, shard_params

FT_DIMS = dict(n_mels=80, n_audio_ctx=64, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
               n_vocab=51865, n_text_ctx=448, n_text_head=2, n_text_state=64, n_text_layer=2)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _leg_train(mesh, device) -> str:
    from ..models.dims import ModelDimensions
    from ..models.whisper import ModelExtras, init_params
    from ..training.optim import whisper_flamingo_optimizer
    from ..training.steps import TrainState, make_ce_train_step

    dims = ModelDimensions(**FT_DIMS)
    extras = ModelExtras(add_gated_x_attn=1, num_langs=1, bert_dim=96)
    rng = np.random.default_rng(0)
    b = max(mesh.n_data, 2)
    batch = {
        "input_ids": rng.standard_normal((b, 80, 128)).astype(np.float32),
        "dec_input_ids": rng.integers(0, 1000, (b, 8)).astype(np.int32),
        "labels": rng.integers(0, 1000, (b, 8)).astype(np.int32),
        "xt": rng.standard_normal((1, b, 6, 96)).astype(np.float32),
    }
    step = make_ce_train_step(dims, use_xt=True, dtype=torch.float32, remat=False)
    losses = []
    for sharded in (False, True):
        model = init_params(_generator(device, 0), dims, extras, device=device)
        tx, _ = whisper_flamingo_optimizer(model, 1e-4, total_steps=10)
        rows = batch
        if sharded:
            shard_params(model, mesh)
            tx.shard(mesh, model.tp_dims)
            rows = shard_batch(batch, mesh)
        _, metrics = step(TrainState.create(model, tx), rows)
        losses.append(float(metrics["loss"]))
    single, loss = losses
    if not np.isfinite(loss):
        raise AssertionError(f"train leg produced non-finite loss {loss}")
    np.testing.assert_allclose(loss, single, rtol=1e-4)
    return f"train loss={loss:.4f} (single-device match rtol=1e-4)"


def _decode(mesh, device, opts, mel) -> List:
    from ..decoding import DecodingTask
    from ..models.dims import MODEL_DIMS
    from ..models.whisper import init_params

    out = []
    for sharded in (False, True):
        model = init_params(_generator(device, 0), MODEL_DIMS["debug"], device=device)
        if sharded:
            shard_params(model, mesh)
        out.append(DecodingTask(model, opts).run(mel))
    return out


def _leg_beam_decode(mesh, device) -> str:
    from ..decoding import DecodingOptions

    rng = np.random.default_rng(0)
    mel = rng.standard_normal((max(mesh.n_data, 2), 80, 3000)).astype(np.float32) * 0.3
    opts = DecodingOptions(language="en", fp16=False, beam_size=3, sample_len=6,
                           without_timestamps=True)
    base, got = _decode(mesh, device, opts, mel)
    for b, g in zip(base, got):
        assert g.tokens == b.tokens, (b.tokens, g.tokens)
        assert abs(g.avg_logprob - b.avg_logprob) < 1e-3, (b.avg_logprob, g.avg_logprob)
    return f"beam-3 decode tokens identical across {len(base)} rows"


def _leg_kd_train(mesh, device) -> str:
    from ..models.dims import ModelDimensions
    from ..models.whisper import init_params
    from ..training.optim import whisper_flamingo_optimizer
    from ..training.steps import TrainState, make_kd_train_step

    dims = ModelDimensions(**FT_DIMS)
    rng = np.random.default_rng(1)
    b = max(mesh.n_data, 2)
    batch = {
        "input_ids": rng.standard_normal((b, 80, 128)).astype(np.float32),
        "dec_input_ids": rng.integers(0, 1000, (b, 8)).astype(np.int32),
        "labels": rng.integers(0, 1000, (b, 8)).astype(np.int32),
    }
    step = make_kd_train_step(dims, teacher_uses_xt=False, dtype=torch.float32, remat=False)
    losses = []
    for sharded in (False, True):
        student = init_params(_generator(device, 1), dims, device=device)
        teacher = init_params(_generator(device, 2), dims, device=device)
        tx, _ = whisper_flamingo_optimizer(student, 1e-4, total_steps=10)
        rows = batch
        if sharded:
            shard_params(student, mesh)
            shard_params(teacher, mesh)
            tx.shard(mesh, student.tp_dims)
            rows = shard_batch(batch, mesh)
        _, metrics = step(TrainState.create(student, tx), teacher, rows)
        losses.append(float(metrics["loss"]))
    single, loss = losses
    if not np.isfinite(loss):
        raise AssertionError(f"KD leg produced non-finite loss {loss}")
    np.testing.assert_allclose(loss, single, rtol=1e-4)
    return f"kd loss={loss:.4f} (single-device match rtol=1e-4)"


def _leg_int8_decode(mesh, device) -> str:
    from ..decoding import DecodingOptions

    rng = np.random.default_rng(7)
    mel = rng.standard_normal((4, 80, 3000)).astype(np.float32) * 0.3
    opts = DecodingOptions(language="en", fp16=False, sample_len=8, without_timestamps=True,
                           quantize="int8")
    base, got = _decode(mesh, device, opts, mel)
    for b, g in zip(base, got):
        assert g.tokens == b.tokens, (b.tokens, g.tokens)
    return f"int8 greedy decode tokens identical across {len(base)} rows"


LEGS = (_leg_train, _leg_beam_decode, _leg_kd_train, _leg_int8_decode)


def _rank(rank: int, device: torch.device, n_data: int, n_model: int) -> List[str]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(n_data, n_model)
    return [f"{leg.__name__}: {leg(mesh, device)}" for leg in LEGS]


def dryrun_multichip(n_devices: int, device: str = "cuda") -> str:
    """Run the legs on ``n_devices`` ranks (gloo, all on the CPU with
    ``device="cpu"``, else sharing the card); prints and returns the
    ``dryrun_multichip ok`` line. Raises when a rank fails a leg."""
    n_model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    n_data = n_devices // n_model
    results = spawn(_rank, n_devices, (n_data, n_model), device=device)
    if any(r != results[0] for r in results):
        raise AssertionError(f"ranks disagree: {results}")
    line = f"dryrun_multichip ok: mesh=({n_data}x{n_model}); " + "; ".join(results[0])
    print(line, flush=True)
    return line


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", nargs="?", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n, device=args.device)


if __name__ == "__main__":
    main()
