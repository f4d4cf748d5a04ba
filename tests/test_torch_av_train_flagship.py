"""Whisper-Flamingo step-2 training and the data-parallel fine-tuning step
against the benchmark's plain reference (``perfbench/reference/
av_train_ref.py``), on the CPU at a small size, on the benchmark's seeded
weights.

The trunk is the ``debug`` one (the published ResNet-18 front end, a
64-wide transformer), the Whisper a gated one of width 128, so that its
``xt_projection`` (64 -> 128) runs. ``make_av_train_step`` runs three fp32
steps in each modality (both streams, audio only, video only) through
``whisper_flamingo_optimizer``; the reference runs the same three steps.
The learning rate is 1e-3 with no warm-up, so that a step moves each
parameter far above its fp32 rounding (the cell's warm-up would move it by
about one unit in the last place). Tolerances, with the numbers of
``perfbench/drivers/finetune.compare``:

- ``loss_gap`` (each step's loss, relative) 1e-5: fp32 against fp32 reads
  ~1e-6 (other summation orders: the port scales q and k by d^-1/4, the
  reference by 1/sqrt(d) at once; other convolution algorithms), a bf16
  step ~1e-4;
- ``grad_norm_gap`` (each gated parameter's first gradient norm, against
  its own or the median norm) 1e-4: fp32 reads ~4e-7, bf16 ~9e-3;
- ``change_norm_gap`` 1e-3 and ``change_gap`` 1e-2 (each gated
  parameter's change after three steps, by norm and as a vector): Adam
  divides each gradient by its running RMS, which magnifies the relative
  error of the elements whose gradient is smallest; fp32 reads ~1e-5 and
  ~4e-4, bf16 ~8e-3 and ~0.1.

A bf16 step (the frozen Whisper and trunk cast to bf16, as the recipe
casts them) is shown to fail them. The frozen parameters and statistics
stay bit-equal; the step's counters count its modality draws.

The data-parallel cell's driver runs its step on 4 gloo ranks against the
reference's global-batch step (each rank's batch one chunk, the masked
mean over all), with the same fp32 tolerances.
"""

import copy
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import spec  # noqa: E402
from perfbench.drivers import av_decode, av_train, common, finetune  # noqa: E402
from perfbench.reference import av_train_ref  # noqa: E402

from whisper_flamingo_tpu_torch import profiling  # noqa: E402
from whisper_flamingo_tpu_torch.models import avhubert  # noqa: E402
from whisper_flamingo_tpu_torch.models.dims import ModelDimensions  # noqa: E402
from whisper_flamingo_tpu_torch.recipes.av_train import cast_video_bf16  # noqa: E402
from whisper_flamingo_tpu_torch.training.optim import (  # noqa: E402
    flamingo_trainable_mask,
    whisper_flamingo_optimizer,
)
from whisper_flamingo_tpu_torch.training.steps import (  # noqa: E402
    TrainState,
    cast_frozen_bf16,
    make_av_train_step,
)

SEED = 2 ** 31 + 23
TOL = {"loss_gap": 1e-5, "grad_norm_gap": 1e-4, "change_norm_gap": 1e-3, "change_gap": 1e-2}
DIMS = {"n_mels": 80, "n_audio_ctx": 1500, "n_audio_state": 128, "n_audio_head": 2,
        "n_audio_layer": 2, "n_vocab": 51865, "n_text_ctx": 448, "n_text_head": 2,
        "n_text_state": 128, "n_text_layer": 2}
TRUNK_CFG = avhubert.VIDEO_ENCODER_CONFIGS["debug"]
TRUNK = {"embed_dim": TRUNK_CFG.embed_dim, "n_layers": TRUNK_CFG.n_layers,
         "n_heads": TRUNK_CFG.n_heads, "ffn_dim": TRUNK_CFG.ffn_dim,
         "conv_pos": TRUNK_CFG.conv_pos, "conv_pos_groups": TRUNK_CFG.conv_pos_groups,
         "frontend_dim": TRUNK_CFG.frontend_dim}
TRAIN = {"learning_rate": 1e-3, "weight_decay": 0.01, "adam_epsilon": 1e-8,
         "warmup_steps": 0, "num_train_steps": 100, "prob_av": 0.5, "prob_a": 0.25}
ROWS, FRAMES, TOKENS, VIDEO, SIDE = 3, 200, 16, 50, 24
INIT = [50258, 50259, 50359, 50363]


def _config(dtype="float32"):
    cfg = copy.deepcopy(spec.config("flamingo-large-av-step2"))
    cfg.update(dims=dict(DIMS), trunk=dict(TRUNK), dtype=dtype,
               extras=dict(cfg["extras"], bert_dim=TRUNK_CFG.embed_dim))
    return cfg


def _batch():
    g = torch.Generator().manual_seed(SEED)
    text = torch.randint(0, 50257, (ROWS, TOKENS - len(INIT)), generator=g)
    dec = torch.cat([torch.tensor([INIT] * ROWS), text], 1)
    labels = torch.cat([dec[:, 1:], torch.full((ROWS, 1), 50257)], 1)
    labels[0, -5:] = -100  # a shorter target
    return {"input_ids": torch.randn((ROWS, 80, FRAMES), generator=g) * 0.5,
            "dec_input_ids": dec, "labels": labels,
            "video": torch.randn((ROWS, VIDEO, SIDE, SIDE), generator=g),
            "video_lens": torch.full((ROWS,), VIDEO)}


def _generator(mode):
    """A draw generator whose first three draws are all ``mode``."""
    for s in range(10_000):
        g = torch.Generator().manual_seed(s)
        if all(av_train.mode_of(float(torch.rand((), generator=g)), TRAIN) == mode
               for _ in range(3)):
            return torch.Generator().manual_seed(s)
    raise AssertionError(mode)


def _program(mode, dtype=torch.float32):
    """Three steps of the port in ``mode``; returns the readings, the
    models and the span sink."""
    cfg = _config()
    model = common.build_whisper(cfg, SEED, "cpu")
    video = av_train.build_trunk(cfg, SEED, "cpu")
    if dtype == torch.bfloat16:
        cast_frozen_bf16(model, flamingo_trainable_mask(model))
        cast_video_bf16(video)
    tx, _ = whisper_flamingo_optimizer(model, TRAIN["learning_rate"],
                                       weight_decay=TRAIN["weight_decay"],
                                       warmup_steps=0, total_steps=TRAIN["num_train_steps"])
    step = make_av_train_step(ModelDimensions(**DIMS), dtype=dtype, remat="full")
    state, gen, batch = TrainState.create(model, tx), _generator(mode), _batch()
    got = {"losses": []}
    with profiling.collect() as sink:
        for i in range(3):
            state, metrics = step(state, video, batch, gen)
            got["losses"].append(float(metrics["loss"]))
            if i == 0:
                got["first_grad"] = {n: float(m.double().norm()) / (1 - tx.b1)
                                     for n, m in zip(tx.names, tx.mu)}
    start = common.whisper_state(cfg, SEED, "cpu")
    got["delta"] = {n: p.detach() - start[n] for n, p in zip(tx.names, tx.params)}
    got["change"] = {n: float(d.double().norm()) for n, d in got["delta"].items()}
    return got, model, video, sink


def _reference(mode):
    cfg = _config()
    sd = common.whisper_state(cfg, SEED, "cpu")
    tsd = av_decode.trunk_state(_config(), SEED, "cpu")
    b = _batch()
    chunk = {"mel": b["input_ids"], "frames": torch.full((ROWS,), FRAMES),
             "draws": torch.zeros((ROWS, 1, 3), dtype=torch.long), "n_freq_mask": 1,
             "dec_input_ids": b["dec_input_ids"], "labels": b["labels"], "video": b["video"],
             "mode": mode}
    return av_train_ref.train_steps(sd, DIMS, [[chunk]] * 3, TRAIN,
                                    av_train_ref.flamingo_trainable, lambda n: True,
                                    trunk=(tsd, TRUNK))


@pytest.fixture(scope="module")
def runs():
    return {mode: (_program(mode), _reference(mode)) for mode in av_train_ref.MODES}


@pytest.mark.parametrize("mode", av_train_ref.MODES)
def test_av_step_matches_the_reference(runs, mode):
    (got, *_), ref = runs[mode]
    assert set(got["first_grad"]) == set(ref["first_grad"])
    numbers = finetune.compare(got, ref)
    assert all(numbers[k] <= TOL[k] for k in TOL), numbers


@pytest.mark.parametrize("mode", av_train_ref.MODES)
def test_frozen_parameters_bit_unchanged(runs, mode):
    (_, model, video, _), _ = runs[mode]
    cfg = _config()
    sd = common.whisper_state(cfg, SEED, "cpu")
    frozen = [(n, p) for n, p in model.named_parameters() if not p.requires_grad]
    assert len(frozen) > 0 and all(torch.equal(p, sd[n]) for n, p in frozen)
    tsd = av_decode.trunk_state(_config(), SEED, "cpu")
    state = video.state_dict()
    assert all(torch.equal(state[n], t) for n, t in tsd.items())


@pytest.mark.parametrize("mode", av_train_ref.MODES)
def test_counters_count_the_draws(runs, mode):
    (_, _, _, sink), _ = runs[mode]
    names = {"both": "train.av_both", "audio": "train.av_audio", "video": "train.av_video"}
    assert {k: sink.counters.get(k, 0) for k in names.values()} == {
        k: 3 if m == mode else 0 for m, k in names.items()}
    assert sum(sp.name == "train.frozen" for sp in sink.spans) == 3


def test_a_bf16_step_fails_the_tolerances(runs):
    got = _program("both", torch.bfloat16)[0]
    numbers = finetune.compare(got, runs["both"][1])
    assert any(numbers[k] > TOL[k] for k in TOL), numbers


def test_dp_driver_matches_the_global_batch_on_4_gloo_ranks():
    """The cell's set-up, one window step and its check, run as
    ``perfbench.run`` runs them (which refuses a process with JAX loaded)."""
    from perfbench.drivers import finetune_dp
    from perfbench.tests.conftest import small_config
    from perfbench.trace import Recorder

    cfg = small_config("whisper-large-v2")
    cfg["dtype"] = "float32"
    cfg["train"] = dict(cfg["train"], learning_rate=1e-3, warmup_steps=0)
    cell = spec.workload(spec.benchmark(), "whisper-large-v2.finetune-dp4")
    d = finetune_dp.Driver(cfg, spec.traffic(cell["traffic"]), SEED, Recorder(False, "cpu"),
                           "cpu", units=1)
    d.setup()
    stats = d.run_window()
    d.release()
    d.check({})
    assert stats["units"] == 1 and d.world == 4
    assert all(d.numbers[k] <= TOL[k] for k in TOL), d.numbers
