"""The port's ``whisper_ft`` recipe under ``torchrun`` on the CPU:
``configs/smoke/ft_dp.yaml`` (num_devices 4 x tp_size 2: 8 gloo ranks,
the debug dims) against the JAX recipe on the same config (conftest's 8
virtual devices) from one shared ``pt_ckpt``, and its gathered checkpoint
on one device. ``test_torch_parallel_resume.py`` resumes under a mesh."""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from whisper_flamingo_tpu_torch.recipes import common
from whisper_flamingo_tpu_torch.tokenizer import get_tokenizer
from whisper_flamingo_tpu_torch.training.steps import TrainState, make_eval_step
from whisper_flamingo_tpu_torch.training.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FT_DP = os.path.join(ROOT, "configs", "smoke", "ft_dp.yaml")
RECIPES_DIR = os.path.join(ROOT, "recipes")
LOSS_REL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _torchrun(n, *args):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={n}", "-m", "whisper_flamingo_tpu_torch.recipes.whisper_ft",
         FT_DP, "device=cpu", "log_every=1", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


def _records(log_dir, train_id):
    with open(os.path.join(log_dir, f"{train_id}.metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _losses(log_dir, train_id):
    return {r["step"]: r["loss"] for r in _records(log_dir, train_id) if "loss" in r}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX recipe and the port's 8-rank run, from one ``pt_ckpt``."""
    import importlib.util

    from whisper_flamingo_tpu import load_model as jload_model
    from whisper_flamingo_tpu.training import trainer as jtrainer
    from whisper_flamingo_tpu.training.checkpoints import to_torch_state_dict as jto_torch

    tmp = tmp_path_factory.mktemp("ft_dp")
    jm = jload_model("debug", seed=7)
    ckpt = str(tmp / "debug.pt")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in jto_torch(jm.params, jm.dims).items()},
               ckpt)
    common_args = [f"pt_ckpt={ckpt}"]

    if RECIPES_DIR not in sys.path:  # the JAX recipes import their `common`
        sys.path.insert(0, RECIPES_DIR)
    spec = importlib.util.spec_from_file_location(
        "jax_recipe_whisper_ft_dp", os.path.join(RECIPES_DIR, "whisper_ft.py"))
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jtrainer.Trainer, "fit",
                   functools.partialmethod(jtrainer.Trainer.fit, log_every=1))
        mp.chdir(ROOT)
        mp.setattr(sys, "argv", ["whisper_ft", FT_DP, *common_args,
                                 f"log_output_dir={tmp}/jax/logs",
                                 f"check_output_dir={tmp}/jax/ckpt"])
        jmod.main()
    finally:
        mp.undo()
    _torchrun(8, *common_args, f"log_output_dir={tmp}/port/logs",
              f"check_output_dir={tmp}/port/ckpt")
    return tmp, common_args


def test_ft_dp_train_losses_match_the_jax_recipe(runs):
    tmp, _ = runs
    jax = _losses(f"{tmp}/jax/logs", "smoke_ft_dp")
    port = _losses(f"{tmp}/port/logs", "smoke_ft_dp")
    assert sorted(port) == sorted(jax) == [1, 2, 3, 4]
    for step in jax:
        np.testing.assert_allclose(port[step], jax[step], rtol=LOSS_REL, err_msg=str(step))
    # one writer: the primary rank's records only, one per step
    recs = _records(f"{tmp}/port/logs", "smoke_ft_dp")
    assert [r["step"] for r in recs if "loss" in r] == [1, 2, 3, 4]


def test_ft_dp_checkpoint_loads_on_one_device(runs, tmp_path):
    """``last.pt`` holds the gathered full parameters and optimizer state:
    it restores into a one-device state, whose validation loss is the
    mesh run's final one."""
    tmp, _ = runs
    cfg = common.load_config([FT_DP, "device=cpu", f"log_output_dir={tmp_path}/logs",
                              f"check_output_dir={tmp}/port/ckpt", "num_devices=1", "tp_size=1"])
    model = common.build_model(cfg, gated=False)
    from whisper_flamingo_tpu_torch.training.optim import whisper_optimizer

    tx, _ = whisper_optimizer(model, cfg.learning_rate, total_steps=cfg.num_train_steps)
    trainer = Trainer(cfg=cfg, dims=model.dims, train_step=None,
                      eval_step=make_eval_step(model.dims))
    state = trainer.checkpoints.restore_last(TrainState.create(model, tx))
    assert state.step == 4 and state.optimizer.count == 4
    for p, mu in zip(tx.params, tx.mu):
        assert mu.shape == p.shape
    tok = get_tokenizer(model.is_multilingual, num_languages=model.num_languages,
                        language=cfg.lang, task="transcribe")
    # the mesh run's validation batches: its global batches, drop_last
    cfg_mesh = common.load_config([FT_DP, "device=cpu"])
    val_mesh = common.build_loader(cfg_mesh, "validation", tok, training=False)
    got = trainer.validate(state.model, {"val": val_mesh})
    final = [r for r in _records(f"{tmp}/port/logs", "smoke_ft_dp") if r.get("phase") == "final"]
    np.testing.assert_allclose(got["val/loss"], final[0]["val/loss"], rtol=LOSS_REL)
