"""The text recipes under a 2 x 2 mesh: ``trans_asr``, ``transkd_asr`` and
``distil_prompt`` on their smoke configs (debug dims, the random BERT
conditioner) as 4 gloo ranks under ``torchrun`` on the CPU give the
per-step train losses of the same recipe on one device (the smoke batches
divide evenly, so the mesh's ``drop_last`` leaves the batch stream as it
is), to 1e-4 relative."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = [("trans_asr", "trans_asr"), ("transkd_asr", "transkd"),
           ("distil_prompt", "distil_prompt")]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def recipe_losses(tmp, name, config, ranks):
    """Per-step train losses of ``recipes.<name>`` on ``configs/smoke/<config>``:
    in-process on one device (``ranks`` 1) or under ``torchrun`` on a 2 x 2
    mesh (``ranks`` 4)."""
    import importlib

    args = [os.path.join(ROOT, "configs", "smoke", f"{config}.yaml"), "device=cpu",
            "log_every=1", f"train_id=r{ranks}", f"log_output_dir={tmp}/logs",
            f"check_output_dir={tmp}/ckpt"]
    if ranks == 1:
        importlib.import_module(f"whisper_flamingo_tpu_torch.recipes.{name}").main(args)
    else:
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={ranks}", "-m", f"whisper_flamingo_tpu_torch.recipes.{name}",
             *args, "num_devices=2", "tp_size=2"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-4000:]
    with open(os.path.join(tmp, "logs", f"r{ranks}.metrics.jsonl")) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f) if "loss" in r}


@pytest.mark.parametrize("name,config", RECIPES, ids=[r[0] for r in RECIPES])
def test_text_recipe_under_a_2x2_mesh_equals_one_device(name, config, tmp_path):
    one = recipe_losses(tmp_path, name, config, 1)
    mesh = recipe_losses(tmp_path, name, config, 4)
    assert sorted(mesh) == sorted(one) and one
    for step in one:
        np.testing.assert_allclose(mesh[step], one[step], rtol=1e-4, err_msg=str(step))
