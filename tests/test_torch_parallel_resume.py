"""Resume under a mesh: the port's ``whisper_ft`` on
``configs/smoke/ft_dp.yaml`` with ``num_devices=2 tp_size=2`` (4 gloo
ranks under ``torchrun``, the CPU). A run restarted from its step-2
checkpoint (gathered full state, sliced again onto the mesh) continues
with the uninterrupted run's losses, bit for bit."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from whisper_flamingo_tpu_torch.config import TrainConfig
from whisper_flamingo_tpu_torch.models.dims import MODEL_DIMS
from whisper_flamingo_tpu_torch.recipes import common

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FT_DP = os.path.join(ROOT, "configs", "smoke", "ft_dp.yaml")


def _torchrun(n, *args):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={n}", "-m", "whisper_flamingo_tpu_torch.recipes.whisper_ft",
         FT_DP, "device=cpu", "log_every=1", "num_devices=2", "tp_size=2", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]


def _losses(log_dir, train_id):
    with open(os.path.join(log_dir, f"{train_id}.metrics.jsonl")) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f) if "loss" in r}


def test_ft_dp_resumes_under_a_2x2_mesh(tmp_path):
    logs = f"log_output_dir={tmp_path}/logs"
    _torchrun(4, "train_id=a", logs, f"check_output_dir={tmp_path}/ckpt")
    # restart from the step-2 checkpoint the straight run saved on its way
    os.makedirs(tmp_path / "ckpt" / "b")
    shutil.copy(tmp_path / "ckpt" / "a" / "step-00000002.pt", tmp_path / "ckpt" / "b" / "last.pt")
    _torchrun(4, "train_id=b", logs, f"check_output_dir={tmp_path}/ckpt", "resume_training=True")
    straight, resumed = _losses(tmp_path / "logs", "a"), _losses(tmp_path / "logs", "b")
    assert sorted(straight) == [1, 2, 3, 4] and sorted(resumed) == [3, 4]
    assert [resumed[s] for s in (3, 4)] == [straight[s] for s in (3, 4)]


def test_setup_mesh_outside_a_process_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert common.setup_mesh(TrainConfig(num_devices=1, tp_size=1)) is None
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 8"):
        common.setup_mesh(TrainConfig(num_devices=4, tp_size=2))
    assert MODEL_DIMS["debug"].n_text_head % 2 == 0  # ft_dp's tp 2 keeps whole heads
