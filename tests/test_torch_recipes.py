"""The port's recipe entry point and config on the CPU.

``python -m whisper_flamingo_tpu_torch.recipes.whisper_ft
configs/smoke/ft.yaml device=cpu`` (the debug dims) trains, validates,
checkpoints and resumes; a run stopped at step 4 of 6 (``max_steps``) and
resumed ends with the parameters of an uninterrupted run, bit for bit
(fp32 on the CPU).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from whisper_flamingo_tpu.config import TrainConfig as JConfig

from whisper_flamingo_tpu_torch.config import TrainConfig
from whisper_flamingo_tpu_torch.recipes import common, whisper_ft

from test_torch_model import hide_stub_triton  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "smoke", "ft.yaml")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(tmp, name, *extra):
    return [SMOKE, "device=cpu", f"train_id={name}", f"log_output_dir={tmp}/logs",
            f"check_output_dir={tmp}/ckpt", "log_every=1", *extra]


def _records(tmp, name):
    with open(os.path.join(tmp, "logs", f"{name}.metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_whisper_ft_trains_checkpoints_and_resumes(tmp_path):
    state = whisper_ft.main(_args(tmp_path, "a", "save_top_k=1", "num_train_steps=6",
                                  "max_steps=4"))
    assert state.step == 4 and state.model.device.type == "cpu"
    recs = _records(tmp_path, "a")
    assert [r["step"] for r in recs if "loss" in r] == [1, 2, 3, 4]
    assert {"val/loss", "val/acc", "val/wer", "val/cer"} <= set(recs[-1])
    ckpt = tmp_path / "ckpt" / "a"
    assert sorted(os.listdir(ckpt)) == ["last.meta.json", "last.pt", "step-00000004.pt"]

    resumed = whisper_ft.main(_args(tmp_path, "a", "resume_training=True", "num_train_steps=6"))
    straight = whisper_ft.main(_args(tmp_path, "b", "num_train_steps=6"))
    assert resumed.step == straight.step == 6
    sp = dict(straight.model.named_parameters())
    for name, p in resumed.model.named_parameters():
        assert torch.equal(p, sp[name]), name
    loss = {r["step"]: r["loss"] for r in _records(tmp_path, "a") if "loss" in r}
    loss_b = {r["step"]: r["loss"] for r in _records(tmp_path, "b") if "loss" in r}
    assert [loss[s] for s in (5, 6)] == [loss_b[s] for s in (5, 6)]


def test_config_reads_the_shared_yaml_as_jax_does():
    cfg = TrainConfig.from_yaml(SMOKE, batch_size=3)
    ref = JConfig.from_yaml(SMOKE, batch_size=3)
    theirs = ref.to_dict()
    mine = cfg.to_dict()
    assert mine.pop("device") == "cuda"
    assert mine == theirs
    assert cfg.compute_dtype == torch.float32  # precision: 32
    assert TrainConfig(precision="16-mixed").compute_dtype == torch.bfloat16
    assert cfg.extras["platform"] == "cpu"  # read, not applied


def test_load_config_overrides_and_unported_parts():
    cfg = common.load_config([SMOKE, "device=cpu", "warmup_steps=3", "lang=de"])
    assert (cfg.device, cfg.warmup_steps, cfg.lang) == ("cpu", 3, "de")
    with pytest.raises(NotImplementedError):
        common.setup_mesh(TrainConfig(num_devices=2))
    with pytest.raises(NotImplementedError):
        whisper_ft.main([SMOKE, "device=cpu", "optimizer=adafactor", "num_train_steps=0"])


def test_module_entry_point_runs(tmp_path):
    """``python -m whisper_flamingo_tpu_torch.recipes.whisper_ft`` as a user
    runs it."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "whisper_flamingo_tpu_torch.recipes.whisper_ft",
         *_args(tmp_path, "cli", "num_train_steps=2")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert os.path.exists(tmp_path / "ckpt" / "cli" / "last.pt")
