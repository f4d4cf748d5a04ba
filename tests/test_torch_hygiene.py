"""The port's boundaries: it imports neither JAX nor the JAX package, and its
entry points run on the card unless the caller names the CPU."""

import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import sys
import whisper_flamingo_tpu_torch
import whisper_flamingo_tpu_torch.convert, whisper_flamingo_tpu_torch.training.checkpoints
import whisper_flamingo_tpu_torch.timing, whisper_flamingo_tpu_torch.transcribe
import whisper_flamingo_tpu_torch.writers, whisper_flamingo_tpu_torch.cli
import whisper_flamingo_tpu_torch.normalizers, whisper_flamingo_tpu_torch.metrics
import whisper_flamingo_tpu_torch.ops.dtw, whisper_flamingo_tpu_torch.ops.median
import whisper_flamingo_tpu_torch.config, whisper_flamingo_tpu_torch.profiling
import whisper_flamingo_tpu_torch.ops.spec_augment, whisper_flamingo_tpu_torch.ops.flash64
import whisper_flamingo_tpu_torch.data.collator, whisper_flamingo_tpu_torch.data.dataset
import whisper_flamingo_tpu_torch.data.noise, whisper_flamingo_tpu_torch.data.samplers
import whisper_flamingo_tpu_torch.data.translations
import whisper_flamingo_tpu_torch.training.optim, whisper_flamingo_tpu_torch.training.steps
import whisper_flamingo_tpu_torch.training.trainer
import whisper_flamingo_tpu_torch.recipes.common, whisper_flamingo_tpu_torch.recipes.whisper_ft
import whisper_flamingo_tpu_torch.serving, whisper_flamingo_tpu_torch.speculative
import whisper_flamingo_tpu_torch.ops.quant, whisper_flamingo_tpu_torch.ops.decode_mlp
import whisper_flamingo_tpu_torch.ops.flash64_variants, whisper_flamingo_tpu_torch.ops.mma_pair
import whisper_flamingo_tpu_torch.tools.flash64_fwd_probe
import whisper_flamingo_tpu_torch.tools.packed_probe2
import whisper_flamingo_tpu_torch.tools.flash64_ab
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.")
       or m == "whisper_flamingo_tpu" or m.startswith("whisper_flamingo_tpu.")]
print(bad)
sys.exit(1 if bad else 0)
"""


def test_import_loads_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _CHECK], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _sources():
    """The port's Python sources and ``chip_smoke.py``."""
    yield os.path.join(ROOT, "chip_smoke.py")
    for dirpath, _, files in os.walk(os.path.join(ROOT, "whisper_flamingo_tpu_torch")):
        yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))


def test_sources_name_no_jax_module():
    """No source file of the port, and not ``chip_smoke.py``, imports JAX or
    the JAX package (the package name is a prefix of the port's: match
    module names exactly)."""
    names = {os.path.relpath(p, ROOT) for p in _sources()}
    for mod in ("timing", "transcribe", "writers", "cli", "__main__", "metrics",
                "normalizers/basic", "normalizers/english", "ops/dtw", "ops/median",
                "config", "profiling", "ops/spec_augment", "data/collator", "data/dataset",
                "data/noise", "data/samplers", "data/translations", "training/optim",
                "training/steps", "training/trainer", "recipes/common", "recipes/whisper_ft",
                "serving", "speculative", "ops/quant", "ops/decode_mlp",
                "ops/flash64_variants", "ops/mma_pair", "tools/flash64_fwd_probe",
                "tools/packed_probe2", "tools/flash64_ab"):
        assert f"whisper_flamingo_tpu_torch/{mod}.py" in names
    for path in _sources():
        with open(path) as fh:
            for line in fh:
                words = line.split()
                if words[:1] not in (["import"], ["from"]) or len(words) < 2:
                    continue
                mod = words[1].rstrip(",")
                assert not (mod == "jax" or mod.startswith("jax.")), (path, line)
                assert not (mod == "whisper_flamingo_tpu"
                            or mod.startswith("whisper_flamingo_tpu.")), (path, line)


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    """With no card and no device named, the entry points raise instead of
    running on the CPU; naming the CPU works."""
    import numpy as np

    import whisper_flamingo_tpu_torch as wt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wt.load_model("debug")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wt.log_mel_spectrogram(np.zeros(16000, np.float32))
    model = wt.load_model("debug", device="cpu")
    assert model.device.type == "cpu"
    assert wt.log_mel_spectrogram(np.zeros(16000, np.float32), device="cpu").shape == (80, 100)


def test_kernel_wrappers_raise_on_a_device_without_a_kernel():
    """A wrapper takes its plain version only for CPU tensors: a tensor on
    any other device without a kernel raises."""
    from whisper_flamingo_tpu_torch.ops import decode_attn, dtw, flash64

    with pytest.raises(RuntimeError, match="no kernel"):
        dtw.dtw(torch.empty(3, 4, device="meta"))
    q = torch.empty(1, 2, 10, 32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        flash64.flash64_attention(q, q, q)
    lse = torch.empty(1, 2, 10, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        flash64.flash64_forward(q, q, q, with_lse=True)
    with pytest.raises(RuntimeError, match="no kernel"):
        flash64.flash64_backward(q, q, q, q, lse, q)
    with pytest.raises(RuntimeError, match="no kernel"):  # through autograd too
        flash64.flash64_attention(q.requires_grad_(), q, q)
    qd = torch.empty(2, 1, 64, device="meta")
    kc = torch.empty(2, 8, 64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        decode_attn.fused_step(qd, qd, qd, kc, kc, 0, 1)
    from whisper_flamingo_tpu_torch.ops import decode_mlp

    with torch.device("meta"):
        mlp = torch.nn.Sequential(torch.nn.Linear(64, 256), torch.nn.GELU(),
                                  torch.nn.Linear(256, 64))
    with pytest.raises(RuntimeError, match="no kernel"):  # the dispatch rule picks the kernel
        decode_mlp.fused_mlp(mlp, torch.empty(2, 1, 64, device="meta"))
    from whisper_flamingo_tpu_torch.ops import flash64_variants, mma_pair

    for fn in (flash64_variants.flash64_fwd_augv, flash64_variants.flash64_fwd_csbound):
        with pytest.raises(RuntimeError, match="no kernel"):
            fn(q, q, q)
    w = torch.empty(128, 64, device="meta", dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no kernel"):
        mma_pair.pair_chain(w, w[:64], w[:64], 1)


def test_serving_entry_points_need_a_device(monkeypatch):
    """The serving entry points run on the model's device: a model on the
    card with no card raises with the port's message."""
    import types

    from whisper_flamingo_tpu_torch.serving import BatchTranscriber, ContinuousBatcher

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    for entry in (BatchTranscriber, ContinuousBatcher):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(on_card)


def test_training_modules_have_no_device_fallback():
    """The training path's sources name no fallback to the CPU or to a
    plain version: no ``except`` that could swallow a kernel failure (the
    recipe's only one parses ``key=value`` overrides), and the recipe's
    device comes from the config (default the card)."""
    from whisper_flamingo_tpu_torch.config import TrainConfig

    assert TrainConfig().device == "cuda"
    for rel in ("ops/flash64.py", "training/steps.py", "training/optim.py",
                "training/trainer.py", "recipes/whisper_ft.py"):
        with open(os.path.join(ROOT, "whisper_flamingo_tpu_torch", rel)) as fh:
            text = fh.read()
        assert not re.search(r"^\s*except\b", text, re.MULTILINE), rel
    with pytest.raises(RuntimeError, match="device='cpu'"):
        import unittest.mock

        with unittest.mock.patch.object(torch.cuda, "is_available", lambda: False):
            from whisper_flamingo_tpu_torch.recipes import common

            common.build_model(TrainConfig(model_name="debug"))
