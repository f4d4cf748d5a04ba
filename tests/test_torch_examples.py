"""The port's examples (``whisper_flamingo_tpu_torch.examples.demo`` and
``eval_table``) against the JAX package's scripts (``examples/demo.py``,
``examples/eval_table.py``) on the CPU at the debug dims.

The JAX scripts run as their CI runs them (``--platform cpu``), with
``load_model`` wrapped so the random models they build are recorded; the
port's run gets the same weights carried across by ``convert`` (and the
debug-av trunk of JAX's ``init_video_encoder(PRNGKey(0))``). Both decode
in fp32 at the debug dims, so the printed texts and table rows must be the
same: the decoded texts equal, the table's printed lines equal, each
average log-probability within 1e-4.
"""

import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch

import whisper_flamingo_tpu as jwhisper
from whisper_flamingo_tpu.models import avhubert as javhubert

import whisper_flamingo_tpu_torch as whisper
from whisper_flamingo_tpu_torch.convert import params_from_jax, video_params_from_jax
from whisper_flamingo_tpu_torch.examples import demo, eval_table
from whisper_flamingo_tpu_torch.models import avhubert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_script(name, argv, monkeypatch, capsys):
    """Run ``examples/<name>.py`` of the JAX package as its CI does: (its
    stdout lines, the models its ``load_model`` calls returned)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    built = []
    original = jwhisper.load_model

    def recording(*args, **kwargs):
        built.append(original(*args, **kwargs))
        return built[-1]

    with monkeypatch.context() as mp:
        mp.setattr(jwhisper, "load_model", recording)
        mp.setattr(sys, "argv", [name, *argv])
        mod.main()
    return capsys.readouterr().out.splitlines(), built


def _port_models(built, monkeypatch):
    """Make the port's ``load_model`` return the JAX models, in order."""
    queue = list(built)
    original = whisper.load_model

    def carried(name, device=None, **kwargs):
        jm = queue.pop(0)
        model = original(name, device="cpu", **kwargs)
        sd = params_from_jax(jax.tree.map(np.asarray, jm.params), model.dims, model.extras)
        model.load_state_dict(sd, strict=True)
        return model

    monkeypatch.setattr(whisper, "load_model", carried)
    return queue


def _same_demo_lines(mine, theirs):
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        if a.startswith("[") and "avg_logprob=" in a:  # "[i] avg_logprob=x  text=..."
            la, ta = a.split("  text=", 1)
            lb, tb = b.split("  text=", 1)
            assert ta == tb
            assert float(la.split("=")[1]) == pytest.approx(float(lb.split("=")[1]), abs=1.5e-3)
        else:
            assert a == b


@pytest.mark.parametrize("beam", [None, 2])
def test_demo_prints_the_jax_scripts_texts(monkeypatch, capsys, beam):
    argv = ["--platform", "cpu"] + ([] if beam is None else ["--beam_size", str(beam)])
    theirs, built = _jax_script("demo", argv, monkeypatch, capsys)
    left = _port_models(built, monkeypatch)
    rows = demo.main(argv)
    mine = capsys.readouterr().out.splitlines()
    assert not left
    _same_demo_lines(mine, theirs)
    assert len(rows) == 3 and rows[0]["text"] and "wer" in rows[-1]


def test_eval_table_prints_the_jax_scripts_rows(monkeypatch, capsys):
    """The audio and the AV (debug-av trunk) systems, En ASR and En-Ru ST,
    clean and at 0 dB of the synthetic babble (the ``add_noise`` mix), beam 2."""
    argv = ["--platform", "cpu", "--model-type", "debug", "--synthetic", "3",
            "--batch-size", "2", "--beam-size", "2", "--sample-len", "8"]
    theirs, built = _jax_script("eval_table", argv, monkeypatch, capsys)
    assert len(built) == 2
    left = _port_models(built, monkeypatch)
    vcfg = avhubert.VIDEO_ENCODER_CONFIGS["debug-av"]
    jtrunk = jax.tree.map(np.asarray, javhubert.init_video_encoder(
        jax.random.PRNGKey(0), javhubert.VIDEO_ENCODER_CONFIGS["debug-av"]))

    def carried_trunk(generator, cfg, device=None):
        trunk = avhubert.VideoEncoder(cfg)
        trunk.load_state_dict(video_params_from_jax(jtrunk, cfg), strict=True)
        return trunk.eval()

    monkeypatch.setattr(avhubert, "init_video_encoder", carried_trunk)
    rows = eval_table.main(argv)
    mine = capsys.readouterr().out.splitlines()
    assert not left and vcfg.audio_feat_dim is not None
    assert mine == theirs
    assert [(r[0], r[1]) for r in rows] == [
        ("Whisper debug (audio)", "En ASR"), ("Whisper debug (audio)", "En-Ru ST"),
        ("Whisper-Flamingo debug (AV)", "En ASR"), ("Whisper-Flamingo debug (AV)", "En-Ru ST")]
    assert all(set(vals) == {1000, 0} for _, _, vals in rows)


def test_platform_flag_selects_the_device():
    assert demo.device_of("cpu") == "cpu"
    assert demo.device_of(None) == demo.device_of("gpu") == "cuda"
