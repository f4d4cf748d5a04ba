"""The port's CLI: ``python -m whisper_flamingo_tpu_torch`` on the CPU writes
every output format with word timestamps; the serving flags
(``--draft_model``, ``--quantize``) run; with no card the default device
raises."""

import json
import os
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

from whisper_flamingo_tpu_torch import cli as tcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wav(path, seconds=3):
    data = (np.random.default_rng(0).standard_normal(16000 * seconds) * 1000).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(data.tobytes())
    return str(path)


def test_cli_writes_every_format_with_words(tmp_path):
    wav = _wav(tmp_path / "x.wav")
    proc = subprocess.run(
        [sys.executable, "-m", "whisper_flamingo_tpu_torch", wav, "--model", "debug",
         "--device", "cpu", "--output_format", "all", "--word_timestamps", "True",
         "--language", "en", "--beam_size", "None", "--best_of", "None",
         "--temperature_increment_on_fallback", "None", "--verbose", "False",
         "--threads", "1", "--output_dir", str(tmp_path)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Skipping" not in proc.stdout, proc.stdout[-2000:]
    for ext in ("txt", "vtt", "srt", "tsv", "json"):
        assert (tmp_path / f"x.{ext}").is_file(), (ext, proc.stderr[-2000:])
    data = json.loads((tmp_path / "x.json").read_text())
    assert data["language"] == "en" and data["segments"]
    assert all("words" in s for s in data["segments"])


@pytest.mark.parametrize("flag", [["--draft_model", "debug"], ["--quantize", "int8"]])
def test_cli_flags_of_later_slices_raise(tmp_path, monkeypatch, flag):
    """The serving flags of slice 4 are ported: speculative decoding with a
    draft model, and the int8 mode, each write the transcript."""
    monkeypatch.setattr(sys, "argv", ["whisper_flamingo_tpu_torch", _wav(tmp_path / "y.wav", 1),
                                      "--model", "debug", "--device", "cpu", "--language", "en",
                                      "--beam_size", "None", "--best_of", "None",
                                      "--temperature_increment_on_fallback", "None",
                                      "--verbose", "False", "--output_format", "json",
                                      "--threads", "1", "--output_dir", str(tmp_path), *flag])
    threads = torch.get_num_threads()
    try:
        tcli.cli()
    finally:
        torch.set_num_threads(threads)
    data = json.loads((tmp_path / "y.json").read_text())
    assert data["language"] == "en" and "segments" in data


def test_cli_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["whisper_flamingo_tpu_torch", _wav(tmp_path / "z.wav", 1),
                                      "--model", "debug", "--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.cli()
