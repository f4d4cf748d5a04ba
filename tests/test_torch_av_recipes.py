"""The port's AV recipes against the JAX package's, on the CPU, in fp32.

``av_train`` runs in both packages on ``configs/smoke/av.yaml`` (the debug
Whisper, the debug trunk, synthetic 2 s utterances with random 88x88
frames) from one ``pt_ckpt`` written from a JAX model with the gates at
0.5 (so the video moves the loss) and one fairseq-keyed ``video_model_ckpt``
written from a JAX trunk, loaded by each package's ``load_avhubert_torch``.
JAX draws the modality from its own random stream, which the port cannot
reproduce, so each branch is pinned: ``prob_av=1`` (both streams),
``prob_av=0 prob_a=1`` (audio only), ``prob_av=0 prob_a=0`` (video only),
and ``video_encoder=debug-av`` adds the fbank stream. Train and validation
losses agree within 1e-4 relative.

``decode_av`` runs in both packages over a temporary manifest of WAVs and
``.npy`` clips, in fp32 (``DecodingOptions`` patched to ``fp16=False`` on
both sides): the same hypotheses, references and WER.
"""

import functools
import json
import os
import subprocess
import sys
import wave

import jax
import numpy as np
import pytest
import torch

from whisper_flamingo_tpu.models import avhubert as ja

from whisper_flamingo_tpu_torch.convert import video_params_from_jax
from whisper_flamingo_tpu_torch.models import avhubert as ta
from whisper_flamingo_tpu_torch.recipes import av_train, decode_av

from test_torch_model import hide_stub_triton  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES_DIR = os.path.join(ROOT, "recipes")
if RECIPES_DIR not in sys.path:  # the JAX recipes import their `common`
    sys.path.insert(0, RECIPES_DIR)
SMOKE = os.path.join(ROOT, "configs", "smoke", "av.yaml")
LOSS_REL = 1e-4
_JAX_RECIPES = {}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_recipe(name):
    import importlib.util

    if name not in _JAX_RECIPES:
        spec = importlib.util.spec_from_file_location(
            f"jax_av_recipe_{name}", os.path.join(RECIPES_DIR, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _JAX_RECIPES[name] = mod
    return _JAX_RECIPES[name]


# decode_av feeds the whole 104-dim fbank to the trunk (av_train slices it
# to ``audio_feat_dim``), so its avsr case needs a debug-width trunk that
# reads 104 dims; both packages' config tables get it for this file
DEBUG_AVSR = "debug-avsr-104"


DEBUG_AVSR_KW = dict(embed_dim=64, n_layers=2, n_heads=2, ffn_dim=128, conv_pos=8,
                     conv_pos_groups=2, audio_feat_dim=104)


@pytest.fixture(autouse=True)
def debug_avsr_config(monkeypatch):
    monkeypatch.setitem(ja.VIDEO_ENCODER_CONFIGS, DEBUG_AVSR,
                        ja.VideoEncoderConfig(**DEBUG_AVSR_KW))
    monkeypatch.setitem(ta.VIDEO_ENCODER_CONFIGS, DEBUG_AVSR,
                        ta.VideoEncoderConfig(**DEBUG_AVSR_KW))


def _trunk_state(name, seed):
    """A fairseq-keyed trunk state from a JAX init with random BatchNorm
    statistics (the port's module keys are fairseq's)."""
    if name == DEBUG_AVSR:
        jcfg, cfg = ja.VideoEncoderConfig(**DEBUG_AVSR_KW), ta.VideoEncoderConfig(**DEBUG_AVSR_KW)
    else:
        jcfg, cfg = ja.VIDEO_ENCODER_CONFIGS[name], ta.VIDEO_ENCODER_CONFIGS[name]
    jp = jax.tree.map(np.asarray, ja.init_video_encoder(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    bn = jp["frontend"]["bn3d"]
    bn["mean"] = rng.normal(0, 0.5, 64).astype(np.float32)
    bn["bias"] = rng.normal(0, 0.3, 64).astype(np.float32)
    return video_params_from_jax(jp, cfg)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """The shared Whisper checkpoint (gates at ``gate``) and trunk states."""
    from whisper_flamingo_tpu import load_model as jload_model
    from whisper_flamingo_tpu.training.checkpoints import to_torch_state_dict as jto_torch

    tmp = tmp_path_factory.mktemp("av_ckpts")
    out = {}
    for gate in (0.5, 1.5):
        jm = jload_model("debug", add_gated_x_attn=1, num_langs=1, bert_dim=64, seed=7)
        sd = {k: torch.from_numpy(np.array(v)) for k, v in jto_torch(jm.params, jm.dims).items()}
        for k in sd:
            if k.endswith(("attn_gate", "ff_gate")):
                sd[k] = torch.full_like(sd[k], gate)
        out[gate] = str(tmp / f"whisper_gate{gate}.pt")
        torch.save({"dims": jm.dims.to_dict(), "model_state_dict": sd}, out[gate])
    for name in ("debug", "debug-av", DEBUG_AVSR):
        out[name] = str(tmp / f"avhubert_{name}.pt")
        torch.save({"model": _trunk_state(name, 3)}, out[name])
    return out


# -- av_train ------------------------------------------------------------------

BRANCHES = {
    "both": ["prob_av=1.0"],
    "audio_only": ["prob_av=0.0", "prob_a=1.0"],
    "video_only": ["prob_av=0.0", "prob_a=0.0"],
    "avsr_both": ["prob_av=1.0", "video_encoder=debug-av"],
}


def _records(tmp, side):
    with open(os.path.join(tmp, side, "logs", "smoke_av.metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_av_train_losses_match_jax(branch, ckpts, tmp_path, monkeypatch):
    from whisper_flamingo_tpu.training import trainer as jtrainer

    trunk = "debug-av" if "video_encoder=debug-av" in BRANCHES[branch] else "debug"

    def argv(side):
        return [SMOKE, f"pt_ckpt={ckpts[0.5]}", f"video_model_ckpt={ckpts[trunk]}",
                f"log_output_dir={tmp_path}/{side}/logs",
                f"check_output_dir={tmp_path}/{side}/ckpt", *BRANCHES[branch]]

    monkeypatch.setattr(jtrainer.Trainer, "fit",
                        functools.partialmethod(jtrainer.Trainer.fit, log_every=1))
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(sys, "argv", ["av_train", *argv("jax")])
    _jax_recipe("av_train").main()
    state = av_train.main([*argv("port"), "device=cpu", "log_every=1"])

    ref, got = _records(tmp_path, "jax"), _records(tmp_path, "port")
    assert state.step == 2 and len(got) == len(ref)
    for r, g in zip(ref, got):
        keys = [k for k in r if k == "loss" or k.endswith("/loss")]
        assert keys and keys == [k for k in g if k == "loss" or k.endswith("/loss")]
        for k in keys:
            assert abs(g[k] - r[k]) <= LOSS_REL * abs(r[k]), (g["step"], k, g[k], r[k])


def test_video_speech_dataset_equals_jax():
    """The synthetic frames (from the utterance id's CRC32) and the fbank
    stream, item by item, and the collated batch."""
    import common as jcommon  # the JAX recipes' common module
    from whisper_flamingo_tpu.config import TrainConfig as JC
    from whisper_flamingo_tpu.tokenizer import get_tokenizer as jget_tokenizer

    from whisper_flamingo_tpu_torch.config import TrainConfig
    from whisper_flamingo_tpu_torch.recipes import common
    from whisper_flamingo_tpu_torch.tokenizer import get_tokenizer

    jcfg, cfg = JC.from_yaml(SMOKE), TrainConfig.from_yaml(SMOKE, device="cpu")
    jloader = jcommon.build_loader(jcfg, "train", jget_tokenizer(True, language="en"),
                                   training=True)
    loader = common.build_loader(cfg, "train", get_tokenizer(True, language="en"),
                                 training=True)
    jloader.dataset.__class__ = _jax_recipe("av_train").VideoSpeechDataset
    loader.dataset.__class__ = av_train.VideoSpeechDataset
    for ds in (jloader.dataset, loader.dataset):
        ds.emit_fbank, ds.fbank_dim = True, 104
    for i in range(len(loader.dataset)):
        ref, got = jloader.dataset[i], loader.dataset[i]
        np.testing.assert_array_equal(got["video"], ref["video"])
        np.testing.assert_array_equal(got["fbank"], ref["fbank"])
        assert got["video"].shape[1:] == (88, 88) and got["fbank"].shape[1] == 104
    jbatch, batch = next(iter(jloader)), next(iter(loader))
    for key in ("video", "video_lens", "fbank", "fbank_lens", "dec_input_ids"):
        np.testing.assert_array_equal(batch[key], jbatch[key])


def test_av_train_module_entry_point_runs(tmp_path):
    """``python -m whisper_flamingo_tpu_torch.recipes.av_train`` as a user
    runs it."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "whisper_flamingo_tpu_torch.recipes.av_train", SMOKE,
         "device=cpu", "num_train_steps=1", f"log_output_dir={tmp_path}/logs",
         f"check_output_dir={tmp_path}/ckpt"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert os.path.exists(tmp_path / "ckpt" / "smoke_av" / "last.pt")


# -- decode_av -----------------------------------------------------------------

@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """3 utterances: 16 kHz WAVs of 1.0-1.6 s and 48x48 clips of 25-40 frames."""
    tmp = tmp_path_factory.mktemp("av_manifest")
    rng = np.random.default_rng(8)
    rows = ["id\twav_path\ttext\tvideo_path"]
    for i, sec in enumerate((1.0, 1.6, 1.2)):
        wav = (rng.standard_normal(int(16000 * sec)) * 3000).astype(np.int16)
        with wave.open(str(tmp / f"u{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(wav.tobytes())
        np.save(tmp / f"u{i}.npy", rng.standard_normal((int(25 * sec), 48, 48)).astype(np.float32))
        rows.append(f"u{i}\t{tmp}/u{i}.wav\thello world number {i}\t{tmp}/u{i}.npy")
    path = tmp / "test.tsv"
    path.write_text("\n".join(rows) + "\n")
    return str(path)


DECODES = [("avsr", 2, DEBUG_AVSR), ("vsr", 1, "debug"), ("asr", 1, "debug")]


@pytest.mark.parametrize("modality,beam,trunk", DECODES, ids=[d[0] for d in DECODES])
def test_decode_av_matches_jax(modality, beam, trunk, ckpts, manifest, tmp_path, monkeypatch,
                               capsys):
    import ast

    import whisper_flamingo_tpu as jwhisper

    import whisper_flamingo_tpu_torch as wt

    def argv(side):
        return ["--model-type", "debug", "--modalities", modality, "--video-encoder", trunk,
                "--checkpoint-path", ckpts[1.5], "--av-hubert-ckpt", ckpts[trunk],
                "--beam-size", str(beam), "--batch-size", "2", "--manifest", manifest,
                "--decode-dir", str(tmp_path / side)]

    monkeypatch.setattr(jwhisper, "DecodingOptions",
                        functools.partial(jwhisper.DecodingOptions, fp16=False))
    monkeypatch.setattr(wt, "DecodingOptions", functools.partial(wt.DecodingOptions, fp16=False))
    monkeypatch.setattr(sys, "argv", ["decode_av", *argv("jax")])
    capsys.readouterr()
    _jax_recipe("decode_av").main()
    ref = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    got = decode_av.main([*argv("port"), "--device", "cpu"])
    assert got == ref and got["n"] == 3
    for name in ("hypo.txt", "ref.txt"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    assert (tmp_path / "port" / "ref.txt").read_text().splitlines()[0] == "hello world number 0"


def test_decode_av_refuses_noise_without_a_file_and_needs_a_device(manifest, tmp_path):
    with pytest.raises(SystemExit, match="--noise-wav"):
        decode_av.main(["--model-type", "debug", "--video-encoder", DEBUG_AVSR,
                        "--manifest", manifest, "--noise-snr", "0", "--device", "cpu",
                        "--decode-dir", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            decode_av.main(["--model-type", "debug", "--manifest", manifest,
                            "--decode-dir", str(tmp_path)])
