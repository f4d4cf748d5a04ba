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


def test_load_config_overrides_and_unported_parts(tmp_path):
    cfg = common.load_config([SMOKE, "device=cpu", "warmup_steps=3", "lang=de"])
    assert (cfg.device, cfg.warmup_steps, cfg.lang) == ("cpu", 3, "de")
    with pytest.raises(ValueError, match="torchrun"):  # no process group to join
        common.setup_mesh(TrainConfig(num_devices=2))
    state = whisper_ft.main([SMOKE, "device=cpu", "optimizer=adafactor", "num_train_steps=0",
                             f"log_output_dir={tmp_path}/logs", f"check_output_dir={tmp_path}/ckpt"])
    assert type(state.optimizer).__name__ == "Adafactor" and state.optimizer.count == 0


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


# -- the text recipes against the JAX package's ------------------------------
#
# Both packages run each recipe in-process on a smoke config (debug dims,
# fp32, the CPU), from one shared ``pt_ckpt`` written from a JAX model (the
# gates set to 0.5, so that ``xt`` moves the loss) and one offline BERT
# conditioner whose weights are carried across (``build_conditioner``
# patched in both). Train losses agree within 1e-4 relative; the eval
# recipes give the same outputs.

RECIPES_DIR = os.path.join(ROOT, "recipes")
if RECIPES_DIR not in sys.path:  # the JAX recipes import their `common`
    sys.path.insert(0, RECIPES_DIR)

LOSS_REL = 1e-4
_JAX_RECIPES = {}


def _jax_recipe(name):
    import importlib.util

    if name not in _JAX_RECIPES:
        spec = importlib.util.spec_from_file_location(
            f"jax_recipe_{name}", os.path.join(RECIPES_DIR, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _JAX_RECIPES[name] = mod
    return _JAX_RECIPES[name]


def _smoke(name):
    return os.path.join(ROOT, "configs", "smoke", f"{name}.yaml")


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """``pt_ckpt`` files per (gated, n_langs) and the two conditioners."""
    import numpy as np

    from whisper_flamingo_tpu import load_model as jload_model
    from whisper_flamingo_tpu.models import bert as jbert
    from whisper_flamingo_tpu.training.checkpoints import to_torch_state_dict as jto_torch

    from whisper_flamingo_tpu_torch.models import bert

    tmp = tmp_path_factory.mktemp("shared")
    ckpts = {}
    for gated, n_langs in ((0, 0), (1, 1), (1, 2), (1, 3)):
        jm = jload_model("debug", add_gated_x_attn=gated, num_langs=n_langs, bert_dim=96, seed=7)
        sd = {k: torch.from_numpy(np.array(v))
              for k, v in jto_torch(jm.params, jm.dims).items()}
        for k in sd:
            if k.endswith(("attn_gate", "ff_gate")):
                sd[k] = torch.full_like(sd[k], 0.5)
        path = str(tmp / f"debug_g{gated}_l{n_langs}.pt")
        torch.save(sd, path)
        ckpts[(gated, n_langs)] = path
    jcond = jbert.HFBertConditioner(pretrained=False, hidden_size=96)
    cond = bert.HFBertConditioner(pretrained=False, hidden_size=96, device="cpu")
    cond.model.load_state_dict(bert.bert_params_from_flax(jcond.model.params))
    return ckpts, jcond, cond


def _run_both(name, config, overrides, shared, tmp_path, monkeypatch, capsys=None):
    """Runs the JAX recipe and the port's on the same config, checkpoint and
    conditioner (``{side}`` in an override names each side's directory);
    returns (the JAX run's standard output, the port's return value)."""
    import functools
    import importlib

    from whisper_flamingo_tpu.config import TrainConfig as JC
    from whisper_flamingo_tpu.training import trainer as jtrainer

    ckpts, jcond, cond = shared
    raw = JC.from_yaml(_smoke(config))
    key = (1, raw.num_langs) if raw.add_gated_x_attn else (0, 0)

    def argv(side):
        os.makedirs(tmp_path / side, exist_ok=True)
        return [_smoke(config), f"pt_ckpt={ckpts[key]}", f"log_output_dir={tmp_path}/{side}/logs",
                f"check_output_dir={tmp_path}/{side}/ckpt",
                *[o.format(side=f"{tmp_path}/{side}") for o in overrides]]

    jmod = _jax_recipe(name)
    if hasattr(jmod, "build_conditioner"):
        monkeypatch.setattr(jmod, "build_conditioner", lambda cfg: jcond)
    monkeypatch.setattr(jtrainer.Trainer, "fit",
                        functools.partialmethod(jtrainer.Trainer.fit, log_every=1))
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(sys, "argv", [name, *argv("jax")])
    if capsys is not None:
        capsys.readouterr()
    jmod.main()
    printed = capsys.readouterr().out if capsys is not None else ""

    monkeypatch.setattr(common, "build_conditioner", lambda cfg: cond)
    port = importlib.import_module(f"whisper_flamingo_tpu_torch.recipes.{name}")
    return printed, port.main([*argv("port"), "device=cpu", "log_every=1"])


def _losses(tmp_path, side, train_id):
    with open(os.path.join(tmp_path, side, "logs", f"{train_id}.metrics.jsonl")) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f) if "loss" in r}


TRAIN = [("trans_asr", "trans_asr"), ("trans_asr", "trans_asr_oracle"),
         ("trans_asr", "trans_asr_trilingual"), ("transkd_asr", "transkd"),
         ("distil_prompt", "distil_prompt")]


@pytest.mark.parametrize("name,config", TRAIN, ids=[c for _, c in TRAIN])
def test_text_recipe_losses_match_jax(name, config, shared, tmp_path, monkeypatch):
    from whisper_flamingo_tpu.config import TrainConfig as JC

    _, state = _run_both(name, config, [], shared, tmp_path, monkeypatch)
    train_id = JC.from_yaml(_smoke(config)).train_id
    ref, got = _losses(tmp_path, "jax", train_id), _losses(tmp_path, "port", train_id)
    assert sorted(got) == sorted(ref) == list(range(1, state.step + 1))
    for step, loss in ref.items():
        assert abs(got[step] - loss) <= LOSS_REL * abs(loss), (step, got[step], loss)


def _last_dict(printed):
    import ast

    return ast.literal_eval(printed.strip().splitlines()[-1])


@pytest.mark.parametrize("config,overrides", [
    ("trans_asr", ["mode=teacher_forced"]),
    ("ft", ["mode=decode", "beam_size=2"]),
    ("trans_asr", ["mode=decode", "beam_size=2"]),
], ids=["teacher_forced_xt", "decode_beam2", "decode_beam2_xt"])
def test_evaluate_matches_jax(config, overrides, shared, tmp_path, monkeypatch, capsys):
    """The printed metrics; the decode modes' real-time factor is a wall
    time and is left out."""
    printed, got = _run_both("evaluate", config, overrides, shared, tmp_path, monkeypatch, capsys)
    ref = _last_dict(printed)
    if "mode=teacher_forced" in overrides:
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            assert abs(round(got[k], 4) - v) <= 1e-4 * max(abs(v), 1.0), (k, got[k], v)
    else:
        ref.pop("rtf"), got.pop("rtf")
        assert got == ref and got["n_utts"] > 0


def test_generate_pseudo_labels_matches_jax(shared, tmp_path, monkeypatch):
    import csv

    _, rows = _run_both("generate_pseudo_labels", "trans_asr", ["out={side}/pl.csv"], shared,
                        tmp_path, monkeypatch)
    with open(tmp_path / "jax" / "pl.csv") as f:
        ref = list(csv.reader(f))
    with open(tmp_path / "port" / "pl.csv") as f:
        got = list(csv.reader(f))
    assert ref[0] == ["id", "pseudo_text", "ground_truth", "wer"]
    assert got == ref and len(rows) == len(ref) - 1 > 0


@pytest.mark.parametrize("name,config,overrides", [
    ("decode_matrix", "trans_asr", ["langs=en", "snrs=1000", "out={side}/out.json"]),
    ("keyword_stats", "ft", ["out={side}/out.json"]),
], ids=["decode_matrix", "keyword_stats"])
def test_json_recipes_match_jax(name, config, overrides, shared, tmp_path, monkeypatch):
    _, got = _run_both(name, config, overrides, shared, tmp_path, monkeypatch)
    with open(tmp_path / "jax" / "out.json") as f:
        ref = json.load(f)
    with open(tmp_path / "port" / "out.json") as f:
        assert json.load(f) == ref
    assert json.loads(json.dumps(got)) == ref


def test_decode_matrix_noisy_cells_need_a_noise_file(tmp_path):
    from whisper_flamingo_tpu_torch.recipes import decode_matrix

    with pytest.raises(SystemExit, match="noise_fn_val"):
        decode_matrix.main([_smoke("trans_asr"), "device=cpu", "langs=en", "snrs=1000,0",
                            f"out={tmp_path}/m.json"])


def _jax_and_port_models(gated=1, n_langs=1):
    """A JAX debug model and the port's with its weights (on the CPU)."""
    import numpy as np

    from whisper_flamingo_tpu import load_model as jload_model
    from whisper_flamingo_tpu.training.checkpoints import to_torch_state_dict as jto_torch

    from whisper_flamingo_tpu_torch.models.whisper import ModelExtras
    from whisper_flamingo_tpu_torch.training.checkpoints import load_torch_state

    jm = jload_model("debug", add_gated_x_attn=gated, num_langs=n_langs, bert_dim=96, seed=7)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in jto_torch(jm.params, jm.dims).items()}
    from whisper_flamingo_tpu_torch.models.dims import MODEL_DIMS

    model = load_torch_state(sd, MODEL_DIMS["debug"], ModelExtras(
        add_gated_x_attn=gated, num_langs=n_langs, bert_dim=96), device="cpu")
    return jm, model


def test_init_student_from_teacher_copies_what_jax_copies():
    """The student's state dict equals JAX's under the OpenAI keys: the
    teacher's encoder and decoder, no gated weights; the copies own their
    storage."""
    import jax
    import numpy as np

    from whisper_flamingo_tpu.models import whisper as jw
    from whisper_flamingo_tpu.training.checkpoints import to_torch_state_dict as jto_torch

    from whisper_flamingo_tpu_torch.models.whisper import ModelExtras, init_params
    from whisper_flamingo_tpu_torch.recipes.transkd_asr import init_student_from_teacher
    from whisper_flamingo_tpu_torch.training.checkpoints import to_torch_state_dict

    jkd = _jax_recipe("transkd_asr")
    jteacher, teacher = _jax_and_port_models()
    jstudent = jkd.init_student_from_teacher(
        jteacher.params, jw.init_params(jax.random.PRNGKey(1), jteacher.dims, jw.ModelExtras()))
    student = init_student_from_teacher(
        teacher, init_params(torch.Generator().manual_seed(1), teacher.dims, ModelExtras(),
                             device="cpu"))
    ref = jto_torch(jstudent, jteacher.dims)
    got = to_torch_state_dict(student)
    assert not any("gated" in k or k.startswith("decoder.blocks.0.ff") for k in got)
    assert set(ref) <= set(got) and set(got) - set(ref) <= {"encoder.positional_embedding"}
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    with torch.no_grad():
        student.encoder.conv1.weight.add_(1.0)
    assert not torch.equal(student.encoder.conv1.weight, teacher.encoder.conv1.weight)


def test_embed_tokens_as_xt_equals_jax():
    import numpy as np

    from whisper_flamingo_tpu.models import whisper as jw

    from whisper_flamingo_tpu_torch.models.whisper import embed_tokens_as_xt

    jm, model = _jax_and_port_models()
    tokens = np.random.default_rng(0).integers(0, jm.dims.n_vocab, (3, 7))
    ref = np.asarray(jw.embed_tokens_as_xt(jm.params, jm.dims, tokens))
    got = embed_tokens_as_xt(model, model.dims, torch.from_numpy(tokens))
    assert got.shape == (1, 3, 7, model.dims.n_text_state) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def _loaders(config, **kw):
    """JAX's and the port's train loader on a smoke config."""
    import common as jcommon  # the JAX recipes' common module
    from whisper_flamingo_tpu.config import TrainConfig as JC
    from whisper_flamingo_tpu.tokenizer import get_tokenizer as jget_tokenizer

    from whisper_flamingo_tpu_torch.tokenizer import get_tokenizer

    jcfg, cfg = JC.from_yaml(_smoke(config)), TrainConfig.from_yaml(_smoke(config), device="cpu")
    jtok = jget_tokenizer(True, num_languages=99, language="en", task="transcribe")
    tok = get_tokenizer(True, num_languages=99, language="en", task="transcribe")
    return (jcommon.build_loader(jcfg, "train", jtok, training=True, **kw),
            common.build_loader(cfg, "train", tok, training=True, **kw))


@pytest.mark.parametrize("oracle", [False, True])
def test_make_xt_prepare_equals_jax(shared, oracle):
    """One batch of the trilingual smoke loader through both hooks (the
    oracle variant conditions on the transcript, as trans_asr does)."""
    import common as jcommon
    import numpy as np

    _, jcond, cond = shared
    jloader, loader = _loaders("trans_asr_trilingual", translations=True)
    jbatch, batch = next(iter(jloader)), next(iter(loader))
    assert batch["all_translations"] == jbatch["all_translations"]
    if oracle:
        jbatch = dict(jbatch, all_translations=[[t] * 3 for t in jbatch["text"]])
        batch = dict(batch, all_translations=[[t] * 3 for t in batch["text"]])
    ref = jcommon.make_xt_prepare(jcond, 2)(jbatch)["xt"]
    got = common.make_xt_prepare(cond, 2)(batch)["xt"]
    assert tuple(got.shape) == ref.shape and ref.shape[:2] == (2, 2)
    scale = np.abs(ref).max()
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * scale
    assert common.make_xt_prepare(cond, 2)({"text": ["x"]}) == {"text": ["x"]}


def test_prompt_teacher_dataset_equals_jax():
    """The teacher streams over the first translation (the gated smoke
    source carries translations, no prompts), item by item and collated."""
    import numpy as np

    from whisper_flamingo_tpu_torch.recipes.distil_prompt import PromptTeacherDataset

    jloader, loader = _loaders("trans_asr", translations=True)
    jloader.dataset.__class__ = _jax_recipe("distil_prompt").PromptTeacherDataset
    loader.dataset.__class__ = PromptTeacherDataset
    for i in range(len(loader.dataset)):
        ref, got = jloader.dataset[i], loader.dataset[i]
        for key in ("teacher_dec_input_ids", "teacher_labels", "dec_input_ids", "labels"):
            assert got[key] == ref[key], (i, key)
        assert len(got["teacher_dec_input_ids"]) > len(got["dec_input_ids"])
    jbatch, batch = next(iter(jloader)), next(iter(loader))
    for key in ("teacher_dec_input_ids", "teacher_labels", "dec_input_ids", "labels"):
        np.testing.assert_array_equal(batch[key], jbatch[key])
