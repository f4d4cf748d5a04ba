"""The port's trainer on the CPU: fit, top-k checkpoints, bit-identical
resume, and validation metrics against the JAX package's Trainer.

Resume is compared bit for bit (fp32 on the CPU, the same kernels in the
same order); the validation loss 1e-5 relative (fp32, sums in another
order), token accuracy, WER and CER exactly (argmax tokens agree).
"""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from whisper_flamingo_tpu.config import TrainConfig as JConfig
from whisper_flamingo_tpu.data import collator as jcollator
from whisper_flamingo_tpu.data import dataset as jdataset
from whisper_flamingo_tpu.data import samplers as jsamplers
from whisper_flamingo_tpu.models import whisper as jw
from whisper_flamingo_tpu.models.dims import ModelDimensions as JDims
from whisper_flamingo_tpu.tokenizer import get_tokenizer as jget_tokenizer
from whisper_flamingo_tpu.training import steps as jsteps
from whisper_flamingo_tpu.training import trainer as jtrainer

from whisper_flamingo_tpu_torch.config import TrainConfig
from whisper_flamingo_tpu_torch.convert import params_from_jax
from whisper_flamingo_tpu_torch.parallel.mesh import Mesh
from whisper_flamingo_tpu_torch.data.collator import WhisperCollator
from whisper_flamingo_tpu_torch.data.dataset import DataLoader, SpeechDataset, SyntheticAsrSource
from whisper_flamingo_tpu_torch.data.samplers import SortedBatchSampler
from whisper_flamingo_tpu_torch.models import whisper as tw
from whisper_flamingo_tpu_torch.models.dims import ModelDimensions
from whisper_flamingo_tpu_torch.tokenizer import get_tokenizer
from whisper_flamingo_tpu_torch.training.optim import whisper_optimizer
from whisper_flamingo_tpu_torch.training.steps import TrainState, make_ce_train_step, make_eval_step
from whisper_flamingo_tpu_torch.training.trainer import CheckpointManager, Trainer

from test_torch_model import hide_stub_triton  # noqa: F401

TINY = ModelDimensions(
    n_mels=80, n_audio_ctx=128, n_audio_state=64, n_audio_head=2,
    n_audio_layer=1, n_vocab=51865, n_text_ctx=448, n_text_head=2,
    n_text_state=64, n_text_layer=1,
)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(seed=0):
    return tw.init_params(torch.Generator().manual_seed(seed), TINY, device="cpu")


def _loader(tok, n=4, bs=2):
    ds = SpeechDataset(source=SyntheticAsrSource(n=n, max_sec=2.0), tokenizer=tok)
    return DataLoader(ds, SortedBatchSampler(batch_size=bs, shapes=ds.mel_lengths()),
                      WhisperCollator())


def _cfg(tmp_path, **kw):
    return TrainConfig(train_id="smoke", log_output_dir=str(tmp_path / "logs"),
                       check_output_dir=str(tmp_path / "ckpt"), learning_rate=1e-4,
                       num_train_steps=4, validate_every_n_batches=2, monitor="val/loss",
                       device="cpu", **kw)


def _fresh(seed, **opt):
    model = _model(seed)
    tx, _ = whisper_optimizer(model, 1e-3, **opt)
    return TrainState.create(model, tx)


def test_trainer_fit_writes_metrics_and_checkpoints(tmp_path):
    cfg = _cfg(tmp_path)
    tok = get_tokenizer(True, language="en", task="transcribe")
    state = _fresh(0, total_steps=cfg.num_train_steps)
    trainer = Trainer(cfg=cfg, dims=TINY,
                      train_step=make_ce_train_step(TINY, dtype=torch.float32, remat=False),
                      eval_step=make_eval_step(TINY))
    state = trainer.fit(state, _loader(tok), val_loaders={"val": _loader(tok, n=2)},
                        val_max_batches=1, log_every=2)
    assert state.step == 4
    with open(trainer.logger.path) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if "loss" in r] == [2, 4]
    assert {r.get("phase") for r in recs} >= {"preval", "final"}
    assert glob.glob(str(tmp_path / "ckpt" / "smoke" / "step-*.pt"))
    assert os.path.exists(tmp_path / "ckpt" / "smoke" / "last.pt")
    # a mesh is accepted: a 1 x 1 mesh marks the state and shards nothing
    mesh = Mesh(1, 1, 0, {})
    meshed = Trainer(cfg=cfg, dims=TINY, train_step=None, eval_step=None, mesh=mesh)
    assert meshed.shard_state(state) is state and state.model.mesh is mesh
    assert all(p.shape == full.shape for p, full in zip(state.optimizer.params, state.optimizer.mu))


def test_resume_is_bit_identical(tmp_path):
    """Save, restore into a fresh state, continue: parameters, Adam
    moments, the accumulation buffer and counters match an uninterrupted
    run bit for bit (warmup and accumulation make the schedule position
    and the micro-step matter)."""
    tok = get_tokenizer(True, language="en", task="transcribe")
    opt = dict(warmup_steps=3, total_steps=8, accumulate_steps=2)
    step_fn = make_ce_train_step(TINY, dtype=torch.float32, remat=False)
    batches = list(_loader(tok, n=8, bs=2))
    assert len(batches) >= 4

    state_a = _fresh(0, **opt)
    for b in batches[:4]:
        state_a, _ = step_fn(state_a, b)

    mgr = CheckpointManager(str(tmp_path / "ckpt"), monitor="val/loss")
    state_b = _fresh(0, **opt)
    for b in batches[:3]:  # stop between an accumulation and its update
        state_b, _ = step_fn(state_b, b)
    mgr.save(state_b, {"val/loss": 1.0}, state_b.step)

    mgr2 = CheckpointManager(str(tmp_path / "ckpt"), monitor="val/loss")
    state_c = mgr2.restore_last(_fresh(7, **opt))
    assert state_c is not None and state_c.step == 3 and state_c.optimizer.mini_step == 1
    assert mgr2._scores, "top-k scores must survive a manager restart"
    state_c, _ = step_fn(state_c, batches[3])

    pa = dict(state_a.model.named_parameters())
    for name, p in state_c.model.named_parameters():
        assert torch.equal(p, pa[name]), name
    oa, oc = state_a.optimizer, state_c.optimizer
    assert (oa.count, oa.mini_step, state_a.step) == (oc.count, oc.mini_step, state_c.step)
    for key in ("mu", "nu", "acc"):
        for x, y in zip(getattr(oa, key), getattr(oc, key)):
            assert torch.equal(x, y), key


def test_restore_with_another_optimizer_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(_fresh(0), {"val/loss": 1.0}, 0)
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path / "ckpt")).restore_last(_fresh(0, accumulate_steps=4))


def test_top_k_pruning(tmp_path):
    state = _fresh(0)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), monitor="val/loss", save_top_k=2)
    for step, score in ((1, 3.0), (2, 1.0), (3, 2.0), (4, 5.0), (4, 0.5)):
        mgr.save(state, {"val/loss": score}, step)
    names = sorted(os.path.basename(p) for p in glob.glob(str(tmp_path / "ckpt" / "*.pt")))
    assert names == ["last.pt", "step-00000002.pt", "step-00000004.pt"]
    with open(tmp_path / "ckpt" / "last.meta.json") as f:
        meta = json.load(f)
    assert meta["step"] == 4 and [p for _, p in meta["scores"]] == [
        "step-00000004.pt", "step-00000002.pt"]
    assert CheckpointManager(str(tmp_path / "ckpt"), save_top_k=2)._scores == mgr._scores


def test_validate_matches_jax_trainer(tmp_path):
    jdims = JDims(**TINY.to_dict())
    jparams = jax.tree.map(np.asarray, jw.init_params(jax.random.PRNGKey(0), jdims))
    model = tw.Whisper(TINY)
    model.load_state_dict(params_from_jax(jparams, TINY), strict=True)
    tok = get_tokenizer(True, language="en", task="transcribe")
    jtok = jget_tokenizer(True, language="en", task="transcribe")
    jds = jdataset.SpeechDataset(source=jdataset.SyntheticAsrSource(n=4, max_sec=2.0),
                                 tokenizer=jtok)
    jloader = jdataset.DataLoader(jds, jsamplers.SortedBatchSampler(2, jds.mel_lengths()),
                                  jcollator.WhisperCollator())
    cfg = _cfg(tmp_path)
    jcfg = JConfig(train_id="j", log_output_dir=str(tmp_path / "jlogs"),
                   check_output_dir=str(tmp_path / "jckpt"))
    ref = jtrainer.Trainer(cfg=jcfg, dims=jdims, train_step=None,
                           eval_step=jsteps.make_eval_step(jdims)).validate(
        jax.tree.map(np.asarray, jparams), {"val": jloader})
    got = Trainer(cfg=cfg, dims=TINY, train_step=None, eval_step=make_eval_step(TINY)).validate(
        model, {"val": _loader(tok)})
    assert set(got) == set(ref) == {"val/loss", "val/acc", "val/wer", "val/cer"}
    assert got["val/loss"] == pytest.approx(ref["val/loss"], rel=1e-5)
    for key in ("val/acc", "val/wer", "val/cer"):
        assert got[key] == ref[key], key


def test_openai_checkpoint_round_trip(tmp_path):
    """The write side: the parameters under the OpenAI keys in a ``.pt``
    that the read side loads back unchanged."""
    from whisper_flamingo_tpu_torch.training.checkpoints import (
        load_torch_checkpoint,
        save_torch_checkpoint,
        to_torch_state_dict,
    )

    model = _model(3)
    path = str(tmp_path / "m.pt")
    save_torch_checkpoint(model, path)
    loaded, dims = load_torch_checkpoint(path, device="cpu")
    assert dims == TINY
    state = to_torch_state_dict(model)
    assert "decoder.token_embedding.weight" in state
    for name, p in loaded.state_dict().items():
        assert torch.equal(p, state[name]), name
