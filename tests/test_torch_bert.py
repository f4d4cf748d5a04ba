"""The port's text conditioner against the JAX package's, on the CPU.

The same weights (a ``FlaxBertModel``'s params carried across by
``bert_params_from_flax``) and the same strings go through both. The last
hidden state agrees at every position, padded ones included (they feed
``xt``), within 1e-5 of its largest magnitude (fp32 sums in another
order, and Flax's one-pass LayerNorm variance). The HF weight converter is
held against ``transformers``' own PyTorch BERT: its state dict, and the
``pytorch_model.bin`` its ``save_pretrained`` writes, with its forward as a
second reference.
"""

import os
import sys

import numpy as np
import pytest
import torch
from transformers import BertConfig, FlaxBertModel

from whisper_flamingo_tpu.config import TrainConfig as JConfig
from whisper_flamingo_tpu.models import bert as jbert

from whisper_flamingo_tpu_torch.config import TrainConfig
from whisper_flamingo_tpu_torch.models import bert
from whisper_flamingo_tpu_torch.recipes import common

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(ROOT, "recipes") not in sys.path:  # the JAX recipes import `common`
    sys.path.insert(0, os.path.join(ROOT, "recipes"))

REL = 1e-5

# ASCII, CJK (three UTF-8 bytes a character) and strings past max_length
TEXTS = ["hello world", "a longer sentence for testing", "你好，世界", "x" * 70,
         "ünïcödé ascii mix 漢字", ""]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= REL * scale, np.abs(got - ref).max() / scale


@pytest.mark.parametrize("heads,hidden", [(2, 96), (4, 64)], ids=["offline", "4head"])
def test_bert_model_matches_flax(heads, hidden):
    """Rows of lengths 13, 9, 4 and 1 padded to 16: every position."""
    cfg = BertConfig(vocab_size=1024, hidden_size=hidden, num_hidden_layers=2,
                     num_attention_heads=heads, intermediate_size=256,
                     max_position_embeddings=64)
    flax = FlaxBertModel(cfg, seed=3)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 1024, (4, 16)).astype(np.int32)
    mask = np.zeros((4, 16), np.int32)
    for i, n in enumerate((13, 9, 4, 1)):
        mask[i, :n] = 1
    ref = flax.module.apply({"params": flax.params}, ids, mask, np.zeros_like(ids),
                            np.broadcast_to(np.arange(16)[None], ids.shape)).last_hidden_state
    dims = bert.BertDims(vocab_size=1024, hidden_size=hidden, num_hidden_layers=2,
                         num_attention_heads=heads, intermediate_size=256,
                         max_position_embeddings=64)
    model = bert.BertModel(dims)
    model.load_state_dict(bert.bert_params_from_flax(flax.params))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    _close(got.numpy(), ref)


def _hf_torch(flax, cls="BertModel"):
    """``transformers``' own PyTorch ``cls`` (``BertModel`` or
    ``BertForPreTraining``, whose keys carry the ``bert.`` prefix and the
    pre-training heads of a published ``pytorch_model.bin``) with the Flax
    model's weights, carried by ``transformers``' own converter."""
    import transformers
    from transformers.modeling_flax_pytorch_utils import load_flax_weights_in_pytorch_model

    model = getattr(transformers, cls)(flax.config).eval()
    load_flax_weights_in_pytorch_model(getattr(model, "bert", model), flax.params)
    return model


def _legacy(sd):
    """``sd`` under the older ``LayerNorm.gamma`` / ``beta`` names (as
    ``bert-base-chinese``'s ``pytorch_model.bin`` stores them)."""
    return {k.replace("LayerNorm.weight", "LayerNorm.gamma").replace("LayerNorm.bias",
                                                                     "LayerNorm.beta"): v
            for k, v in sd.items()}


@pytest.mark.parametrize("legacy", [False, True], ids=["names", "gamma_beta"])
def test_bert_state_from_hf_equals_the_flax_carrier(legacy):
    """HF's PyTorch ``BertModel``'s state dict, under a ``bert.`` prefix,
    through ``bert_state_from_hf``: the same tensors as
    ``bert_params_from_flax`` gives, and the same last hidden state as HF's
    PyTorch forward and Flax's."""
    flax = FlaxBertModel(BertConfig(vocab_size=1024, hidden_size=96, num_hidden_layers=2,
                                    num_attention_heads=2, intermediate_size=256,
                                    max_position_embeddings=64), seed=4)
    hf = _hf_torch(flax)
    sd = {f"bert.{k}": v for k, v in hf.state_dict().items()}
    from_hf = bert.bert_state_from_hf(_legacy(sd) if legacy else sd)
    from_flax = bert.bert_params_from_flax(flax.params)
    model = bert.BertModel(bert.BertDims(1024, 96, 2, 2, 256, 64))
    assert sorted(from_hf) == sorted(from_flax) == sorted(model.state_dict())
    for key, value in from_flax.items():
        assert torch.equal(from_hf[key], value), key
    model.load_state_dict(from_hf)
    ids = np.random.default_rng(2).integers(0, 1024, (2, 12)).astype(np.int64)
    mask = np.ones_like(ids)
    mask[1, 7:] = 0
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        ref_hf = hf(input_ids=torch.from_numpy(ids),
                    attention_mask=torch.from_numpy(mask)).last_hidden_state.numpy()
    ref = flax.module.apply({"params": flax.params}, ids, mask, np.zeros_like(ids),
                            np.broadcast_to(np.arange(12)[None], ids.shape)).last_hidden_state
    _close(got, ref_hf)
    _close(got, ref)


@pytest.fixture(scope="module")
def pair():
    """The JAX conditioner and the port's (on the CPU) with its weights."""
    jax_cond = jbert.HFBertConditioner(pretrained=False, max_length=64, pad_multiple=8)
    cond = bert.HFBertConditioner(pretrained=False, max_length=64, pad_multiple=8, device="cpu")
    cond.model.load_state_dict(bert.bert_params_from_flax(jax_cond.model.params))
    return jax_cond, cond


@pytest.mark.parametrize("texts", [TEXTS[:2], TEXTS[2:4], TEXTS, ["short"]],
                         ids=["ascii", "cjk+long", "all", "one"])
def test_encode_matches_jax(pair, texts):
    """Shape (the bucketed S, capped at max_length) and values."""
    jax_cond, cond = pair
    ref = jax_cond.encode(texts)
    got = cond.encode(texts)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == ref.shape
    _close(got.numpy(), ref)


def test_encode_multi_matches_jax(pair):
    jax_cond, cond = pair
    streams = [["bonjour", "monde entier"], ["hallo", "ganze welt hier, länger als die andere"]]
    ref = jax_cond.encode_multi(streams)
    got = cond.encode_multi(streams)
    assert tuple(got.shape) == ref.shape and got.shape[:2] == (2, 2)
    _close(got.numpy(), ref)


def test_max_length_caps_the_bucket(pair):
    _, cond = pair
    assert cond.encode(["y" * 200]).shape == (1, 64, 96)  # cut to max_length
    assert cond.encode(["abc"]).shape == (1, 8, 96)


# tests/test_bert.py's four cases, on the port's conditioner

def test_bert_conditioner_shapes(pair):
    _, cond = pair
    out = cond.encode(["hello world", "a longer sentence for testing"])
    assert out.ndim == 3 and out.shape[0] == 2
    assert out.shape[2] == cond.dim
    assert out.shape[1] % 8 == 0
    assert torch.isfinite(out).all()


def test_bert_conditioner_multi(pair):
    _, cond = pair
    multi = cond.encode_multi([["bonjour", "monde entier"], ["hallo", "ganze welt hier"]])
    assert multi.shape[0] == 2 and multi.shape[1] == 2
    assert multi.shape[3] == cond.dim


def test_bert_deterministic(pair):
    _, cond = pair
    assert torch.equal(cond.encode(["same text"]), cond.encode(["same text"]))


def test_precomputed_conditioner():
    rng = np.random.default_rng(0)
    texts = ["foo bar", "baz"]
    store = {bert.PrecomputedConditioner.key(t): rng.standard_normal((5 + i, 16)).astype(np.float32)
             for i, t in enumerate(texts)}
    cond = bert.PrecomputedConditioner(store, dim=16, device="cpu")
    out = cond.encode(texts)
    assert out.shape == (2, 6, 16)
    np.testing.assert_array_equal(out[0, :5].numpy(), store[cond.key(texts[0])])
    assert (out[0, 5] == 0).all()


@pytest.mark.parametrize("max_length", [64, 5])
def test_precomputed_conditioner_equals_jax(max_length):
    rng = np.random.default_rng(1)
    store = {bert.PrecomputedConditioner.key(t): rng.standard_normal((3 + 2 * i, 8))
             .astype(np.float32) for i, t in enumerate(TEXTS)}
    assert bert.PrecomputedConditioner.key("x") == jbert.PrecomputedConditioner.key("x")
    ref = jbert.PrecomputedConditioner(store, 8, max_length).encode_multi([TEXTS[:3], TEXTS[3:]])
    got = bert.PrecomputedConditioner(store, 8, max_length, device="cpu").encode_multi(
        [TEXTS[:3], TEXTS[3:]])
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("max_length", [64, 8])
def test_byte_tokenizer_equals_jax(max_length):
    ref = jbert._ByteTokenizer(1024)(TEXTS, max_length=max_length)
    got = bert._ByteTokenizer(1024)(TEXTS, max_length=max_length)
    for key in ("input_ids", "attention_mask"):
        assert got[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(got[key], ref[key])


def test_build_conditioner_checks_bert_dim(tmp_path, monkeypatch):
    """With no HF cache the offline BERT is 96 wide unless ``bert_dim``
    names a width: ``bert_dim: 0`` fails at build time with the same
    message in both packages, ``bert_dim: 96`` builds."""
    import common as jcommon  # the JAX recipes' common module

    monkeypatch.setenv("HF_HOME", str(tmp_path))
    extras = {"bert_pretrained": False}
    for build, cfg in ((common.build_conditioner, TrainConfig(device="cpu", extras=extras)),
                       (jcommon.build_conditioner, JConfig(extras=extras))):
        cfg.bert_dim = 0
        with pytest.raises(ValueError, match="emits 96-dim states but the config says "
                                             "bert_dim=0; set bert_dim to the conditioner's "
                                             "true width"):
            build(cfg)
        cfg.bert_dim = 96
        assert build(cfg).dim == 96


def _write_pretrained(tmp_path, flax):
    """A local pretrained directory as ``transformers`` writes one:
    ``BertForPreTraining.save_pretrained`` (config.json and
    pytorch_model.bin) with the Flax model's weights, and a WordPiece
    vocabulary. Returns the directory and the HF PyTorch model."""
    import json

    hf = _hf_torch(flax, "BertForPreTraining")
    hf.save_pretrained(tmp_path, safe_serialization=False)
    assert (tmp_path / "pytorch_model.bin").is_file()
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "hello", "world", "speech", "##s"]
    (tmp_path / "vocab.txt").write_text("\n".join(words) + "\n")
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({"do_lower_case": True}))
    return str(tmp_path), hf


def test_pretrained_conditioner_from_a_local_directory(tmp_path):
    """``pretrained=True`` reads the widths from config.json, the weights
    through ``bert_state_from_hf`` and the tokenizer from the directory:
    its states equal Flax's and HF's PyTorch model's on the same ids."""
    flax = FlaxBertModel(BertConfig(vocab_size=1024, hidden_size=64, num_hidden_layers=2,
                                    num_attention_heads=4, intermediate_size=128,
                                    max_position_embeddings=64), seed=5)
    local, hf = _write_pretrained(tmp_path, flax)
    assert bert.BertDims.from_config_json(f"{local}/config.json") == bert.BertDims(
        1024, 64, 2, 4, 128, 64)
    cond = bert.HFBertConditioner(local, max_length=64, pad_multiple=8, device="cpu")
    assert cond.dim == 64
    texts = ["hello world", "speechs hello unknownword"]
    ids, mask = cond.tokenize(texts)
    assert ids.shape == (2, 8) and ids[0, 0] == 2 and mask.sum() == 4 + 6
    ref = flax.module.apply({"params": flax.params}, ids, mask, np.zeros_like(ids),
                            np.broadcast_to(np.arange(8)[None], ids.shape)).last_hidden_state
    with torch.no_grad():
        ref_hf = hf.bert(input_ids=torch.from_numpy(ids).long(),
                         attention_mask=torch.from_numpy(mask).long()).last_hidden_state
    got = cond.encode(texts).numpy()
    _close(got, ref)
    _close(got, ref_hf.numpy())
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        bert.HFBertConditioner(str(tmp_path / "missing"), device="cpu")
