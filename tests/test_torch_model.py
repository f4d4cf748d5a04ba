"""The PyTorch port's model against the JAX package, on the CPU, in fp32.

Weights cross from the JAX pytree through ``convert.params_from_jax``; the
inputs are numpy-seeded and go through both packages. Tolerances:

- 2e-3 against the committed golden logits, as the JAX package's own
  golden test: the checkpoints are fp16, and the goldens came from the
  original torch model;
- 1e-4 between the two packages at debug dims: both are fp32, and the
  sums (matmul order, conv, the STFT-free attention) are taken in another
  order, which moves logits of size ~5 by a few 1e-6.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_flamingo_tpu.models import whisper as jw
from whisper_flamingo_tpu.models.dims import ModelDimensions as JDims

from whisper_flamingo_tpu_torch.convert import params_from_jax
from whisper_flamingo_tpu_torch.models import whisper as tw
from whisper_flamingo_tpu_torch.models.dims import MODEL_DIMS, ModelDimensions

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
ATOL = 1e-4

# debug dims with d_head 64 in the encoder and the decoder, so the encoder
# takes the flash64 path (its plain version on the CPU)
DIMS64 = ModelDimensions(
    n_mels=80, n_audio_ctx=200, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
    n_vocab=51865, n_text_ctx=64, n_text_head=2, n_text_state=128, n_text_layer=2,
)


@pytest.fixture(autouse=True)
def hide_stub_triton(monkeypatch):
    """The JAX package's reference-parity tests stub ``triton`` into
    ``sys.modules`` (``tests/conftest.py``), and torch's non-reentrant
    checkpoint (remat) asks whether triton is installed: it would take the
    stub for the package. While a port test runs, the stub is hidden and
    torch's cached answer cleared. The port's tests that reach remat import
    this fixture."""
    stubs = [n for n in ("triton", "triton.language")
             if n in sys.modules and getattr(sys.modules[n], "__file__", None) is None]
    from torch.utils import _triton

    for name in stubs:
        monkeypatch.delitem(sys.modules, name)
    if stubs:
        _triton.has_triton_package.cache_clear()
        _triton.has_triton.cache_clear()
    yield
    if stubs:
        _triton.has_triton_package.cache_clear()
        _triton.has_triton.cache_clear()


def port_from_jax(dims, extras_kw=None, seed=0, gate=None):
    """The same random weights in both packages: (jax params, port model).
    ``gate`` opens every gated x-attn gate (and the FFN gate) to that value."""
    extras_kw = extras_kw or {}
    jdims = JDims(**dims.to_dict())
    jparams = jw.init_params(jax.random.PRNGKey(seed), jdims, jw.ModelExtras(**extras_kw))
    jparams = jax.tree.map(np.asarray, jparams)
    if gate is not None:
        g = jparams["decoder"]["blocks"]["gated"]
        g["langs"]["attn_gate"] = np.full_like(g["langs"]["attn_gate"], gate)
        g["ff_gate"] = np.full_like(g["ff_gate"], gate)
    extras = tw.ModelExtras(**extras_kw)
    model = tw.Whisper(dims, extras)
    model.load_state_dict(params_from_jax(jparams, dims, extras), strict=True)
    return jax.tree.map(jnp.asarray, jparams), model.eval()


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDEN, "whisper_tiny_golden.npz"))


def _golden_dims(g):
    return ModelDimensions(**{k[len("dims_"):]: int(g[k]) for k in g.files if k.startswith("dims_")})


def _golden_forward(model, dims, g, xt=None):
    feats = tw.encoder_apply(model, dims, torch.from_numpy(g["mel"]))
    logits, _ = tw.decoder_apply(
        model, dims, torch.from_numpy(g["tokens"]).long(), feats, xt=xt
    )
    return logits.numpy()


@pytest.mark.parametrize("ckpt", ["whisper_tiny.pt", "whisper_tiny_lightning.ckpt"])
def test_golden_plain_checkpoints(golden, ckpt):
    """OpenAI .pt (fp16) and Lightning .ckpt load into the port and
    reproduce the original torch model's logits."""
    from whisper_flamingo_tpu_torch.training.checkpoints import load_torch_checkpoint

    dims = None if ckpt.endswith(".pt") else _golden_dims(golden)
    model, dims = load_torch_checkpoint(os.path.join(GOLDEN, ckpt), dims, device="cpu")
    out = _golden_forward(model, dims, golden)
    np.testing.assert_allclose(out, golden["logits"], atol=2e-3, rtol=2e-3)


def test_golden_gated_checkpoint(golden):
    """The fork's gated checkpoint (gated_x_attn_layers, gates, ff,
    xt_projection) with one stream and non-zero gates."""
    from whisper_flamingo_tpu_torch.training.checkpoints import load_torch_checkpoint

    extras = tw.ModelExtras(add_gated_x_attn=1, bert_dim=int(golden["bert_dim"]), num_langs=1)
    model, dims = load_torch_checkpoint(
        os.path.join(GOLDEN, "whisper_tiny_gated.pt"), extras=extras, device="cpu"
    )
    out = _golden_forward(model, dims, golden, xt=torch.from_numpy(golden["xt"])[None])
    np.testing.assert_allclose(out, golden["gated_logits"], atol=2e-3, rtol=2e-3)


def test_strict_false_keeps_missing_gated_weights_at_init(golden):
    """The plain checkpoint into a gated model: the gates stay zero, so the
    logits are the plain ones."""
    from whisper_flamingo_tpu_torch.training.checkpoints import load_torch_checkpoint

    extras = tw.ModelExtras(add_gated_x_attn=1, bert_dim=int(golden["bert_dim"]), num_langs=1)
    model, dims = load_torch_checkpoint(
        os.path.join(GOLDEN, "whisper_tiny.pt"), extras=extras, device="cpu"
    )
    assert all(b.gated_x_attn_layers[0].attn_gate.item() == 0.0 for b in model.decoder.blocks)
    out = _golden_forward(model, dims, golden, xt=torch.from_numpy(golden["xt"])[None])
    np.testing.assert_allclose(out, golden["logits"], atol=2e-3, rtol=2e-3)


def _inputs(dims, seed=1, b=2, t_mel=400, t_tok=6, xt_dim=None, s=5):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((b, dims.n_mels, t_mel)).astype(np.float32) * 0.5
    tokens = rng.integers(0, dims.n_vocab, (b, t_tok)).astype(np.int32)
    xt = None
    if xt_dim is not None:
        xt = rng.standard_normal((1, b, s, xt_dim)).astype(np.float32)
    return mel, tokens, xt


@pytest.mark.parametrize("dims_name", ["debug", "d_head64"])
def test_encoder_matches_jax(dims_name):
    dims = MODEL_DIMS["debug"] if dims_name == "debug" else DIMS64
    jparams, model = port_from_jax(dims)
    mel, _, _ = _inputs(dims)
    ref = jw.encoder_apply(jparams, JDims(**dims.to_dict()), jnp.asarray(mel))
    got = tw.encoder_apply(model, dims, torch.from_numpy(mel))
    assert got.shape == ref.shape
    _close(got, ref)


CASES = [
    ("plain", {}, None, False),
    ("gated_parallel", dict(add_gated_x_attn=1, num_langs=2, bert_dim=48), 0.6, False),
    ("gated_sequential", dict(add_gated_x_attn=1, num_langs=2, bert_dim=48), 0.6, True),
]


@pytest.mark.parametrize("name,extras_kw,gate,sequential", CASES, ids=[c[0] for c in CASES])
def test_decoder_three_modes_match_jax(name, extras_kw, gate, sequential):
    """Teacher-forced logits, then prefill + incremental cached logits, at
    d_head 64, plain and gated (two streams, parallel and sequential)."""
    dims = DIMS64
    jdims = JDims(**dims.to_dict())
    jparams, model = port_from_jax(dims, extras_kw, gate=gate)
    mel, tokens, xt = _inputs(
        dims, xt_dim=extras_kw.get("bert_dim") if extras_kw else None
    )
    if xt is not None:
        xt = np.concatenate([xt, xt[:, :, ::-1] * 0.5], axis=0)  # two streams
    feats_j = jw.encoder_apply(jparams, jdims, jnp.asarray(mel))
    feats_t = tw.encoder_apply(model, dims, torch.from_numpy(mel))
    xt_j = None if xt is None else jnp.asarray(xt)
    xt_t = None if xt is None else torch.from_numpy(xt.copy())

    ref, _ = jw.decoder_apply(
        jparams, jdims, jnp.asarray(tokens), feats_j, xt=xt_j, sequential_xt=sequential
    )
    got, _ = tw.decoder_apply(
        model, dims, torch.from_numpy(tokens).long(), feats_t, xt=xt_t, sequential_xt=sequential
    )
    _close(got, ref)

    # prefill the first 4 tokens, then two incremental steps
    cache_j = jw.init_cache(jparams, jdims, feats_j, xt=xt_j, max_len=16)
    cache_t = tw.init_cache(model, dims, feats_t, xt=xt_t, max_len=16)
    n0 = 4
    lj, cache_j = jw.decoder_apply(
        jparams, jdims, jnp.asarray(tokens[:, :n0]), cache=cache_j, offset=0,
        sequential_xt=sequential,
    )
    lt, cache_t = tw.decoder_apply(
        model, dims, torch.from_numpy(tokens[:, :n0]).long(), cache=cache_t, offset=0,
        sequential_xt=sequential,
    )
    _close(lt, lj)
    _close(lt, ref[:, :n0])
    for i in range(n0, tokens.shape[1]):
        lj, cache_j = jw.decoder_apply(
            jparams, jdims, jnp.asarray(tokens[:, i: i + 1]), cache=cache_j, offset=i,
            sequential_xt=sequential,
        )
        lt, cache_t = tw.decoder_apply(
            model, dims, torch.from_numpy(tokens[:, i: i + 1]).long(), cache=cache_t,
            offset=i, sequential_xt=sequential,
        )
        _close(lt, lj)
        _close(lt[:, 0], np.asarray(ref)[:, i])
    _close(cache_t["k"], cache_j["k"])
    _close(cache_t["v"], cache_j["v"])


def test_init_params_distributions():
    """Seeded init: the JAX package's shapes and scales, zero gates."""
    dims = MODEL_DIMS["debug"]
    gen = torch.Generator().manual_seed(0)
    extras = tw.ModelExtras(add_gated_x_attn=1, num_langs=1, bert_dim=32)
    model = tw.init_params(gen, dims, extras, device="cpu")
    again = tw.init_params(torch.Generator().manual_seed(0), dims, extras, device="cpu")
    for (k, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), k
    w = model.decoder.blocks[0].attn.query.weight
    assert abs(w.std().item() - 1 / np.sqrt(dims.n_text_state)) < 0.02
    assert model.decoder.blocks[0].gated_x_attn_layers[0].attn_gate.item() == 0.0
    assert model.decoder.xt_projection.weight.shape == (dims.n_text_state, 32)


def test_load_model_from_path_and_offline_fallback(golden):
    """``load_model`` takes a checkpoint path (dims from the file), and for
    a size without a local ``<name>.pt`` warns and initializes randomly."""
    import warnings

    import whisper_flamingo_tpu_torch as wt

    model = wt.load_model(os.path.join(GOLDEN, "whisper_tiny.pt"), device="cpu")
    assert model.dims == _golden_dims(golden)
    out = _golden_forward(model, model.dims, golden)
    np.testing.assert_allclose(out, golden["logits"], atol=2e-3, rtol=2e-3)

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tiny = wt.load_model("tiny", device="cpu", seed=3)
    assert any("random initialization" in str(x.message) for x in w)
    assert tiny.dims == MODEL_DIMS["tiny"] and tiny.alignment_heads.shape == (4, 6)
    with pytest.raises(RuntimeError, match="not found"):
        wt.load_model("no-such-size", device="cpu")
