"""The port's legacy modules against the JAX package, on the CPU, in fp32:
ResNet1D, the reprogramming layer (``_m1`` and ``_m2`` sources), the LSTM
layer, AdaIN, AdaKWS and ``load_adakws_torch``. The same weights go into
both packages; outputs agree within 1e-5 of the largest magnitude (fp32
sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_flamingo_tpu.models import legacy as jl

from whisper_flamingo_tpu_torch.models import legacy as tl

REL = 1e-5
KWS = dict(d_model=32, embed_dim=16, hidden_dim=24, dim_ff=48)


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


def _np(x):
    return np.array(x, np.float32)


def test_resnet1d_matches_jax():
    """Random BatchNorm statistics; the weights carried from the JAX tree."""
    rng = np.random.default_rng(0)
    jp = jax.tree.map(np.asarray, jl.init_resnet1d(jax.random.PRNGKey(0), 32, 48, 2))
    model = tl.ResNet1D(32, 48, 2)
    state = {}
    for i, blk in enumerate(jp["layers"]):
        for conv, idx in (("conv1", 0), ("conv2", 3)):
            w = blk[conv]["w"].transpose(2, 1, 0).copy()
            state[f"layers.{i}.{idx}.weight"] = torch.from_numpy(w)
            state[f"layers.{i}.{idx}.bias"] = torch.from_numpy(_np(blk[conv]["b"]))
        for bn, idx in (("bn1", 1), ("bn2", 4)):
            c = blk[bn]["scale"].shape[0]
            blk[bn] = {"scale": rng.uniform(0.5, 1.5, c), "bias": rng.normal(0, 0.3, c),
                       "mean": rng.normal(0, 0.3, c), "var": rng.uniform(0.5, 2.0, c)}
            blk[bn] = {k: v.astype(np.float32) for k, v in blk[bn].items()}
            for ours, theirs in (("weight", "scale"), ("bias", "bias"),
                                 ("running_mean", "mean"), ("running_var", "var")):
                state[f"layers.{i}.{idx}.{ours}"] = torch.from_numpy(blk[bn][theirs])
            state[f"layers.{i}.{idx}.num_batches_tracked"] = torch.tensor(0)
    model.load_state_dict(state, strict=True)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    ref = jl.resnet1d_apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    got = tl.resnet1d_apply(model, torch.from_numpy(x))
    _close(got, ref)
    assert torch.equal(tl.resnet1d_apply(model.train(), torch.from_numpy(x)), got)


def _reprogramming_pair(d_model=32, n_heads=4, d_llm=48):
    jp = jax.tree.map(np.asarray, jl.init_reprogramming(jax.random.PRNGKey(0), d_model, n_heads,
                                                        d_llm=d_llm))
    model = tl.Reprogramming(d_model, n_heads, d_llm=d_llm)
    model.load_state_dict({
        f"{name}.{ours}": torch.from_numpy(_np(jp[name][theirs]).T.copy() if theirs == "w"
                                           else _np(jp[name][theirs]))
        for name in ("q", "k", "v", "out") for ours, theirs in (("weight", "w"), ("bias", "b"))})
    return jax.tree.map(jnp.asarray, jp), model


@pytest.mark.parametrize("variant", ["m1_shared_source", "m2_batched_source"])
def test_reprogramming_matches_jax(variant):
    jp, model = _reprogramming_pair()
    rng = np.random.default_rng(1)
    target = rng.standard_normal((2, 5, 32)).astype(np.float32)
    shape = (11, 48) if variant.startswith("m1") else (2, 11, 48)
    src = rng.standard_normal(shape).astype(np.float32)
    val = rng.standard_normal(shape).astype(np.float32)
    ref = jl.reprogramming_apply(jp, jnp.asarray(target), jnp.asarray(src), jnp.asarray(val), 4)
    got = tl.reprogramming_apply(model, torch.from_numpy(target), torch.from_numpy(src),
                                 torch.from_numpy(val), 4)
    assert got.shape == (2, 5, 48)
    _close(got, ref)


def test_lstm_layer_and_adain_match_jax():
    rng = np.random.default_rng(2)
    lstm = torch.nn.LSTM(6, 5, 2, batch_first=True).requires_grad_(False)
    xs = rng.standard_normal((3, 7, 6)).astype(np.float32)
    jp = {"w_ih": jnp.asarray(lstm.weight_ih_l0.numpy().T),
          "w_hh": jnp.asarray(lstm.weight_hh_l0.numpy().T),
          "b": jnp.asarray((lstm.bias_ih_l0 + lstm.bias_hh_l0).numpy())}
    ref_out, ref_h = jl._lstm_layer(jp, jnp.asarray(xs))
    out, h = tl.lstm_layer(lstm, 0, torch.from_numpy(xs))
    _close(out, ref_out)
    _close(h, ref_h)
    # torch's own LSTM computes the same recurrence
    one = torch.nn.LSTM(6, 5, 1, batch_first=True).requires_grad_(False)
    one.load_state_dict({k: v for k, v in lstm.state_dict().items() if k.endswith("l0")})
    torch.testing.assert_close(one(torch.from_numpy(xs))[0], out, atol=1e-6, rtol=0)

    z = rng.standard_normal((4, 9, 8)).astype(np.float32)
    mu = rng.standard_normal((4, 1, 8)).astype(np.float32)
    sigma = rng.standard_normal((4, 1, 8)).astype(np.float32)
    _close(tl.adain(torch.from_numpy(z), torch.from_numpy(mu), torch.from_numpy(sigma)),
           jl.adain(jnp.asarray(z), jnp.asarray(mu), jnp.asarray(sigma)))


@pytest.mark.parametrize("prefixed", [False, True], ids=["plain_keys", "text_encoder_keys"])
def test_adakws_through_both_loaders_matches_jax(prefixed):
    """One torch AdaKWS state (the port's module keys, which are the
    reference's) through JAX's and the port's ``load_adakws_torch``; the
    reference prefixes the LSTM's keys with ``text_encoder.``."""
    src = tl.init_adakws(torch.Generator().manual_seed(3), 64, device="cpu", **KWS)
    state = {(f"text_encoder.{k}" if prefixed and k.startswith(("embedding", "lstm")) else k):
             v.numpy() for k, v in src.state_dict().items()}
    jp = jl.load_adakws_torch(state, 64, **KWS)
    model = tl.load_adakws_torch(state, 64, device="cpu", **KWS)
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    rng = np.random.default_rng(4)
    audio = rng.standard_normal((2, 10, 32)).astype(np.float32)
    keywords = rng.integers(0, 64, (2, 3, 6)).astype(np.int32)
    ref = jl.adakws_apply(jp, jnp.asarray(audio), jnp.asarray(keywords))
    got = tl.adakws_apply(model, torch.from_numpy(audio), torch.from_numpy(keywords))
    assert got.shape == (2, 3, 2)
    _close(got, ref)


def test_adakws_at_default_widths_matches_jax():
    """d_model 768, embed 128, hidden 256, 4 LSTM layers, FFN 2048: the
    widths ``chip_smoke.py`` runs on the card."""
    src = tl.init_adakws(torch.Generator().manual_seed(5), 40, device="cpu")
    state = {k: v.numpy() for k, v in src.state_dict().items()}
    jp = jl.load_adakws_torch(state, 40)
    rng = np.random.default_rng(6)
    audio = rng.standard_normal((1, 20, 768)).astype(np.float32)
    keywords = rng.integers(0, 40, (1, 2, 5)).astype(np.int32)
    _close(tl.adakws_apply(src, torch.from_numpy(audio), torch.from_numpy(keywords)),
           jl.adakws_apply(jp, jnp.asarray(audio), jnp.asarray(keywords)))


def test_inits_have_the_jax_layout():
    """Each init gives the JAX init's shapes, biases and BatchNorms."""
    gen = torch.Generator().manual_seed(0)
    res = tl.init_resnet1d(gen, 32, 48, 2, device="cpu")
    jres = jl.init_resnet1d(jax.random.PRNGKey(0), 32, 48, 2)
    for i, blk in enumerate(jres["layers"]):
        assert tuple(res.layers[i][0].weight.shape) == blk["conv1"]["w"].shape[::-1]
        assert torch.all(res.layers[i][0].bias == 0)
        assert torch.all(res.layers[i][1].running_var == 1)
    rep = tl.init_reprogramming(gen, 32, 4, d_llm=48, device="cpu")
    jrep = jl.init_reprogramming(jax.random.PRNGKey(0), 32, 4, d_llm=48)
    for name in ("q", "k", "v", "out"):
        assert tuple(getattr(rep, name).weight.shape) == jrep[name]["w"].shape[::-1]
    kws = tl.init_adakws(gen, 64, device="cpu", **KWS)
    jkws = jl.init_adakws(jax.random.PRNGKey(0), 64, **KWS)
    assert tuple(kws.embedding.weight.shape) == jkws["embedding"].shape
    assert kws.lstm.num_layers == len(jkws["lstm"])
    assert torch.all(kws.lstm.bias_ih_l0 == 0) and torch.all(kws.classifier.bias == 0)
    assert tuple(kws.kw_module1.fc1.weight.shape) == jkws["kw1"]["fc1"]["w"].shape[::-1]
    assert not any(p.requires_grad for m in (res, rep, kws) for p in m.parameters())
