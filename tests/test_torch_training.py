"""The port's training steps and optimizer against the JAX package, on the
CPU, in fp32.

Dims with d_head 64 (``n_audio_state=128, n_audio_head=2``, 2 + 2 layers),
so the encoder runs flash64's plain forward with lse and plain backward.
Weights, gradients and Adam moments cross through ``convert.params_from_jax``
and are compared by OpenAI key. Tolerances:

- losses 1e-5 relative (fp32, sums in another order);
- gradients 1e-4 of each tensor's largest magnitude (or of 1 where that
  is smaller): fp32 backward passes through two frameworks' kernels;
- the optimizer fed the same gradients as optax: parameters and Adam
  moments after three updates 1e-6 of each tensor's largest magnitude (of
  1 for parameters where that is smaller: biases start at 0);
- after whole train steps, where the two backward passes give gradients
  that agree to ~1e-6 of their largest magnitude: Adam moments 1e-5 of
  each tensor's largest magnitude, parameters 2e-4 absolute, a fifth of
  one step at lr 1e-3 (Adam's g / (|g| + 1e-8) moves elements whose
  gradient is within fp32 noise of 1e-8 by a fraction of the learning
  rate);
- the learning-rate sequence exactly (both are float32 schedules of one
  formula).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from whisper_flamingo_tpu.models import whisper as jw
from whisper_flamingo_tpu.models.dims import ModelDimensions as JDims
from whisper_flamingo_tpu.training import optim as jopt
from whisper_flamingo_tpu.training import steps as jsteps

from whisper_flamingo_tpu_torch.convert import params_from_jax
from whisper_flamingo_tpu_torch.models import whisper as tw
from whisper_flamingo_tpu_torch.models.dims import ModelDimensions
from whisper_flamingo_tpu_torch.training import optim, steps

from test_torch_model import hide_stub_triton  # noqa: F401

DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=50, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
    n_vocab=51865, n_text_ctx=64, n_text_head=2, n_text_state=128, n_text_layer=2,
)
JDIMS = JDims(**DIMS.to_dict())
F32 = jnp.float32


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(extras_kw=None, seed=0):
    """The same random weights in both packages: (numpy jax tree, port model)."""
    extras_kw = extras_kw or {}
    jparams = jax.tree.map(
        np.asarray, jw.init_params(jax.random.PRNGKey(seed), JDIMS, jw.ModelExtras(**extras_kw))
    )
    extras = tw.ModelExtras(**extras_kw)
    model = tw.Whisper(DIMS, extras)
    model.load_state_dict(params_from_jax(jparams, DIMS, extras), strict=True)
    return jparams, model, extras


def _batch(seed=0, b=2, t=8, frames=100):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((b, 80, frames)).astype(np.float32)
    dec = rng.integers(0, 1000, size=(b, t)).astype(np.int32)
    labels = np.roll(dec, -1, axis=1).astype(np.int32)
    labels[:, -1] = 50257
    labels[1, -2:] = -100
    return {"input_ids": mel, "dec_input_ids": dec, "labels": labels}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close_by_key(got: dict, ref_tree, extras, rel, what, atol=None):
    """Every tensor within ``rel`` of its largest magnitude (floored at 1
    for gradients and parameters), or within ``atol``."""
    ref = params_from_jax(jax.tree.map(np.asarray, ref_tree), DIMS, extras)
    assert set(got) == set(ref), what
    for key, r in ref.items():
        a = got[key].detach().float()
        scale = max(r.abs().max().item(), 1.0 if what in ("grad", "param") else 0.0)
        err = (a - r).abs().max().item()
        tol = atol if atol is not None else rel * max(scale, 1e-30)
        assert err <= tol, (what, key, err, scale)


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    s, t = (rng.standard_normal((2, 5, 40)).astype(np.float32) * 3 for _ in range(2))
    labels = rng.integers(0, 40, (2, 5)).astype(np.int32)
    labels[0, 3:] = -100
    ce_ref = float(jsteps.ce_loss(jnp.asarray(s), jnp.asarray(labels)))
    kd_ref = float(jsteps.kd_kl_loss(jnp.asarray(s), jnp.asarray(t), jnp.asarray(labels), 2.0))
    ts, tt, tl = torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(labels).long()
    assert steps.ce_loss(ts, tl).item() == pytest.approx(ce_ref, rel=1e-5)
    assert steps.kd_kl_loss(ts, tt, tl, 2.0).item() == pytest.approx(kd_ref, rel=1e-5)
    # all positions ignored: zero, not NaN
    assert steps.ce_loss(ts, torch.full_like(tl, -100)).item() == 0.0


def test_ce_step_loss_and_every_gradient_match_jax():
    jparams, model, extras = _pair()
    batch = _batch()
    jb = _jbatch(batch)

    def loss_fn(p):
        feats = jw.encoder_apply(p, JDIMS, jb["input_ids"], dtype=F32)
        logits, _ = jw.decoder_apply(p, JDIMS, jb["dec_input_ids"], feats, dtype=F32)
        return jsteps.ce_loss(logits, jb["labels"])

    jloss, jgrads = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, jparams))
    optim.whisper_optimizer(model, 1e-3)  # marks every parameter trainable
    b = steps.to_device(batch, model.device)
    feats = tw.encoder_apply(model, DIMS, b["input_ids"])
    logits, _ = tw.decoder_apply(model, DIMS, b["dec_input_ids"], feats)
    loss = steps.ce_loss(logits, b["labels"])
    loss.backward()
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    _close_by_key({n: p.grad for n, p in model.named_parameters()}, jgrads, extras, 1e-4, "grad")


def _adam_state(opt_state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return adam


@pytest.mark.parametrize("accumulate,clip", [(1, None), (2, 0.05)])
def test_optimizer_matches_optax_on_the_same_gradients(accumulate, clip):
    """Three applied updates (warmup, decay split, and in the second case
    MultiSteps accumulation and global-norm clipping) from the same
    gradients: parameters and Adam moments as optax's."""
    jparams, model, extras = _pair()
    kw = dict(warmup_steps=1, total_steps=10, max_grad_norm=clip, accumulate_steps=accumulate)
    tx, _ = jopt.whisper_optimizer(jparams, 1e-3, **kw)
    ttx, _ = optim.whisper_optimizer(model, 1e-3, **kw)
    params = jax.tree.map(jnp.asarray, jparams)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(11)
    for _ in range(3 * accumulate):
        grads = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * 0.01).astype(np.float32), jparams)
        updates, opt_state = update(jax.tree.map(jnp.asarray, grads), opt_state, params)
        params = optax.apply_updates(params, updates)
        tgrads = params_from_jax(grads, DIMS, extras)
        for n, p in model.named_parameters():
            p.grad = tgrads[n].clone()
        ttx.step()
    assert ttx.count == 3 and ttx.mini_step == 0
    _close_by_key(dict(model.named_parameters()), params, extras, 1e-6, "param")
    adam = _adam_state(opt_state)
    for name, mine in (("mu", ttx.mu), ("nu", ttx.nu)):
        _close_by_key(dict(zip(ttx.names, mine)), getattr(adam, name), extras, 1e-6, name)


def test_three_steps_params_and_adam_moments_match_optax():
    jparams, model, extras = _pair()
    tx, _ = jopt.whisper_optimizer(jparams, 1e-3, warmup_steps=1, total_steps=10)
    jstep = jsteps.make_ce_train_step(JDIMS, tx, dtype=F32, remat=False, donate=False)
    jstate = jsteps.TrainState.create(jax.tree.map(jnp.asarray, jparams), tx)
    ttx, _ = optim.whisper_optimizer(model, 1e-3, warmup_steps=1, total_steps=10)
    state = steps.TrainState.create(model, ttx)
    step = steps.make_ce_train_step(DIMS, dtype=torch.float32, remat=False)
    for i in range(3):
        batch = _batch(seed=i)
        jstate, jm = jstep(jstate, _jbatch(batch))
        state, m = step(state, batch)
        assert m["loss"].item() == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert state.step == 3 and ttx.count == 3
    _close_by_key(dict(model.named_parameters()), jstate.params, extras, None, "param", atol=2e-4)
    adam = _adam_state(jstate.opt_state)
    for name, mine in (("mu", ttx.mu), ("nu", ttx.nu)):
        _close_by_key(dict(zip(ttx.names, mine)), getattr(adam, name), extras, 1e-5, name)


def test_remat_full_gives_the_same_step():
    """remat trades memory only: one step with "full", and one with the
    selective "dots", equals one with "none" bit for bit on the CPU."""
    out = []
    for remat in ("none", "full", "dots"):
        _, model, _ = _pair()
        tx, _ = optim.whisper_optimizer(model, 1e-3)
        state, m = steps.make_ce_train_step(DIMS, dtype=torch.float32, remat=remat)(
            steps.TrainState.create(model, tx), _batch())
        out.append((m["loss"].item(), [p.detach().clone() for p in model.parameters()]))
    for loss, params in out[1:]:
        assert loss == out[0][0]
        assert all(torch.equal(a, b) for a, b in zip(out[0][1], params))
    with pytest.raises(ValueError):
        tw._remat_wrap(lambda x: x, "save_only_these_names")


def test_freeze_encoder_leaves_the_encoder_unchanged():
    _, model, _ = _pair()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    tx, _ = optim.whisper_optimizer(model, 1e-3, trainable_mask=optim.encoder_frozen_mask(model))
    assert not any(p.requires_grad for n, p in model.named_parameters() if n.startswith("encoder."))
    step = steps.make_ce_train_step(DIMS, freeze_encoder=True, dtype=torch.float32, remat=False)
    step(steps.TrainState.create(model, tx), _batch())
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]) == n.startswith("encoder."), n


def test_gated_only_training_with_numpy_xt():
    """The Flamingo optimizer trains only the gated subtree; the
    conditioning stream arrives as a numpy array."""
    kw = dict(add_gated_x_attn=1, num_langs=1, bert_dim=96)
    _, model, _ = _pair(kw)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    tx, _ = optim.whisper_flamingo_optimizer(model, 1e-3)
    batch = dict(_batch(), xt=np.random.default_rng(1).standard_normal((1, 2, 6, 96)).astype(np.float32))
    step = steps.make_ce_train_step(DIMS, use_xt=True, dtype=torch.float32, remat=False)
    state, m = step(steps.TrainState.create(model, tx), batch)
    assert np.isfinite(m["loss"].item())
    moved = {n for n, p in model.named_parameters() if not torch.equal(p, before[n])}
    gated = {n for n, t in optim.flamingo_trainable_mask(model).items() if t}
    assert moved and moved <= gated
    assert all("gated_x_attn_layers" in n or ".ff" in n for n in gated)
    assert {n for n in gated if n.endswith("attn_gate") or n.endswith("ff_gate")} <= moved


def test_gradient_accumulation():
    """optax.MultiSteps twin: parameters change only every k micro-steps;
    the schedule and Adam count advance on applied updates only, the
    state's step on every call."""
    _, model, _ = _pair()
    tx, _ = optim.whisper_optimizer(model, 1e-3, total_steps=100, accumulate_steps=2)
    step = steps.make_ce_train_step(DIMS, dtype=torch.float32, remat=False)
    state = steps.TrainState.create(model, tx)
    before = model.decoder.ln.weight.detach().clone()
    state, _ = step(state, _batch())
    assert torch.equal(model.decoder.ln.weight, before)
    assert (state.step, tx.count, tx.mini_step) == (1, 0, 1)
    state, _ = step(state, _batch())
    assert (model.decoder.ln.weight - before).abs().max().item() > 0
    assert (state.step, tx.count, tx.mini_step) == (2, 1, 0)


def test_no_decay_mask_matches_jax():
    kw = dict(add_gated_x_attn=1, num_langs=2, bert_dim=96)
    jparams, model, extras = _pair(kw)
    mask = jax.tree.map(lambda m, a: np.full(a.shape, m, np.float32),
                        jopt.no_decay_mask(jparams), jparams)
    ref = params_from_jax(mask, DIMS, extras)
    got = optim.no_decay_mask(model)
    assert got == {k: bool(v.flatten()[0].item()) for k, v in ref.items()}
    assert got["decoder.positional_embedding"] and got["decoder.blocks.0.ff_gate"]
    assert not got["decoder.blocks.0.attn_ln.weight"] and not got["encoder.conv1.bias"]


@pytest.mark.parametrize("warmup", [0, 3])
def test_lr_sequence_equals_optax(warmup):
    jsched = jopt.linear_warmup_schedule(1e-3, warmup, 10)
    sched = optim.linear_warmup_schedule(1e-3, warmup, 10)
    for c in range(13):
        assert sched(c) == float(np.asarray(jsched(jnp.int32(c)))), c


def _prompt_batch(seed=5):
    batch = _batch(seed)
    prefix = np.asarray([[50361, 11, 12, 13]] * 2, np.int32)
    batch["teacher_dec_input_ids"] = np.concatenate([prefix, batch["dec_input_ids"]], axis=1)
    batch["teacher_labels"] = np.concatenate(
        [np.full_like(prefix, -100), batch["labels"]], axis=1)
    return batch


@pytest.mark.parametrize("kind", ["kd", "prompt_kd"])
def test_kd_steps_match_jax(kind):
    jparams, model, extras = _pair()
    jteacher, teacher, _ = _pair(seed=1)
    tx, _ = jopt.whisper_optimizer(jparams, 1e-3, total_steps=10)
    ttx, _ = optim.whisper_optimizer(model, 1e-3, total_steps=10)
    if kind == "kd":
        batch = _batch(4)
        jstep = jsteps.make_kd_train_step(JDIMS, tx, teacher_uses_xt=False, dtype=F32, remat=False)
        step = steps.make_kd_train_step(DIMS, teacher_uses_xt=False, dtype=torch.float32,
                                        remat=False)
    else:
        batch = _prompt_batch()
        jstep = jsteps.make_prompt_kd_train_step(JDIMS, tx, dtype=F32, remat=False)
        step = steps.make_prompt_kd_train_step(DIMS, dtype=torch.float32, remat=False)
    jstate, jm = jstep(jsteps.TrainState.create(jax.tree.map(jnp.asarray, jparams), tx),
                       jax.tree.map(jnp.asarray, jteacher), _jbatch(batch))
    state, m = step(steps.TrainState.create(model, ttx), teacher, batch)
    for key in ("loss", "ce", "kd"):
        assert m[key].item() == pytest.approx(float(jm[key]), rel=1e-5), key
    _close_by_key(dict(model.named_parameters()), jstate.params, extras, None, "param", atol=2e-4)


def test_cast_frozen_bf16_keeps_the_bf16_forward():
    """bf16 frozen masters leave the bf16-compute forward bit-identical;
    LayerNorm and the embeddings stay fp32."""
    _, model, _ = _pair()
    batch = steps.to_device(_batch(), torch.device("cpu"))

    def fwd():
        feats = tw.encoder_apply(model, DIMS, batch["input_ids"], dtype=torch.bfloat16)
        return tw.decoder_apply(model, DIMS, batch["dec_input_ids"], feats,
                                dtype=torch.bfloat16)[0]

    ref = fwd()
    steps.cast_frozen_bf16(model, {n: False for n, _ in model.named_parameters()})
    assert model.decoder.token_embedding.weight.dtype == torch.float32
    assert model.decoder.ln.weight.dtype == torch.float32
    assert model.decoder.blocks[0].attn.query.weight.dtype == torch.bfloat16
    assert torch.equal(fwd(), ref)


def test_decode_and_transcribe_build_no_graph():
    """With parameters that require grad, the decode entry points still
    run without autograd: no result carries a grad_fn."""
    import whisper_flamingo_tpu_torch as wt

    model = wt.load_model("debug", device="cpu")
    model.requires_grad_(True)
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 80, 3000)).astype(np.float32))
    (res,) = wt.decode(model, mel, wt.DecodingOptions(language="en", fp16=False, sample_len=4))
    assert not isinstance(res.audio_features, torch.Tensor) or res.audio_features.grad_fn is None
    feats = tw.encoder_apply(model, model.dims, mel)
    assert feats.grad_fn is not None  # the training path does build one
    cache = tw.init_cache(model, model.dims, feats)
    assert all(v.grad_fn is None for v in cache.values())
    logits, _ = tw.decoder_apply(model, model.dims, torch.tensor([[50258]]), cache=cache)
    assert logits.grad_fn is None
    out = wt.transcribe(model, np.zeros(16000 * 3, np.float32), language="en",
                        temperature=0.0, word_timestamps=True, fp16=False,
                        condition_on_previous_text=False, sample_len=4)
    assert isinstance(out["text"], str)


def test_model_flops_match_jax():
    from whisper_flamingo_tpu import profiling as jprof

    from whisper_flamingo_tpu_torch import profiling
    from whisper_flamingo_tpu_torch.models.dims import MODEL_DIMS

    for name in ("small", "large-v2"):
        dims = MODEL_DIMS[name]
        args = (8, 3000, 128, 1, 64)
        assert profiling.model_flops(dims, *args) == jprof.model_flops(
            JDims(**dims.to_dict()), *args)
    assert profiling.mfu(989e12) == 1.0
