"""The port's Adafactor against the JAX package's (optax 0.2.6's
``adafactor`` chained with the scheduled decoupled decay), on the CPU.

At ``tiny``'s widths (d 384, 6 heads; 2 + 2 layers and a 4,096-token
vocabulary so it stays quick),
where the projections, the MLPs, the token embedding and the gated
stream's weights are factored and every stacked leaf has more than one
layer (and, gated, two streams), so the block RMS over a whole stacked
leaf is exercised. The same numpy gradients go to both; after 5 applied
updates every parameter is within 1e-6 of the largest magnitude of its
own total update. That runs in float64 on both sides (JAX under
``jax.enable_x64``): in float32 the two frameworks' statistics, summed in
other orders, differ in the last bits, and ``p + u`` can then round to
the neighbouring float of a parameter near 1 (one ulp, 1.2e-7), more than
1e-6 of a small update. In float32 every parameter is held to the AdamW
test's rule instead (1e-6 of its largest magnitude, floored at 1).
The recipe's train losses agree within 1e-5 relative, a resumed run is
bit-equal to an uninterrupted one, and a 1 x 2 and a 2 x 1 gloo mesh
match one rank within 1e-6 of the largest update.
"""

import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from whisper_flamingo_tpu.models import whisper as jw
from whisper_flamingo_tpu.models.dims import ModelDimensions as JDims
from whisper_flamingo_tpu.training import optim as jopt

from whisper_flamingo_tpu_torch import convert
from whisper_flamingo_tpu_torch.convert import params_from_jax
from whisper_flamingo_tpu_torch.models import whisper as tw
from whisper_flamingo_tpu_torch.models.dims import ModelDimensions
from whisper_flamingo_tpu_torch.recipes import whisper_ft
from whisper_flamingo_tpu_torch.training import optim

from test_torch_model import hide_stub_triton  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "smoke", "ft.yaml")
RECIPES_DIR = os.path.join(ROOT, "recipes")

DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=50, n_audio_state=384, n_audio_head=6, n_audio_layer=2,
    n_vocab=4096, n_text_ctx=64, n_text_head=6, n_text_state=384, n_text_layer=2,
)
JDIMS = JDims(**DIMS.to_dict())
GATED = dict(add_gated_x_attn=1, num_langs=2, bert_dim=256)
STEPS = 5
REL = 1e-6


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    """JAX's ``load_model`` of a named model tries the hub first: refuse at
    once (there are no weights to fetch), so it takes its random init."""
    from whisper_flamingo_tpu import registry

    def refuse(*args, **kwargs):
        raise RuntimeError("no network: pretrained weights are not fetched")

    monkeypatch.setattr(registry, "download_checkpoint", refuse)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(extras_kw):
    jparams = jax.tree.map(
        np.asarray, jw.init_params(jax.random.PRNGKey(0), JDIMS, jw.ModelExtras(**extras_kw)))
    extras = tw.ModelExtras(**extras_kw)
    model = tw.Whisper(DIMS, extras)
    model.load_state_dict(params_from_jax(jparams, DIMS, extras), strict=True)
    return jparams, model, extras


def _grads(rng, jparams):
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.01).astype(np.float32),
                        jparams)


CASES = {
    # the gated stream with its stacked (layer, stream) leaves, decay, warmup
    "flamingo_wd_warmup": dict(gated=True, kw=dict(weight_decay=0.1, warmup_steps=2,
                                                  total_steps=20, train_xt_projection=True)),
    # every parameter, the no-decay split, two mini-steps per update
    "whisper_accumulate2": dict(gated=False, kw=dict(weight_decay=0.01, warmup_steps=1,
                                                    total_steps=20, accumulate_steps=2)),
    # every parameter, clipped by the global norm first
    "whisper_max_grad_norm": dict(gated=False, kw=dict(weight_decay=0.01, total_steps=20,
                                                      max_grad_norm=0.5)),
}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_adafactor_matches_optax_on_the_same_gradients(case, dtype, monkeypatch):
    spec = CASES[case]
    wide = dtype == "float64"
    jparams, model, extras = _pair(GATED if spec["gated"] else {})
    if wide:  # both packages in float64; the conversion keeps the dtype
        jparams = jax.tree.map(lambda a: a.astype(np.float64), jparams)
        model.double()
        monkeypatch.setattr(convert, "_t", lambda a: torch.tensor(np.asarray(a)))
    build, jbuild = ((optim.whisper_flamingo_optimizer, jopt.whisper_flamingo_optimizer)
                     if spec["gated"] else (optim.whisper_optimizer, jopt.whisper_optimizer))
    lr = 1e-2
    ttx, _ = build(model, lr, optimizer="adafactor", **spec["kw"])
    assert isinstance(ttx, optim.Adafactor)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    rng = np.random.default_rng(5)
    k = spec["kw"].get("accumulate_steps", 1)
    with jax.enable_x64(wide):
        tx, _ = jbuild(jparams, lr, optimizer="adafactor", **spec["kw"])
        params = jax.tree.map(jnp.asarray, jparams)
        opt_state = tx.init(params)
        update = jax.jit(tx.update)
        for _ in range(STEPS * k):
            grads = jax.tree.map(lambda g, a: g.astype(a.dtype), _grads(rng, jparams),
                                 jparams)
            updates, opt_state = update(jax.tree.map(jnp.asarray, grads), opt_state, params)
            params = optax.apply_updates(params, updates)
            tgrads = params_from_jax(grads, DIMS, extras)
            for n, p in model.named_parameters():
                if p.requires_grad:
                    p.grad = tgrads[n].clone()
            ttx.step()
        want = params_from_jax(jax.tree.map(np.asarray, params), DIMS, extras)
    assert ttx.count == STEPS and ttx.mini_step == 0
    assert any(f is not None for f in ttx.factored)
    moved = 0
    for n, p in model.named_parameters():
        assert p.dtype == want[n].dtype, n
        total = (want[n] - before[n]).abs().max().item()
        err = (p.detach() - want[n]).abs().max().item()
        tol = REL * (total if wide else max(want[n].abs().max().item(), 1.0))
        assert err <= tol, (n, err, total)
        moved += total > 0
        if not p.requires_grad:
            assert torch.equal(p, before[n]), n
    assert moved == len(ttx.names)


def test_factored_state_matches_optax_layout():
    """The port's per-layer ``v_row`` / ``v_col`` are optax's stacked
    statistics, layer by layer (in the JAX leaf's axis order)."""
    jparams, model, extras = _pair({})
    tx, _ = jopt.whisper_optimizer(jparams, 1e-2, optimizer="adafactor", total_steps=10)
    ttx, _ = optim.whisper_optimizer(model, 1e-2, optimizer="adafactor", total_steps=10)
    params = jax.tree.map(jnp.asarray, jparams)
    grads = _grads(np.random.default_rng(1), jparams)
    _, opt_state = jax.jit(tx.update)(jax.tree.map(jnp.asarray, grads), tx.init(params), params)
    tgrads = params_from_jax(grads, DIMS, extras)
    for n, p in model.named_parameters():
        p.grad = tgrads[n].clone()
    ttx.step()
    (fs,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.FactoredState))
        if isinstance(s, optax.FactoredState)]
    jrow = np.asarray(fs.v_row["decoder"]["blocks"]["mlp"]["fc1"]["w"])  # (L, d): over 4d
    jcol = np.asarray(fs.v_col["decoder"]["blocks"]["mlp"]["fc1"]["w"])  # (L, 4d): over d
    for layer in range(DIMS.n_text_layer):
        i = ttx.names.index(f"decoder.blocks.{layer}.mlp.0.weight")  # torch (4d, d)
        np.testing.assert_allclose(ttx.v_row[i].reshape(-1).numpy(), jrow[layer], rtol=1e-6)
        np.testing.assert_allclose(ttx.v_col[i].reshape(-1).numpy(), jcol[layer], rtol=1e-6)
    emb = ttx.names.index("decoder.token_embedding.weight")
    np.testing.assert_allclose(ttx.v_row[emb].reshape(-1).numpy(),
                               np.asarray(fs.v_row["decoder"]["token_embedding"]), rtol=1e-6)
    # the factored state is a small fraction of AdamW's two moments
    n_params = sum(p.numel() for p in ttx.params)
    assert ttx.state_bytes() < 0.05 * 8 * n_params


def test_adam_epsilon_warns_as_jax_does():
    model = tw.Whisper(DIMS)
    with pytest.warns(UserWarning, match="adam_epsilon"):
        optim.whisper_optimizer(model, 1e-3, optimizer="adafactor", adam_epsilon=1e-6)
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.whisper_optimizer(model, 1e-3, optimizer="lion")


# -- end to end: the recipe against JAX's, resume, the mesh ------------------

def _records(log_dir, train_id):
    with open(os.path.join(log_dir, f"{train_id}.metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _losses(log_dir, train_id):
    return {r["step"]: r["loss"] for r in _records(log_dir, train_id) if "loss" in r}


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """JAX's random ``tiny`` as an OpenAI-keyed checkpoint both recipes load."""
    from whisper_flamingo_tpu.models.dims import MODEL_DIMS as JMODEL_DIMS
    from whisper_flamingo_tpu.training.checkpoints import to_torch_state_dict as jto_torch

    tmp = tmp_path_factory.mktemp("adafactor")
    jdims = JMODEL_DIMS["tiny"]
    params = jw.init_params(jax.random.PRNGKey(7), jdims)
    path = str(tmp / "tiny.pt")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in jto_torch(params, jdims).items()},
               path)
    return path


def _ft_args(tmp, name, ckpt, *extra):
    return [SMOKE, "model_name=tiny", f"pt_ckpt={ckpt}", "optimizer=adafactor",
            "weight_decay=0.01", f"train_id={name}", f"log_output_dir={tmp}/logs",
            f"check_output_dir={tmp}/ckpt", *extra]


def test_whisper_ft_adafactor_losses_match_the_jax_recipe(tiny_ckpt, tmp_path):
    """``whisper_ft optimizer=adafactor`` at ``tiny`` (factored statistics
    on the embedding, projections and MLPs) in both packages from one
    checkpoint: the train losses of 3 steps agree within 1e-5 relative."""
    import importlib.util

    from whisper_flamingo_tpu.training import trainer as jtrainer

    if RECIPES_DIR not in sys.path:  # the JAX recipes import their `common`
        sys.path.insert(0, RECIPES_DIR)
    spec = importlib.util.spec_from_file_location(
        "jax_recipe_whisper_ft_adafactor", os.path.join(RECIPES_DIR, "whisper_ft.py"))
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    extra = ("num_train_steps=3", "validate_every_n_batches=100")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jtrainer.Trainer, "fit",
                   functools.partialmethod(jtrainer.Trainer.fit, log_every=1))
        mp.chdir(ROOT)
        mp.setattr(sys, "argv", ["whisper_ft", *_ft_args(tmp_path / "jax", "ft", tiny_ckpt, *extra)])
        jmod.main()
    finally:
        mp.undo()
    state = whisper_ft.main([*_ft_args(tmp_path / "port", "ft", tiny_ckpt, *extra),
                             "device=cpu", "log_every=1"])
    assert isinstance(state.optimizer, optim.Adafactor) and state.optimizer.count == 3
    jl, pl = _losses(tmp_path / "jax" / "logs", "ft"), _losses(tmp_path / "port" / "logs", "ft")
    assert sorted(jl) == sorted(pl) == [1, 2, 3]
    for step in jl:
        np.testing.assert_allclose(pl[step], jl[step], rtol=1e-5, err_msg=str(step))


def test_adafactor_resume_is_bit_identical(tiny_ckpt, tmp_path):
    """``whisper_ft`` stopped at step 4 of 6 and resumed from ``last.pt``
    (the factored state in the checkpoint) ends with the parameters and
    statistics of an uninterrupted run, bit for bit."""
    common = ("num_train_steps=6", "warmup_steps=2", "device=cpu", "log_every=1",
              "validate_every_n_batches=100")
    whisper_ft.main([*_ft_args(tmp_path, "a", tiny_ckpt, *common), "max_steps=4"])
    resumed = whisper_ft.main([*_ft_args(tmp_path, "a", tiny_ckpt, *common),
                               "resume_training=True"])
    straight = whisper_ft.main(_ft_args(tmp_path, "b", tiny_ckpt, *common))
    assert resumed.step == straight.step == 6
    sp = dict(straight.model.named_parameters())
    for name, p in resumed.model.named_parameters():
        assert torch.equal(p, sp[name]), name
    ra, rb = resumed.optimizer, straight.optimizer
    assert ra.count == rb.count == 6
    for key in ra.STATE:
        for x, y in zip(getattr(ra, key), getattr(rb, key)):
            assert torch.equal(x, y), key
    la, lb = _losses(tmp_path / "logs", "a"), _losses(tmp_path / "logs", "b")
    assert [la[s] for s in (5, 6)] == [lb[s] for s in (5, 6)]


MESH_DIMS = dict(n_mels=80, n_audio_ctx=50, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
                 n_vocab=4096, n_text_ctx=64, n_text_head=2, n_text_state=128, n_text_layer=2)


def test_adafactor_on_a_mesh_matches_one_rank(tmp_path):
    """Two float64 Adafactor updates (decay, clipping) from the same full
    gradients on a 1 x 2 mesh (every split linear and the split vocabulary:
    the row and column means and block RMS that span a split dim sum over
    the model axis) and on a 2 x 1 mesh (the data-parallel average) match
    one rank: parameters within 1e-6 of each one's largest total update,
    the gathered factored state within 1e-9 relative."""
    from whisper_flamingo_tpu_torch.parallel.distributed import spawn

    import torch_parallel_workers as workers

    dims = ModelDimensions(**MESH_DIMS)
    model = tw.init_params(torch.Generator().manual_seed(3), dims, device="cpu")
    path = str(tmp_path / "state.pt")
    torch.save(model.state_dict(), path)
    rng = np.random.default_rng(0)
    grads = [{n: rng.standard_normal(p.shape) * 0.01 for n, p in model.named_parameters()}
             for _ in range(2)]
    spec = dict(body="adafactor", dims=MESH_DIMS, state=path, grads=grads, max_grad_norm=1.0)
    (one,) = spawn(workers.run, 1, ([dict(spec, mesh=None)],))[0]
    before = {n: p.detach().double().numpy() for n, p in model.named_parameters()}
    for shape in ((1, 2), (2, 1)):
        for (res,) in spawn(workers.run, 2, ([dict(spec, mesh=shape)],)):
            for n, want in one["params"].items():
                total = np.abs(want - before[n]).max()
                err = np.abs(res["params"][n] - want).max()
                assert total > 0 and err <= 1e-6 * total, (shape, n, err, total)
            for key in ("v_row", "v_col", "v"):
                for a, b in zip(res[key], one[key]):
                    np.testing.assert_allclose(a, b, rtol=1e-9, atol=0)


@pytest.mark.parametrize("optimizer", ["adafactor", "adamw"])
def test_flagship_probe_rung_on_the_cpu(optimizer):
    """The flagship probe's rung at the debug dims on the CPU: finite
    losses, the teacher and the student's frozen encoder keep their bits,
    the state bytes are the optimizer's (AdamW 8 per trainable parameter;
    Adafactor 4 at the debug width, where nothing is factored, plus its two
    (1,) placeholders per tensor)."""
    from whisper_flamingo_tpu_torch.tools import transkd_flagship_probe as probe

    res = probe.run_config("debug", "debug", 1, optimizer, steps=1, device="cpu")
    assert res["losses_finite"] and res["teacher_unchanged"] and res["student_encoder_unchanged"]
    assert res["share_feats"] and res["peak_gb"] is None and len(res["losses"]) == 2
    n = res["trainable_params"]
    if optimizer == "adamw":
        assert res["optimizer_state_bytes"] == 8 * n
    else:
        assert 4 * n < res["optimizer_state_bytes"] <= 4 * n + 8 * 200
    assert res["flash64_fwd_launches_per_step"] == 0  # the CPU runs the plain versions
