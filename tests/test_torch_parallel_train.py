"""The port's train steps under a (data, model) mesh of gloo ranks on the
CPU, against the JAX package's steps under its mesh (conftest's 8 virtual
CPU devices) and against one rank.

Weights come from JAX ``init_params`` (gates at 0.5, so the conditioning
stream moves the loss) through ``convert.params_from_jax``; the batches
are numpy from seeds. JAX's gradients come out of its step through an
optax transform that keeps them as its state. Tolerances are JAX's own:
losses to 1e-4 relative, gradients to 1e-4 of each tensor's largest
magnitude. ``TINY`` has the odd 51,865-token vocabulary (replicated under
2 model ranks); ``TINY_EN`` the English 51,864 (split, so the
vocabulary-parallel lookup, cross-entropy and gather run).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from whisper_flamingo_tpu.models.dims import ModelDimensions as JDims
from whisper_flamingo_tpu.models.whisper import ModelExtras as JExtras
from whisper_flamingo_tpu.models.whisper import init_params as jinit
from whisper_flamingo_tpu.parallel import mesh as jmesh
from whisper_flamingo_tpu.training import steps as jsteps
from whisper_flamingo_tpu.training.trainer import _device_batch

from whisper_flamingo_tpu_torch.convert import params_from_jax
from whisper_flamingo_tpu_torch.models.dims import ModelDimensions
from whisper_flamingo_tpu_torch.models.whisper import ModelExtras
from whisper_flamingo_tpu_torch.parallel.distributed import spawn

import torch_parallel_workers as workers

TINY = dict(n_mels=80, n_audio_ctx=50, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
            n_vocab=51865, n_text_ctx=448, n_text_head=2, n_text_state=64, n_text_layer=2)
TINY_EN = dict(TINY, n_vocab=51864)
GATED = dict(add_gated_x_attn=1, num_langs=1, bert_dim=96)
LOSS_REL, GRAD_REL = 1e-4, 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(dims, extras, seed):
    params = jinit(jax.random.PRNGKey(seed), JDims(**dims), JExtras(**extras))
    if extras:
        gated = params["decoder"]["blocks"]["gated"]
        gated["langs"]["attn_gate"] = jnp.full_like(gated["langs"]["attn_gate"], 0.5)
        gated["ff_gate"] = jnp.full_like(gated["ff_gate"], 0.5)
    return params


def _save(params, dims, extras, path):
    sd = params_from_jax(jax.tree.map(np.asarray, params), ModelDimensions(**dims),
                         ModelExtras(**extras))
    torch.save(sd, path)
    return str(path)


def _batch(b, seed=0, xt=False, prompt=False):
    rng = np.random.default_rng(seed)
    dec = rng.integers(0, 1000, size=(b, 8)).astype(np.int32)
    labels = np.roll(dec, -1, axis=1).astype(np.int32)
    labels[:, -1] = 50256
    labels[0, -2:] = -100  # a padded row end
    out = {"input_ids": rng.standard_normal((b, 80, 100)).astype(np.float32),
           "dec_input_ids": dec, "labels": labels}
    if xt:
        out["xt"] = rng.standard_normal((1, b, 4, 96)).astype(np.float32)
    if prompt:
        out["teacher_dec_input_ids"] = rng.integers(0, 1000, size=(b, 12)).astype(np.int32)
        out["teacher_labels"] = np.concatenate(
            [np.full((b, 4), -100, np.int32), labels], axis=1)
    return out


def _capture():
    """An optax transform whose state after a step is that step's gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _jax_step(kind, dims, extras, params, batch, shape, teacher=None, use_xt=False):
    """(loss, port-keyed full gradients) of one JAX step, on a (data, model)
    mesh of the virtual devices or on one device (``shape`` None)."""
    jd = JDims(**dims)
    tx = _capture()
    if kind == "ce":
        step = jsteps.make_ce_train_step(jd, tx, use_xt=use_xt, dtype=jnp.float32, remat=False,
                                         donate=False)
        args = lambda p, t, b: (jsteps.TrainState.create(p, tx), b)  # noqa: E731
    elif kind == "kd":
        step = jsteps.make_kd_train_step(jd, tx, teacher_uses_xt=False, dtype=jnp.float32,
                                         remat=False, donate=False)
        args = lambda p, t, b: (jsteps.TrainState.create(p, tx), t, b)  # noqa: E731
    else:
        step = jsteps.make_prompt_kd_train_step(jd, tx, dtype=jnp.float32, remat=False)
        args = lambda p, t, b: (jsteps.TrainState.create(p, tx), t, b)  # noqa: E731
    if shape is None:
        state, metrics = step(*args(params, teacher, batch))
    else:
        mesh = jmesh.make_mesh(*shape, devices=jax.devices()[: shape[0] * shape[1]])
        with jax.set_mesh(mesh):
            sp = jmesh.shard_params(params, mesh)
            st = None if teacher is None else jmesh.shard_params(teacher, mesh)
            state, metrics = step(*args(sp, st, _device_batch(batch, mesh)))
    grads = params_from_jax(jax.tree.map(np.asarray, state.opt_state), ModelDimensions(**dims),
                            ModelExtras(**extras))
    return float(metrics["loss"]), {k: v.numpy() for k, v in grads.items()}


CASES = {
    # name: (kind, dims, extras, mesh, rows, optimizer, batch kwargs)
    "ce_4x1": ("ce", TINY, {}, (4, 1), 8, None, {}),
    "ce_2x2": ("ce", TINY, {}, (2, 2), 8, None, {}),
    # the Flamingo step with xt on a ragged batch: 5 rows over 2 data ranks
    "flamingo_ragged_2x2": ("ce", TINY_EN, GATED, (2, 2), 5, "flamingo", {"xt": True}),
    "eval_ragged_4x1": ("eval", TINY, {}, (4, 1), 5, None, {}),
}


def run_cases(tmp, cases):
    """Every case on four gloo ranks (one process group), on one rank, and
    the JAX references."""
    paths = {}

    def weights(dims, extras, seed):
        """(JAX params, the port's state file) per (dims, extras, seed), once."""
        key = (dims["n_vocab"], bool(extras), seed)
        if key not in paths:
            params = _params(dims, extras, seed)
            paths[key] = (params, _save(params, dims, extras, tmp / f"{len(paths)}.pt"))
        return paths[key]

    specs, refs_in = {}, {}
    for name, (kind, dims, extras, shape, rows, opt, bkw) in cases.items():
        distill = kind in ("kd", "prompt_kd")
        student = weights(dims, extras, 1 if distill else 0)
        teacher = weights(dims, {}, 2) if distill else None
        spec = {"body": "train", "kind": kind, "dims": dims, "extras": extras, "mesh": shape,
                "state": student[1], "batch": _batch(rows, **bkw), "optimizer": opt,
                "use_xt": bool(extras), "max_grad_norm": 0.5 if opt == "flamingo" else None}
        if teacher is not None:
            spec["teacher"] = teacher[1]
        specs[name] = spec
        refs_in[name] = (student[0], None if teacher is None else teacher[0])
    ranks = spawn(workers.run, 4, (list(specs.values()),))
    port = {name: [r[i] for r in ranks] for i, name in enumerate(specs)}
    one = {name: workers.train(dict(spec, mesh=None), None) for name, spec in specs.items()}
    ref = {}
    for name, (kind, dims, extras, shape, rows, opt, bkw) in cases.items():
        if kind == "eval":
            continue
        params, teacher = refs_in[name]
        # JAX's prompt-KD step runs on one device (its mesh path is JAX's to test)
        ref[name] = _jax_step(kind, dims, extras, params, specs[name]["batch"],
                              None if kind == "prompt_kd" else shape, teacher, use_xt=bool(extras))
    return specs, port, one, ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("parallel_train"), CASES)


def _close_grads(got, want, names=None):
    for name in names or got:
        g, w = got[name], want[name]
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= GRAD_REL * scale, (name, err, scale)


def check_step(runs, name):
    specs, port, one, ref = runs
    jloss, jgrads = ref[name]
    for r in port[name]:
        np.testing.assert_allclose(r["loss"], one[name]["loss"], rtol=LOSS_REL)
        np.testing.assert_allclose(r["loss"], jloss, rtol=LOSS_REL)
        assert sorted(r["grads"]) == sorted(one[name]["grads"])
        _close_grads(r["grads"], one[name]["grads"])
        _close_grads(r["grads"], jgrads)
    if name.startswith("flamingo"):  # only the gated group trains
        assert all(".gated_x_attn_layers." in n or ".ff" in n for n in port[name][0]["grads"])


def check_replicated_bit_equal(runs, name):
    specs, port, one, ref = runs
    by_row = {}
    for r in port[name]:
        by_row.setdefault(r["data_index"], []).append(r["local_replicated"])
    for row in by_row.values():
        assert row[0].keys() == row[1].keys() and row[0]
        for n in row[0]:
            np.testing.assert_array_equal(row[0][n], row[1][n], err_msg=f"{name} {n}")


@pytest.mark.parametrize("name", ["ce_4x1", "ce_2x2", "flamingo_ragged_2x2"])
def test_step_matches_jax_mesh_and_one_rank(runs, name):
    check_step(runs, name)


def test_ragged_batch_loss_equals_the_unpadded_batch(runs):
    """5 rows over 2 data ranks (xt's batch axis second): the padded row
    carries labels -100 and drops out; loss and gradients are the unpadded
    batch's on one rank."""
    specs, port, one, ref = runs
    assert specs["flamingo_ragged_2x2"]["batch"]["xt"].shape[1] == 5
    for r in port["flamingo_ragged_2x2"]:
        np.testing.assert_allclose(r["loss"], one["flamingo_ragged_2x2"]["loss"], rtol=LOSS_REL)
        _close_grads(r["grads"], one["flamingo_ragged_2x2"]["grads"])


def test_ragged_eval_loss_and_predictions(runs):
    specs, port, one, ref = runs
    for r in port["eval_ragged_4x1"]:
        np.testing.assert_allclose(r["loss"], one["eval_ragged_4x1"]["loss"], rtol=1e-6)
        assert r["preds"].shape[0] == 8  # padded to the data axis
        np.testing.assert_array_equal(r["preds"][:5], one["eval_ragged_4x1"]["preds"])


@pytest.mark.parametrize("name", ["ce_2x2", "flamingo_ragged_2x2"])
def test_replicated_gradients_are_bit_equal_across_a_model_row(runs, name):
    """copy-to-TP and the all-reduces give every rank of a model row the
    same bits of each replicated parameter's gradient."""
    check_replicated_bit_equal(runs, name)


def test_clip_reads_the_global_norm(runs):
    """max_grad_norm 0.5 clips the Flamingo step's gradients: the sharded
    clip scales them as one device does."""
    specs, port, one, ref = runs
    want = one["flamingo_ragged_2x2"]["clipped"]
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                       for g in one["flamingo_ragged_2x2"]["grads"].values()))
    assert norm > 0.5, norm  # the case clips
    for r in port["flamingo_ragged_2x2"]:
        _close_grads(r["clipped"], want)


def test_one_by_one_mesh_is_bit_equal_to_no_mesh(runs, tmp_path):
    specs, port, one, ref = runs
    spec = dict(specs["ce_2x2"], max_grad_norm=1.0)
    (res,) = spawn(workers.one_by_one, 1, (spec,))
    assert res["mesh"]["loss"] == res["none"]["loss"]
    for n, g in res["none"]["grads"].items():
        np.testing.assert_array_equal(res["mesh"]["grads"][n], g)
        np.testing.assert_array_equal(res["mesh"]["clipped"][n], res["none"]["clipped"][n])


def test_a_failed_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn(workers.fail_on_rank, 2, (1,))


def test_jax_mesh_batch_padding_matches_the_port(runs):
    """The port's per-rank rows of a ragged batch with ``xt``, stacked in
    data order, are JAX ``_device_batch``'s padded global batch."""
    from whisper_flamingo_tpu_torch.parallel.mesh import Mesh, shard_batch

    batch = _batch(7, xt=True, prompt=True)
    mesh = jmesh.make_mesh(2, 1, devices=jax.devices()[:2])
    with jax.set_mesh(mesh):
        padded = {k: np.asarray(v) for k, v in _device_batch(batch, mesh).items()}
    assert jmesh.batch_pspec(batch)["xt"] == P(None, "data")
    rows = [shard_batch(batch, Mesh(2, 1, r, {})) for r in (0, 1)]
    assert set(rows[0]) == set(padded)
    for k, v in padded.items():
        axis = 1 if k == "xt" else 0
        np.testing.assert_array_equal(np.concatenate([rows[0][k], rows[1][k]], axis=axis), v)
    assert (padded["labels"][7:] == -100).all() and (padded["teacher_labels"][7:] == -100).all()
    assert rows[0]["xt"].shape[1] == rows[1]["xt"].shape[1] == 4
