"""The port's mesh layer on the CPU: the tensor-parallel table against the
JAX package's ``param_pspecs``, sharding and gathering, the collectives,
the bootstrap's errors and the multi-rank dry run (gloo ranks)."""

import jax
import numpy as np
import pytest
import torch

from whisper_flamingo_tpu.models.dims import MODEL_DIMS as JMODEL_DIMS
from whisper_flamingo_tpu.models.dims import ModelDimensions as JDims
from whisper_flamingo_tpu.models.whisper import ModelExtras as JExtras
from whisper_flamingo_tpu.models.whisper import init_params as jinit
from whisper_flamingo_tpu.parallel import mesh as jmesh

from whisper_flamingo_tpu_torch.models.dims import MODEL_DIMS, ModelDimensions
from whisper_flamingo_tpu_torch.models.whisper import ModelExtras, init_params
from whisper_flamingo_tpu_torch.parallel import distributed
from whisper_flamingo_tpu_torch.parallel.distributed import spawn
from whisper_flamingo_tpu_torch.parallel.mesh import make_mesh, param_pspecs, shard_params

import torch_parallel_workers as workers

TINY = dict(n_mels=80, n_audio_ctx=50, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
            n_vocab=51865, n_text_ctx=448, n_text_head=2, n_text_state=64, n_text_layer=2)
GATED = dict(add_gated_x_attn=1, num_langs=2, bert_dim=96)


def _jax_path(name):
    """The JAX pytree path of port parameter ``name`` (layer indices
    dropped: JAX stacks the layers)."""
    parts = name.split(".")
    top, rest = parts[0], parts[1:]
    ln = {"weight": "scale", "bias": "bias"}
    lin = {"weight": "w", "bias": "b"}
    proj = {"query": "q", "key": "k", "value": "v", "out": "out"}
    if rest[0] != "blocks":
        if rest[0] == "token_embedding":
            return (top, "token_embedding")
        if rest[0] == "positional_embedding":
            return (top, "pos_embedding")
        if rest[0] in ("ln", "ln_post"):
            return (top, rest[0], ln[rest[1]])
        return (top, rest[0], lin[rest[1]])  # conv1, conv2, xt_projection
    sub = rest[2:]  # after blocks.{i}
    if sub[0] == "gated_x_attn_layers":
        sub = sub[2:]
        if sub[0] == "attn_gate":
            return (top, "blocks", "gated", "langs", "attn_gate")
        if sub[0] == "attn":
            return (top, "blocks", "gated", "langs", "attn", proj[sub[1]], lin[sub[2]])
        return (top, "blocks", "gated", "langs", sub[0], ln[sub[1]])
    if sub[0] in ("ff", "mlp"):
        head = (top, "blocks", "gated", "ff") if sub[0] == "ff" else (top, "blocks", "mlp")
        return head + ({"0": "fc1", "2": "fc2"}[sub[1]], lin[sub[2]])
    if sub[0] == "ff_gate":
        return (top, "blocks", "gated", "ff_gate")
    if sub[0] == "ff_ln":
        return (top, "blocks", "gated", "ff_ln", ln[sub[1]])
    if sub[0] in ("attn", "cross_attn"):
        return (top, "blocks", sub[0], proj[sub[1]], lin[sub[2]])
    return (top, "blocks", sub[0], ln[sub[1]])  # attn_ln, cross_attn_ln, mlp_ln


def _port_dim(name, spec):
    """JAX's PartitionSpec of a leaf as the port's split dim: a linear's
    last (output) axis is the port's dim 0, its second-to-last (input)
    axis dim 1; the embedding's vocabulary axis is dim 0."""
    axes = [i for i, a in enumerate(tuple(spec)) if a == jmesh.MODEL_AXIS]
    if not axes:
        return None
    (axis,) = axes
    nd = len(tuple(spec))
    if name == "decoder.token_embedding.weight":
        return {0: 0}[axis]
    return {nd - 1: 0, nd - 2: 1}[axis]


@pytest.mark.parametrize("case", ["tiny_tp2", "tiny_tp4", "gated_debug_tp2", "tiny_en_tp2"])
def test_param_pspecs_equal_jax_leaf_for_leaf(case):
    n_model = 4 if case.endswith("tp4") else 2
    if case.startswith("gated"):
        jdims, extras = JMODEL_DIMS["debug"], GATED
        dims = MODEL_DIMS["debug"]
    else:
        d = dict(TINY, n_vocab=51864) if "en" in case else TINY
        jdims, dims, extras = JDims(**d), ModelDimensions(**d), {}
    params = jinit(jax.random.PRNGKey(0), jdims, JExtras(**extras))
    mesh = jmesh.make_mesh(8 // n_model, n_model)
    specs = jmesh.param_pspecs(params, mesh)
    model = init_params(torch.Generator().manual_seed(0), dims, ModelExtras(**extras),
                        device="cpu")
    mine = param_pspecs(model, n_model=n_model)
    assert mine.keys() == dict(model.named_parameters()).keys()
    for name, dim in mine.items():
        spec = specs
        for key in _jax_path(name):
            spec = spec[key]
        assert dim == _port_dim(name, spec), (name, dim, spec)
    # the rule's literal match: cross-attention replicated, self and gated split
    assert mine["decoder.blocks.0.cross_attn.query.weight"] is None
    assert mine["decoder.blocks.0.attn.query.weight"] == 0
    assert mine["decoder.blocks.0.attn.out.weight"] == 1
    assert mine["decoder.blocks.0.attn.out.bias"] is None
    want_vocab = 0 if dims.n_vocab % n_model == 0 else None
    assert mine["decoder.token_embedding.weight"] == want_vocab
    if case.startswith("gated"):
        assert mine["decoder.blocks.1.gated_x_attn_layers.1.attn.value.bias"] == 0
        assert mine["decoder.blocks.1.ff.2.weight"] == 1
        assert mine["decoder.xt_projection.weight"] is None


@pytest.fixture(scope="module")
def layout_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("layout")
    model = init_params(torch.Generator().manual_seed(3), MODEL_DIMS["debug"],
                        ModelExtras(**GATED), device="cpu")
    path = str(tmp / "gated.pt")
    torch.save(model.state_dict(), path)
    specs = [{"body": "layout", "dims": MODEL_DIMS["debug"].to_dict(), "extras": GATED,
              "state": path, "mesh": (1, 2)},
             {"body": "collectives", "mesh": (1, 2)}]
    full = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    return full, spawn(workers.run, 2, (specs,))


def test_shard_then_gather_is_bit_equal_and_marks_the_split_modules(layout_runs):
    full, ranks = layout_runs
    for (layout, _) in ranks:
        assert layout["equal"]
        shapes = layout["shapes"]
        assert shapes["decoder.blocks.0.attn.query.weight"] == (32, 64)
        assert shapes["decoder.blocks.0.attn.out.weight"] == (64, 32)
        assert shapes["decoder.blocks.0.mlp.0.weight"] == (128, 64)
        assert shapes["decoder.blocks.0.cross_attn.key.weight"] == (64, 64)
        assert shapes["decoder.token_embedding.weight"] == full["decoder.token_embedding.weight"]
        marked = layout["marked"]
        assert "decoder.blocks.0.gated_x_attn_layers.1.attn" in marked
        assert "decoder.blocks.1.ff" in marked and "encoder.blocks.0.mlp" in marked
        assert "decoder.blocks.0.cross_attn" not in marked and "decoder" not in marked


def test_tp_collectives_equal_the_one_device_function(layout_runs):
    """The vocabulary-split lookup and cross-entropy, copy-to-TP and the
    gather, forward and backward, against the full tensors on one device."""
    from whisper_flamingo_tpu_torch.training.steps import ce_loss

    _, ranks = layout_runs
    g = torch.Generator().manual_seed(0)
    v, d = 12, 5
    table = torch.randn(v, d, generator=g).requires_grad_(True)
    logits = torch.randn(3, 4, v, generator=g).requires_grad_(True)
    labels = torch.randint(0, v, (3, 4), generator=g)
    labels[0, 1] = -100
    tokens = torch.randint(0, v, (3, 4), generator=g)
    x = torch.randn(3, d, generator=g)
    emb = table[tokens]
    emb.sum().backward()
    loss = ce_loss(logits, labels)
    loss.backward()
    for _, r in ranks:
        k = r["model_index"]
        np.testing.assert_array_equal(r["emb"], emb.detach().numpy())
        np.testing.assert_array_equal(r["emb_grad"], table.grad[k * 6:(k + 1) * 6].numpy())
        np.testing.assert_allclose(r["nll"], float(loss.detach()), rtol=1e-6)
        np.testing.assert_allclose(r["logit_grad"], logits.grad[..., k * 6:(k + 1) * 6].numpy(),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(r["gathered"], torch.cat([x, 2 * x], -1).numpy())
        np.testing.assert_allclose(r["x_grad"], (2 * x * 1 + 2 * x * 4).numpy(), rtol=1e-6)


def test_shard_params_refuses_a_split_head():
    model = init_params(torch.Generator().manual_seed(0), MODEL_DIMS["debug"], device="cpu")
    from whisper_flamingo_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="heads"):
        shard_params(model, Mesh(1, 4, 0, {}))


def test_bootstrap_without_a_process_group(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "COORDINATOR_ADDRESS",
                "NUM_PROCESSES", "PROCESS_ID", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.is_primary()
    assert distributed.process_info()["process_count"] == 1
    with pytest.raises(ValueError, match="torchrun --nproc-per-node"):
        distributed.initialize(device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(2, 2)
    assert distributed.local_device("cpu") == torch.device("cpu")
    assert distributed.pick_backend(torch.device("cpu")) == "gloo"


def test_a_rank_with_no_card_raises_unless_the_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.local_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.local_device("cuda")


def test_backend_rule(monkeypatch):
    """nccl when each local rank has a card of its own, gloo when ranks share."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert distributed.pick_backend(torch.device("cuda", 0)) == "gloo"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert distributed.pick_backend(torch.device("cuda", 0)) == "nccl"


def test_dryrun_multichip_prints_its_ok_line(capsys):
    from whisper_flamingo_tpu_torch.parallel.dryrun import dryrun_multichip

    line = dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert line in out and line.startswith("dryrun_multichip ok: mesh=(2x2); ")
    for leg in ("_leg_train", "_leg_beam_decode", "_leg_kd_train", "_leg_int8_decode"):
        assert leg in line
