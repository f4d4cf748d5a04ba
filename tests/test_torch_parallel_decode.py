"""The port's decoding under a (data, model) mesh of gloo ranks on the CPU,
against the JAX package's decode under its mesh and against one rank:
tokens equal, ``avg_logprob`` within 1e-3 (JAX's tolerances). Every rank
returns every row, and the ranks of a model row agree without a broadcast."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from whisper_flamingo_tpu.decoding import DecodingOptions as JOptions
from whisper_flamingo_tpu.decoding import DecodingTask as JTask
from whisper_flamingo_tpu.models.dims import ModelDimensions as JDims
from whisper_flamingo_tpu.models.whisper import ModelExtras as JExtras
from whisper_flamingo_tpu.models.whisper import Whisper as JWhisper
from whisper_flamingo_tpu.models.whisper import init_params as jinit
from whisper_flamingo_tpu.parallel.mesh import make_mesh as jmake_mesh
from whisper_flamingo_tpu.parallel.mesh import shard_params as jshard_params

from whisper_flamingo_tpu_torch.convert import params_from_jax
from whisper_flamingo_tpu_torch.models.dims import MODEL_DIMS, ModelDimensions
from whisper_flamingo_tpu_torch.models.whisper import ModelExtras
from whisper_flamingo_tpu_torch.parallel.distributed import spawn

import torch_parallel_workers as workers

DEBUG = MODEL_DIMS["debug"].to_dict()
DEBUG_EN = dict(DEBUG, n_vocab=51864)  # the English vocabulary splits over 2 model ranks
GATED = dict(add_gated_x_attn=1, num_langs=1, bert_dim=96)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _opts(**kw):
    return dict(dict(language="en", fp16=False, without_timestamps=True), **kw)


def _mel(n, frames, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 80, frames)).astype(np.float32) * 0.3


CASES = {
    # name: (dims, extras, mesh, options, mel, JAX mesh shape or None, extra spec)
    "beam3_2x2": (DEBUG, {}, (2, 2), _opts(beam_size=3, sample_len=6), _mel(2, 3000, 0),
                  (2, 2), {}),
    "greedy_4x1_ragged": (DEBUG, {}, (4, 1), _opts(sample_len=8), _mel(5, 3000, 0), (4, 1), {}),
    "int8_2x2": (DEBUG, {}, (2, 2), _opts(sample_len=8, quantize="int8"), _mel(4, 3000, 7),
                 (4, 2), {}),
    "int8kv_beam_vocab_split_2x2": (DEBUG_EN, {}, (2, 2),
                                    _opts(beam_size=3, sample_len=6, quantize="int8kv"),
                                    _mel(3, 3000, 2), None, {}),
    "flamingo_beam_2x2": (DEBUG_EN, GATED, (2, 2), _opts(beam_size=3, sample_len=6),
                          _mel(2, 3000, 4), None,
                          {"xt": np.random.default_rng(5).standard_normal((1, 2, 6, 96))
                           .astype(np.float32)}),
    "decode_mlp_int8_2x2": (DEBUG_EN, {}, (2, 2), _opts(sample_len=8, quantize="int8"),
                            _mel(2, 3000, 6), None, {"decode_mlp": True}),
}


def _jax_params(dims, extras, seed=0):
    params = jinit(jax.random.PRNGKey(seed), JDims(**dims), JExtras(**extras))
    if extras:
        gated = params["decoder"]["blocks"]["gated"]
        gated["langs"]["attn_gate"] = gated["langs"]["attn_gate"] + 0.5
        gated["ff_gate"] = gated["ff_gate"] + 0.5
    return params


def run_cases(tmp, cases):
    """Every case on four gloo ranks, on one rank, and JAX's decode under
    its mesh where the case names one."""
    specs, jax_ref = {}, {}
    for i, (name, (dims, extras, shape, opts, mel, jshape, extra)) in enumerate(cases.items()):
        params = _jax_params(dims, extras)
        path = str(tmp / f"{i}.pt")
        torch.save(params_from_jax(jax.tree.map(np.asarray, params), ModelDimensions(**dims),
                                   ModelExtras(**extras)), path)
        specs[name] = dict({"body": "decode", "dims": dims, "extras": extras, "state": path,
                            "mesh": shape, "options": opts, "mel": mel}, **extra)
        if jshape is not None:
            jdims = JDims(**dims)
            mesh = jmake_mesh(*jshape, devices=jax.devices()[: jshape[0] * jshape[1]])
            with jax.set_mesh(mesh):
                model = JWhisper(dims=jdims, params=jshard_params(params, mesh))
                mel_s = mel if mel.shape[0] % jshape[0] else jax.device_put(
                    mel, NamedSharding(mesh, P("data")))
                res = JTask(model, JOptions(**opts)).run(mel_s)
            jax_ref[name] = [(r.tokens, r.avg_logprob) for r in res]
    ranks = spawn(workers.run, 4, (list(specs.values()),))
    port = {name: [r[i] for r in ranks] for i, name in enumerate(specs)}
    one = {name: workers.decode(dict(spec, mesh=None), None) for name, spec in specs.items()}
    return port, one, jax_ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("parallel_decode"), CASES)


def _same(got, want, lp=1e-3):
    assert len(got) == len(want)
    for (gt, gl), (wt, wl) in zip(got, want):
        assert gt == wt, (gt, wt)
        assert abs(gl - wl) < lp, (gl, wl)


def check_one_rank(runs, name):
    port, one, _ = runs
    for r in port[name]:
        assert r == port[name][0]  # every rank: all rows, the same bits
        _same(r, one[name])


def check_jax(runs, name):
    port, _, jax_ref = runs
    tokens_only = "int8" in name  # JAX quantizes inside its program: tokens are the gate
    for (gt, gl), (wt, wl) in zip(port[name][0], jax_ref[name]):
        assert gt == wt, (gt, wt)
        if not tokens_only:
            assert abs(gl - wl) < 1e-3, (gl, wl)


@pytest.mark.parametrize("name", list(CASES))
def test_decode_under_the_mesh_equals_one_rank(runs, name):
    check_one_rank(runs, name)


@pytest.mark.parametrize("name", ["beam3_2x2", "greedy_4x1_ragged", "int8_2x2"])
def test_decode_under_the_mesh_equals_jax(runs, name):
    check_jax(runs, name)
