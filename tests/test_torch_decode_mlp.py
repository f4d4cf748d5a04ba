"""The streaming decode-MLP: the port's plain version against the JAX
kernel (``ops/decode_mlp.py:_kernel`` in interpret mode on the CPU), the
fused route against the port's own unfused ``mlp_block``, the dispatch
rule, and the decode loop with ``ENABLED`` on, all fp32 on the CPU.

Tolerances:
- plain vs the JAX kernel, 2e-5 of the output's std: both accumulate in
  fp32 and differ only in the erf (the JAX kernel's Abramowitz-Stegun
  polynomial is within 1.5e-7 of erf) and in the order of the sums over
  d = 256 and f = 1024;
- the fused int8 route vs the unfused int8 ``mlp_block``, 2e-4 of the std
  (the JAX package's own bound): the unfused chain applies fc1's scale to
  its rounded product and the fused one to the fp32 sum;
- decode tokens: identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from whisper_flamingo_tpu import decoding as jdecoding
from whisper_flamingo_tpu.decoding import DecodingOptions as JOptions
from whisper_flamingo_tpu.decoding import DecodingTask as JTask
from whisper_flamingo_tpu.models.dims import MODEL_DIMS as JMODEL_DIMS
from whisper_flamingo_tpu.models.whisper import Whisper as JWhisper
from whisper_flamingo_tpu.ops import decode_mlp as jdecode_mlp
from whisper_flamingo_tpu.ops.quant import quantize_linear_params as jquantize_linear

from whisper_flamingo_tpu_torch.decoding import DecodingOptions, DecodingTask
from whisper_flamingo_tpu_torch.models import whisper as tw
from whisper_flamingo_tpu_torch.models.dims import MODEL_DIMS
from whisper_flamingo_tpu_torch.ops import decode_mlp

from test_torch_model import port_from_jax


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mlp(rng, d, f):
    """The same MLP for both packages: JAX params (in, out) and the port's
    nn.Sequential (nn.Linear layout)."""
    w1, w2 = (rng.standard_normal(s).astype(np.float32) * 0.05 for s in ((d, f), (f, d)))
    b1, b2 = (rng.standard_normal(n).astype(np.float32) * 0.05 for n in (f, d))
    jp = {"fc1": {"w": jnp.asarray(w1), "b": jnp.asarray(b1)},
          "fc2": {"w": jnp.asarray(w2), "b": jnp.asarray(b2)}}
    tp = nn.Sequential(nn.Linear(d, f), nn.GELU(), nn.Linear(f, d)).requires_grad_(False)
    for lin, w, b in ((tp[0], w1, b1), (tp[2], w2, b2)):
        lin.weight.copy_(torch.from_numpy(w.T.copy()))
        lin.bias.copy_(torch.from_numpy(b))
    return jp, tp


def _quantized(jp, tp):
    jq = {k: jquantize_linear(v) for k, v in jp.items()}
    for lin in (tp[0], tp[2]):
        tw._quantize_linear(lin)
    return jq, tp


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.max(np.abs(a - b)) / (np.std(b) + 1e-9)


@pytest.mark.parametrize("quantized", [False, True], ids=["plain", "int8"])
def test_plain_matches_jax_kernel(quantized):
    rng = np.random.default_rng(0)
    d, f = 256, 1024  # two of the JAX kernel's 512-wide tiles
    jp, tp = _mlp(rng, d, f)
    if quantized:
        jp, tp = _quantized(jp, tp)
    x = rng.standard_normal((3, 5, d)).astype(np.float32)
    ref = jdecode_mlp.fused_mlp(jp, jnp.asarray(x))
    w1, w2, s1, s2 = decode_mlp._weights(tp)
    got = decode_mlp.fused_mlp_plain(torch.from_numpy(x).reshape(15, d), w1, tp[0].bias,
                                     w2, tp[2].bias, s1, s2).reshape(3, 5, d)
    assert _rel(got, ref) < 2e-5
    # the wrapper on a CPU tensor takes the plain version
    assert torch.equal(decode_mlp.fused_mlp(tp, torch.from_numpy(x)), got)


def test_fused_int8_matches_unfused_int8():
    rng = np.random.default_rng(1)
    _, tp = _quantized(*_mlp(rng, 256, 1024))
    x = torch.from_numpy(rng.standard_normal((4, 1, 256)).astype(np.float32))
    assert _rel(decode_mlp.fused_mlp(tp, x), tw.mlp_block(tp, x)) < 2e-4


@pytest.mark.parametrize("d,f,rows,kernel", [
    (256, 1024, 1024, True),   # f tiles by 512, at the row limit
    (256, 1024, 1025, False),  # too many rows: a prefill keeps mlp_block
    (64, 256, 8, True),        # f at most one tile (the debug dims)
    (256, 640, 8, False),      # f neither tiles nor fits one tile
    (36, 144, 8, False),       # d % 8
])
def test_dispatch_rule(d, f, rows, kernel):
    """The JAX rule decides the route: the kernel's plain version on the
    CPU, else the unfused ``mlp_block`` (bit for bit)."""
    rng = np.random.default_rng(2)
    _, tp = _mlp(rng, d, f)
    x = torch.from_numpy(rng.standard_normal((rows, 1, d)).astype(np.float32))
    got = decode_mlp.fused_mlp(tp, x)
    w1, w2, _, _ = decode_mlp._weights(tp)
    plain = decode_mlp.fused_mlp_plain(x.reshape(rows, d), w1, tp[0].bias, w2, tp[2].bias)
    assert torch.equal(got, plain.reshape(x.shape) if kernel else tw.mlp_block(tp, x))


@pytest.fixture(scope="module")
def models():
    jp, tm = port_from_jax(MODEL_DIMS["debug"], seed=0)
    return JWhisper(dims=JMODEL_DIMS["debug"], params=jp), tm


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_decode_loop_with_fused_mlp_token_parity(models, monkeypatch, quantize):
    """``ENABLED`` routes the cached decoder's MLP through the kernel's
    route: in fp32 the tokens equal JAX's with its kernel on, and the
    port's with the switch off."""
    jmodel, tmodel = models
    mel = np.random.default_rng(2).standard_normal((2, 80, 3000)).astype(np.float32) * 0.3
    common = dict(language="en", fp16=False, sample_len=8, without_timestamps=True,
                  quantize=quantize)
    base = DecodingTask(tmodel, DecodingOptions(**common)).run(torch.from_numpy(mel))
    monkeypatch.setattr(decode_mlp, "ENABLED", True)
    monkeypatch.setattr(jdecode_mlp, "ENABLED", True)
    jdecoding._make_decode_program.cache_clear()  # the flag is read while tracing
    try:
        ref = JTask(jmodel, JOptions(**common)).run(jnp.asarray(mel))
    finally:
        jdecoding._make_decode_program.cache_clear()
    got = DecodingTask(tmodel, DecodingOptions(**common)).run(torch.from_numpy(mel))
    for b, r, g in zip(base, ref, got):
        assert g.tokens == r.tokens
        assert g.tokens == b.tokens
        assert abs(g.avg_logprob - r.avg_logprob) < 1e-4


@pytest.mark.parametrize("rows,nt,tiles", [(1, 8, 1), (8, 8, 1), (9, 32, 1), (32, 32, 1),
                                           (33, 128, 1), (120, 128, 1), (129, 128, 2),
                                           (1024, 128, 8)])
def test_plan_at_small_widths(rows, nt, tiles):
    """The bf16 kernel's plan at small's d 768, f 3072: the row tile holds
    the rows (128 at most, the rest walked in row tiles), fc1's contraction
    over a cluster of 4 and fc2's over 8, so each pass runs at least 96
    CTAs, and each CTA's shared memory fits an H100's 227 KB."""
    for int8 in (False, True):
        pl = decode_mlp.plan(rows, 768, 3072, int8)
        assert (pl.nt, pl.tiles, pl.cl1, pl.cl2) == (nt, tiles, 4, 8)
        assert (pl.kbs1, pl.kbs2, pl.ctas1, pl.ctas2) == (3, 6, 192, 96)
        assert max(pl.smem1, pl.smem2) <= decode_mlp.SMEM_MAX
        assert pl.kbs1 * pl.cl1 * 64 >= 768 and pl.kbs2 * pl.cl2 * 64 >= 3072


@pytest.mark.parametrize("d,f", [(64, 256), (384, 1536), (1280, 5120), (80, 320)])
def test_plan_covers_the_contraction(d, f):
    """Every width the dispatch rule can send: the clusters are powers of
    two that split the contraction into 64-wide blocks with none empty, and
    the row tile shrinks until a CTA's shared memory fits."""
    for rows in (1, 120, 1024):
        pl = decode_mlp.plan(rows, d, f, False)
        for k, cl, kbs in ((d, pl.cl1, pl.kbs1), (f, pl.cl2, pl.kbs2)):
            blocks = -(-k // 64)
            assert cl in (1, 2, 4, 8) and cl <= blocks
            assert (cl - 1) * kbs < blocks <= cl * kbs
        assert max(pl.smem1, pl.smem2) <= decode_mlp.SMEM_MAX
        assert pl.nt * pl.tiles >= rows


def test_weight_checks_run_once_per_weight_set(monkeypatch):
    """The full checks of a weight set run when the kernel first sees it and
    again only for other tensors or after an in-place change; what they
    refuse is refused on every route."""
    rng = np.random.default_rng(5)
    _, tp = _quantized(*_mlp(rng, 64, 256))
    w1, w2, s1, s2 = decode_mlp._weights(tp)
    b1, b2 = tp[0].bias, tp[2].bias
    seen = []
    check = decode_mlp.check_weights
    monkeypatch.setattr(decode_mlp, "check_weights", lambda *a: seen.append(1) or check(*a))
    decode_mlp._CHECKED.clear()
    first = decode_mlp._checked(w1, b1, w2, b2, s1, s2, torch.float32)
    assert decode_mlp._checked(w1, b1, w2, b2, s1, s2, torch.float32) is first and len(seen) == 1
    assert first.handle is None  # the kernel library's handle is made only for a launch
    b1.add_(0.0)  # an in-place change bumps the version: checked again
    decode_mlp._checked(w1, b1, w2, b2, s1, s2, torch.float32)
    b2_other = b2.clone()  # another bias tensor with the same w1: checked again
    decode_mlp._checked(w1, b1, w2, b2_other, s1, s2, torch.float32)
    b2_other.data = b2_other.data.clone()  # new data under the same tensor: checked again
    decode_mlp._checked(w1, b1, w2, b2_other, s1, s2, torch.float32)
    assert len(seen) == 4
    assert (first.d, first.f, first.code) == (64, 256, 0)
    with pytest.raises(ValueError):  # int8 weights without their second scale
        decode_mlp._checked(w1, b1, w2, b2, s1, None, torch.float32)
    with pytest.raises(TypeError):  # biases of another dtype than x's
        decode_mlp._checked(w1, b1, w2, b2, s1, s2, torch.bfloat16)
    with pytest.raises(ValueError):  # not contiguous
        decode_mlp._checked(w1, b1, w2.t().contiguous().t(), b2, s1, s2, torch.float32)


def test_act_scratch_is_one_buffer_per_stream():
    """fc1's output lives in one buffer per (stream, device, dtype), grown to
    the largest call: calls on one stream share it, another stream or dtype
    has its own."""
    decode_mlp._SCRATCH.clear()
    x = torch.zeros(2, 64)
    first = decode_mlp._act(x, 11, 1000)
    assert decode_mlp._act(x, 11, 500) == first
    assert decode_mlp._act(x, 12, 1000) != first
    assert decode_mlp._act(x.double(), 11, 1000) != first
    assert decode_mlp._SCRATCH[(11, -1, torch.float32)].numel() >= 1000
    decode_mlp._act(x, 11, 10 ** 6)  # a larger call grows it
    assert decode_mlp._SCRATCH[(11, -1, torch.float32)].numel() >= 10 ** 6
    decode_mlp._SCRATCH.clear()
