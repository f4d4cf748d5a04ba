"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip without a GPU (decided in a fixture, never at
import) and run on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerances as in ``chip_smoke.py``: fp32 1e-5 (sums in another order),
bf16 1e-2 / 2e-2 (a few bf16 ulps of outputs of order 1; the decode MLP's
of its largest output); the flash64
backward's gradients 1e-4 (fp32) and 1e-2 (bf16) of their largest
magnitude; the updated
caches must be bit-equal (the same one multiplication per element), and so
must the DTW traces (the same cascade and one fp32 add per cell).
"""

import numpy as np
import pytest
import torch

from whisper_flamingo_tpu_torch.ops import decode_attn, dtw, flash64

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 63, 300, 1500])
def test_flash64_kernel_matches_plain(gen, dtype, t):
    q, k, v = (torch.randn(2, 3, t, 64, generator=gen, device="cuda").to(dtype) for _ in range(3))
    before = flash64.flash64_forward.launches
    out = flash64.flash64_attention(q, k, v)
    assert flash64.flash64_forward.launches == before + 1
    ref = flash64.flash64_attention_plain(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def test_flash64_kernel_takes_head_split_views(gen):
    """The encoder's layout: head-split views of (B, T, H*64) tensors."""
    x = [torch.randn(2, 100, 4 * 64, generator=gen, device="cuda") for _ in range(3)]
    views = [a.view(2, 100, 4, 64).transpose(1, 2) for a in x]
    out = flash64.flash64_attention(*views)
    ref = flash64.flash64_attention_plain(*(a.contiguous() for a in views))
    assert (out - ref).abs().max().item() <= 1e-5


def _bwd_inputs(gen, t, dtype, b=8, h=12):
    q, k = ((torch.randn(b, h, t, 64, generator=gen, device="cuda") * 64 ** -0.25).to(dtype)
            for _ in range(2))
    v = torch.randn(b, h, t, 64, generator=gen, device="cuda").to(dtype)
    do = torch.randn(b, h, t, 64, generator=gen, device="cuda").to(dtype)
    return q, k, v, do


# the backward's tolerance is relative to each gradient's largest magnitude,
# or to 1 where that is smaller (at T = 1, dQ and dK are pure cancellation
# noise): bf16 outputs are rounded once (2^-8) after fp32 sums in another
# order; fp32 sums over T terms in another order
BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1500, 400, 100, 1])
def test_flash64_lse_and_backward_match_plain(gen, dtype, t):
    """The forward's lse and the three backward kernels against the plain
    versions at the training shapes (8, 12, T, 64); two launches give the
    same bits (no atomics)."""
    q, k, v, do = _bwd_inputs(gen, t, dtype)
    before = flash64.flash64_forward.launches
    o, lse = flash64.flash64_forward(q, k, v, with_lse=True)
    assert flash64.flash64_forward.launches == before + 1
    o_ref, lse_ref = flash64.flash64_forward_plain(q, k, v, with_lse=True)
    assert (o.float() - o_ref.float()).abs().max().item() <= TOL[dtype]
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    before = flash64.flash64_backward.launches
    got = flash64.flash64_backward(q, k, v, o, lse, do)
    again = flash64.flash64_backward(q, k, v, o, lse, do)
    assert flash64.flash64_backward.launches == before + 2
    ref = flash64.flash64_backward_plain(q, k, v, o, lse, do)
    for name, a, r, a2 in zip(("dq", "dk", "dv"), got, ref, again):
        assert a.dtype == dtype and a.shape == q.shape
        assert torch.equal(a, a2), name
        scale = r.float().abs().max().item()
        err = (a.float() - r.float()).abs().max().item()
        assert err <= BWD_REL[dtype] * max(scale, 1.0), (name, err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash64_autograd_through_head_split_views(gen, dtype):
    """The encoder's layout: q/k/v head-split views of (B, T, H*64)
    projections, dO arriving through the head merge. Autograd through the
    kernels equals autograd through the plain versions."""
    x = [torch.randn(2, 300, 4 * 64, generator=gen, device="cuda").to(dtype) * 0.5
         for _ in range(3)]
    w = torch.randn(2, 300, 4 * 64, generator=gen, device="cuda").to(dtype)

    def run():
        leaves = [a.clone().requires_grad_() for a in x]
        views = [a.view(2, 300, 4, 64).transpose(1, 2) for a in leaves]
        out = flash64.flash64_attention(*views)
        merged = out.transpose(1, 2).reshape(2, 300, 256)
        (merged.float() * w.float()).sum().backward()
        return [a.grad for a in leaves]

    got = run()
    saved = flash64.flash64_forward, flash64.flash64_backward
    flash64.flash64_forward = lambda q, k, v, with_lse=False: flash64.flash64_forward_plain(
        q, k, v, with_lse)
    flash64.flash64_backward = flash64.flash64_backward_plain
    try:
        ref = run()
    finally:
        flash64.flash64_forward, flash64.flash64_backward = saved
    for a, r in zip(got, ref):
        err = (a.float() - r.float()).abs().max().item()
        assert err <= BWD_REL[dtype] * max(r.float().abs().max().item(), 1.0)


# The wgmma forms of csrc/hopper.cuh, one product each (csrc/wgmma_check.cu):
# bf16 products are exact in fp32, so only the order of the fp32 sum over
# 16 * ksteps terms differs from torch.matmul's.
WGMMA_FORMS = {"ss": 0, "rs": 1, "rs_t": 2, "ss_t": 3}


@pytest.mark.parametrize("ksteps", [1, 4])
@pytest.mark.parametrize("form,n", [("ss", 64), ("ss", 128), ("rs", 64), ("rs_t", 64),
                                    ("ss_t", 64)])
def test_wgmma_form_matches_matmul(gen, form, n, ksteps):
    """D (64 x n) = A (64 x 16 ksteps) B through TMA tiles in the 128-byte
    swizzle: K-major B stored [n][k], MN-major B (``_t``) stored [k][n]."""
    import ctypes

    from whisper_flamingo_tpu_torch.ops import cuda_build

    fn = cuda_build.load("wgmma_check").wf_wgmma_check
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    a = torch.randn(64, 64, generator=gen, device="cuda").bfloat16()
    mn_major = form.endswith("_t")
    b = torch.randn(64 if mn_major else n, 64, generator=gen, device="cuda").bfloat16()
    d = torch.full((64, n), float("nan"), device="cuda")
    err = fn(a.data_ptr(), b.data_ptr(), d.data_ptr(), n, WGMMA_FORMS[form], ksteps,
             cuda_build.stream_ptr(a))
    cuda_build.check(err, "wgmma_check")
    torch.cuda.synchronize()
    kk = 16 * ksteps
    bkn = b[:kk].float() if mn_major else b[:, :kk].float().t()
    ref = a[:, :kk].float() @ bkn
    assert (d - ref).abs().max().item() <= 1e-5 * max(ref.abs().max().item(), 1.0)


# every edge of the bf16 kernels' tiles: 64-row boxes and 128-row blocks
EDGE_T = [1, 63, 64, 65, 127, 128, 129, 300, 1500]


@pytest.mark.parametrize("t", EDGE_T)
def test_flash64_bf16_tile_edges_through_head_split_views(gen, t):
    """The wgmma kernels at every tile edge, in the encoder's layout (q/k/v
    and dO head-split views of (B, T, H*64) tensors): the forward (with and
    without the lse, the same bits), its lse and the backward against the
    plain versions; two launches of each give the same bits."""
    b, h = 2, 3
    x = [torch.randn(b, t, h * 64, generator=gen, device="cuda") for _ in range(4)]
    x[0], x[1] = x[0] * 64 ** -0.25, x[1] * 64 ** -0.25
    q, k, v, do = (a.bfloat16().view(b, t, h, 64).transpose(1, 2) for a in x)
    o, lse = flash64.flash64_forward(q, k, v, with_lse=True)
    o2, lse2 = flash64.flash64_forward(q, k, v, with_lse=True)
    o_inf = flash64.flash64_forward(q, k, v)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.equal(o, o_inf)
    o_ref, lse_ref = flash64.flash64_forward_plain(q, k, v, with_lse=True)
    assert (o.float() - o_ref.float()).abs().max().item() <= TOL[torch.bfloat16]
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    got = flash64.flash64_backward(q, k, v, o, lse, do)
    again = flash64.flash64_backward(q, k, v, o, lse, do)
    ref = flash64.flash64_backward_plain(q, k, v, o, lse, do)
    for name, a, r, a2 in zip(("dq", "dk", "dv"), got, ref, again):
        assert torch.equal(a, a2), name
        assert torch.isfinite(a).all(), name
        scale = r.float().abs().max().item()
        err = (a.float() - r.float()).abs().max().item()
        assert err <= BWD_REL[torch.bfloat16] * max(scale, 1.0), (name, err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,per_row", [(3, False), (3, True), (40, False)])
def test_decode_attn_kernel_matches_plain(gen, dtype, rows, per_row):
    t_max, d, n_head = 40, 256, 4
    q, kn, vn = (torch.randn(rows, 1, d, generator=gen, device="cuda").to(dtype) for _ in range(3))
    kc = torch.randn(rows, t_max, d, generator=gen, device="cuda").to(dtype)
    vc = torch.randn(rows, t_max, d, generator=gen, device="cuda").to(dtype)
    if per_row:
        offsets = [torch.randint(0, t_max, (rows,), generator=gen, device="cuda", dtype=torch.int32)]
    else:
        offsets = [0, 17, t_max - 1, torch.tensor([9], dtype=torch.int32, device="cuda")]
    for off in offsets:
        kc2, vc2 = kc.clone(), vc.clone()
        out, k_out, v_out = decode_attn.fused_step(q, kn, vn, kc, vc, off, n_head)
        assert k_out is kc and v_out is vc
        ref = decode_attn.fused_step_plain(q, kn, vn, kc2, vc2, off, n_head)
        assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
        assert torch.equal(kc, kc2) and torch.equal(vc, vc2)


def test_decode_attn_kernel_refuses_what_it_cannot_take(gen):
    q = torch.randn(2, 1, 96, generator=gen, device="cuda")
    kc = torch.zeros(2, 8, 96, device="cuda")
    with pytest.raises(ValueError):  # d_head 48
        decode_attn.fused_step(q, q, q, kc, kc.clone(), 0, 2)
    q = torch.randn(2, 1, 64, generator=gen, device="cuda")
    kc = torch.zeros(2, 8, 64, device="cuda")
    with pytest.raises(ValueError):  # offset past the cache
        decode_attn.fused_step(q, q, q, kc, kc.clone(), 8, 1)
    with pytest.raises(TypeError):  # mixed dtypes
        decode_attn.fused_step(q.bfloat16(), q, q, kc, kc.clone(), 0, 1)


def test_debug_decode_kernel_tokens_equal_plain(gen, monkeypatch):
    """fp32 greedy and beam at debug dims with d_head 64: tokens through the
    kernels equal tokens through the plain versions, on the card."""
    import whisper_flamingo_tpu_torch as wt
    from whisper_flamingo_tpu_torch.models.dims import ModelDimensions

    dims = ModelDimensions(
        n_mels=80, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
        n_vocab=51865, n_text_ctx=448, n_text_head=2, n_text_state=128, n_text_layer=2,
    )
    model = wt.init_params(torch.Generator(device="cuda").manual_seed(1), dims, device="cuda")
    mel = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, 80, 3000)).astype(np.float32) * 0.5
    ).cuda()
    for beam in (None, 3):
        opts = wt.DecodingOptions(language="en", fp16=False, sample_len=12, beam_size=beam)
        got = wt.DecodingTask(model, opts).run(mel)
        with monkeypatch.context() as m:
            m.setattr(flash64, "flash64_attention", flash64.flash64_attention_plain)
            m.setattr(decode_attn, "fused_step", lambda *a: (decode_attn.fused_step_plain(*a), a[3], a[4]))
            ref = wt.DecodingTask(model, opts).run(mel)
        assert [g.tokens for g in got] == [r.tokens for r in ref]


@pytest.mark.parametrize("shape,ints", [
    ((1, 1), False), ((1, 1500), False), ((65, 1), False), ((9, 17), True),
    ((33, 70), True), ((65, 1500), False), ((224, 1500), False), ((448, 1500), False),
    ((1023, 40), False),
])
def test_dtw_kernel_trace_equals_plain(gen, shape, ints):
    """Bit-equal traces, tie-rich integer costs included; the path equals
    the host DP's where that is quick."""
    rng = np.random.default_rng(shape[0] * 7919 + shape[1])
    x = rng.integers(0, 2, shape) if ints else rng.standard_normal(shape)
    x = torch.from_numpy(x.astype(np.float32)).cuda()
    before = dtw.dtw_trace.launches
    got = dtw.dtw_trace(x)
    assert dtw.dtw_trace.launches == before + 1
    assert got.dtype == torch.int8 and got.shape == (shape[0] + 1, shape[1] + 1)
    assert torch.equal(got, dtw.dtw_trace_plain(x))
    if shape[0] * shape[1] <= 70 * 70:
        np.testing.assert_array_equal(dtw.dtw(x), dtw.dtw_np(x.cpu().numpy()))


def test_dtw_kernel_refuses_what_it_cannot_take(gen):
    x = torch.zeros(1024, 5, device="cuda")
    with pytest.raises(ValueError):  # N + 1 > 1024
        dtw.dtw_trace(x)
    with pytest.raises(ValueError):  # not contiguous
        dtw.dtw_trace(torch.zeros(5, 8, device="cuda").t())
    with pytest.raises(ValueError):  # not fp32
        dtw.dtw_trace(torch.zeros(5, 8, device="cuda", dtype=torch.bfloat16))


def _mlp_weights(gen, d, f, dtype, int8):
    """fc1 (f, d) and fc2 (d, f) weights of N(0, 1/fan_in), biases 0.1 N(0, 1);
    int8: quantized per output channel, as quantize_decode_params does."""
    from whisper_flamingo_tpu_torch.ops.quant import quantize_linear_params

    w1 = torch.randn(f, d, generator=gen, device="cuda") * d ** -0.5
    w2 = torch.randn(d, f, generator=gen, device="cuda") * f ** -0.5
    b1, b2 = (torch.randn(n, generator=gen, device="cuda").to(dtype) * 0.1 for n in (f, d))
    if int8:
        (w1, s1), (w2, s2) = quantize_linear_params(w1), quantize_linear_params(w2)
        return w1, b1, w2, b2, s1, s2
    return w1.to(dtype), b1, w2.to(dtype), b2, None, None


@pytest.mark.parametrize("dtype,int8", [(torch.float32, False), (torch.bfloat16, False),
                                        (torch.bfloat16, True), (torch.float32, True)])
@pytest.mark.parametrize("rows", [8, 32, 120])
def test_decode_mlp_kernel_matches_plain(gen, dtype, int8, rows):
    """At small's widths (d 768, f 3072) and the decode row counts; the
    tolerance is of the largest output (fp32 sums in another order; in bf16
    a few activations round the other way, then one bf16 rounding)."""
    from whisper_flamingo_tpu_torch.ops import decode_mlp

    w1, b1, w2, b2, s1, s2 = _mlp_weights(gen, 768, 3072, dtype, int8)
    x = torch.randn(rows, 768, generator=gen, device="cuda").to(dtype)
    before = decode_mlp.fused_mlp.launches
    out = decode_mlp._launch(x, w1, b1, w2, b2, s1, s2)
    again = decode_mlp._launch(x, w1, b1, w2, b2, s1, s2)
    assert decode_mlp.fused_mlp.launches == before + 2
    assert out.dtype == dtype and out.shape == x.shape and torch.equal(out, again)
    ref = decode_mlp.fused_mlp_plain(x, w1, b1, w2, b2, s1, s2)
    scale = max(ref.float().abs().max().item(), 1.0)
    assert (out.float() - ref.float()).abs().max().item() <= {torch.float32: 1e-5,
                                                             torch.bfloat16: 1e-2}[dtype] * scale


def test_decode_mlp_kernel_refuses_what_it_cannot_take(gen):
    from whisper_flamingo_tpu_torch.ops import decode_mlp

    w1, b1, w2, b2, _, _ = _mlp_weights(gen, 72, 288, torch.float32, False)
    x = torch.randn(4, 72, generator=gen, device="cuda")
    with pytest.raises(ValueError):  # d % 16
        decode_mlp._launch(x, w1, b1, w2, b2, None, None)
    w1, b1, w2, b2, _, _ = _mlp_weights(gen, 64, 256, torch.float32, False)
    x = torch.randn(4, 64, generator=gen, device="cuda")
    with pytest.raises(TypeError):  # mixed dtypes
        decode_mlp._launch(x.bfloat16(), w1, b1.bfloat16(), w2, b2.bfloat16(), None, None)
    with pytest.raises(ValueError):  # not contiguous
        decode_mlp._launch(x, w2.t(), b1, w2, b2, None, None)


def test_debug_int8_decode_kernel_tokens_equal_plain(gen, monkeypatch):
    """fp32 int8 greedy with the decode-MLP kernel on, at debug widths with
    d_head 64: tokens through the kernels equal the plain versions'."""
    import whisper_flamingo_tpu_torch as wt
    from whisper_flamingo_tpu_torch.models.dims import ModelDimensions
    from whisper_flamingo_tpu_torch.ops import decode_mlp

    dims = ModelDimensions(
        n_mels=80, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
        n_vocab=51865, n_text_ctx=448, n_text_head=2, n_text_state=128, n_text_layer=2,
    )
    model = wt.init_params(torch.Generator(device="cuda").manual_seed(1), dims, device="cuda")
    mel = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, 80, 3000)).astype(np.float32) * 0.5
    ).cuda()
    monkeypatch.setattr(decode_mlp, "ENABLED", True)
    opts = wt.DecodingOptions(language="en", fp16=False, sample_len=12, quantize="int8")
    before = decode_mlp.fused_mlp.launches
    got = wt.DecodingTask(model, opts).run(mel)
    assert decode_mlp.fused_mlp.launches > before
    with monkeypatch.context() as m:
        m.setattr(flash64, "flash64_attention", flash64.flash64_attention_plain)
        m.setattr(decode_attn, "fused_step", lambda *a: (decode_attn.fused_step_plain(*a), a[3], a[4]))
        m.setattr(decode_mlp, "_launch", decode_mlp.fused_mlp_plain)
        ref = wt.DecodingTask(model, opts).run(mel)
    assert [g.tokens for g in got] == [r.tokens for r in ref]


# the probe kernels: bf16 outputs within one ulp of their scale (2^-7 of the
# largest magnitude; fp32 sums in another order can flip a bf16 rounding)
PROBE_REL = 2.0 ** -7


@pytest.mark.parametrize("variant", ["augv", "csbound"])
@pytest.mark.parametrize("t", [1, 63, 300, 1500])
def test_flash64_variant_kernels_match_plain(gen, variant, t):
    """The forward variants at the probe's scales (q, k 0.3 N(0, 1)); the
    online softmax of augv rounds its probabilities against a running max,
    so it is held at the shipped kernel's 1e-2 of the output scale; two
    launches give the same bits."""
    from whisper_flamingo_tpu_torch.ops import flash64_variants as fv

    q, k = ((torch.randn(2, 3, t, 64, generator=gen, device="cuda") * 0.3).bfloat16()
            for _ in range(2))
    v = torch.randn(2, 3, t, 64, generator=gen, device="cuda").bfloat16()
    fn = fv.flash64_fwd_augv if variant == "augv" else fv.flash64_fwd_csbound
    plain = fv.flash64_fwd_augv_plain if variant == "augv" else fv.flash64_fwd_csbound_plain
    before = fn.launches
    out, again = fn(q, k, v), fn(q, k, v)
    assert fn.launches == before + 2
    assert out.dtype == torch.bfloat16 and torch.equal(out, again)
    ref = plain(q, k, v)
    scale = max(ref.float().abs().max().item(), 1.0)
    assert torch.isfinite(out).all() and (out.float() - ref.float()).abs().max().item() <= 1e-2 * scale


def test_flash64_variant_kernels_refuse_what_they_cannot_take(gen):
    from whisper_flamingo_tpu_torch.ops import flash64_variants as fv

    q = torch.randn(1, 2, 70, 64, generator=gen, device="cuda")
    with pytest.raises(TypeError):  # fp32
        fv.flash64_fwd_augv(q, q, q)
    qb = q.bfloat16()
    with pytest.raises(ValueError):  # not contiguous
        fv.flash64_fwd_csbound(qb.transpose(1, 2), qb.transpose(1, 2), qb.transpose(1, 2))
    with pytest.raises(ValueError):  # d_head 32
        fv.flash64_fwd_augv(qb[..., :32].contiguous(), qb[..., :32].contiguous(),
                            qb[..., :32].contiguous())


@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_mma_pair_kernel_matches_plain(gen, d, iters):
    """The pair loop at the probe's scales and n 1536, 256 rows (two
    blocks); reruns give the same bits."""
    from whisper_flamingo_tpu_torch.ops import mma_pair

    w = torch.randn(256, 1536, generator=gen, device="cuda").bfloat16()
    v = (torch.randn(1536, d, generator=gen, device="cuda") * 0.1).bfloat16()
    u = (torch.randn(d, 1536, generator=gen, device="cuda") * 0.1).bfloat16()
    before = mma_pair.pair_chain.launches
    out, again = mma_pair.pair_chain(w, v, u, iters), mma_pair.pair_chain(w, v, u, iters)
    assert mma_pair.pair_chain.launches == before + 2 and torch.equal(out, again)
    ref = mma_pair.pair_chain_plain(w, v, u, iters)
    scale = ref.float().abs().max().item()
    assert scale > 0 and (out.float() - ref.float()).abs().max().item() <= PROBE_REL * scale


def test_mma_pair_kernel_refuses_what_it_cannot_take(gen):
    from whisper_flamingo_tpu_torch.ops import mma_pair

    w = torch.randn(128, 128, generator=gen, device="cuda").bfloat16()
    v = torch.randn(128, 64, generator=gen, device="cuda").bfloat16()
    u = torch.randn(64, 128, generator=gen, device="cuda").bfloat16()
    with pytest.raises(ValueError):  # rows not a multiple of 128
        mma_pair.pair_chain(w[:64].contiguous(), v, u, 1)
    with pytest.raises(ValueError):  # d 96
        mma_pair.pair_chain(w, v.repeat(1, 2)[:, :96].contiguous(), u.repeat(2, 1)[:96].contiguous(), 1)
    with pytest.raises(TypeError):  # fp32
        mma_pair.pair_chain(w.float(), v.float(), u.float(), 1)
    with pytest.raises(ValueError):  # iters 0
        mma_pair.pair_chain(w, v, u, 0)
