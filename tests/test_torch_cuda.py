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
WGMMA_FORMS = {"ss": 0, "rs": 1, "rs_t": 2, "ss_t": 3, "rs_n8": 4}


@pytest.mark.parametrize("ksteps", [1, 4])
@pytest.mark.parametrize("form,n", [("ss", 64), ("ss", 128), ("rs", 64), ("rs_t", 64),
                                    ("ss_t", 64), ("rs_n8", 8)])
def test_wgmma_form_matches_matmul(gen, form, n, ksteps):
    """D (64 x n) = A (64 x 16 ksteps) B through TMA tiles in the 128-byte
    swizzle: K-major B stored [n][k], MN-major B (``_t``) stored [k][n];
    ``rs_n8`` is the forward variants' row-sum form, its B (8 x 64, [n][k])
    in the unswizzled core-matrix layout of ``desc_plain``."""
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


@pytest.mark.parametrize("ksteps", [1, 4])
@pytest.mark.parametrize("mode", ["ss", "ss_int8"])
@pytest.mark.parametrize("n", [8, 32, 64, 128])
def test_wgmma_width_matches_matmul(gen, n, mode, ksteps):
    """The decode-MLP kernel's SS widths (``wf_wgmma_width_check``): D
    (64 x n) = A B^T with B (n x 64) K-major in the 128-byte swizzle and A
    by TMA (``ss``) or int8 converted by the threads into the swizzled bf16
    layout with ``hopper::int8x4_to_bf16x4`` (``ss_int8``, as the kernel
    converts int8 weights): exact, so only the fp32 sum order differs."""
    import ctypes

    from whisper_flamingo_tpu_torch.ops import cuda_build

    fn = cuda_build.load("wgmma_check").wf_wgmma_width_check
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    a8 = torch.randint(-128, 128, (64, 64), generator=gen, device="cuda", dtype=torch.int8)
    a = a8.bfloat16() if mode == "ss_int8" else torch.randn(64, 64, generator=gen,
                                                            device="cuda").bfloat16()
    b = torch.randn(n, 64, generator=gen, device="cuda").bfloat16()
    d = torch.full((64, n), float("nan"), device="cuda")
    err = fn(a.data_ptr(), a8.data_ptr(), b.data_ptr(), d.data_ptr(), n,
             {"ss": 0, "ss_int8": 1}[mode], ksteps, cuda_build.stream_ptr(a))
    cuda_build.check(err, "wgmma_width_check")
    torch.cuda.synchronize()
    kk = 16 * ksteps
    ref = a[:, :kk].float() @ b[:, :kk].float().t()
    assert (d - ref).abs().max().item() <= 1e-5 * max(ref.abs().max().item(), 1.0)


@pytest.mark.parametrize("form,width", [("ss_k", 64), ("ss_k", 128), ("ss_k", 256),
                                        ("rs_t", 64), ("rs_t", 128), ("rs_t", 256)])
def test_wgmma_pair_form_matches_matmul(gen, form, width):
    """The matmul-pair kernel's forms (``wf_wgmma_pair_check``): ``ss_k`` is
    D (64 x 64) = A (64 x K) B (K x 64) with A K-major over K / 64 tiles and
    B MN-major over K rows (the kernel's o @ u chunk, K = d); ``rs_t`` is D
    (64 x N) = A (64 x 64, registers) B (64 x N) with B MN-major over N / 64
    tiles, LBO apart (the kernel's w chunk @ v chunk, N = d). Exact products,
    so only the fp32 sum order differs from torch.matmul's."""
    import ctypes

    from whisper_flamingo_tpu_torch.ops import cuda_build

    fn = cuda_build.load("wgmma_check").wf_wgmma_pair_check
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    k, n = (width, 64) if form == "ss_k" else (64, width)
    a = torch.randn(64, k, generator=gen, device="cuda").bfloat16()
    b = torch.randn(k, n, generator=gen, device="cuda").bfloat16()
    d = torch.full((64, n), float("nan"), device="cuda")
    err = fn(a.data_ptr(), b.data_ptr(), d.data_ptr(), {"ss_k": 0, "rs_t": 1}[form], width,
             cuda_build.stream_ptr(a))
    cuda_build.check(err, "wgmma_pair_check")
    torch.cuda.synchronize()
    ref = a.float() @ b.float()
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


# the shipped bf16 forward's output bits on fixed inputs (numpy seed 0,
# (2, 3, T, 64), q and k 0.3 N(0, 1), v N(0, 1)), recorded from the kernel
# before its softmax became a policy of csrc/flash64_fwd_frame.cuh: sha256
# of o (as int16) and of the lse (as int32)
SHIPPED_DIGESTS = {129: ("7e766761e3c60136", "3e0d8bd705617e7d"),
                   1500: ("90425234a364434d", "02a6e7f65f4a181b")}


def _digest(x):
    import hashlib

    view = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    return hashlib.sha256(x.contiguous().view(view).cpu().numpy().tobytes()).hexdigest()[:16]


def _probe_inputs(t, seed=0):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((2, 3, t, 64), dtype=np.float32) * 0.3 for _ in range(2))
    v = rng.standard_normal((2, 3, t, 64), dtype=np.float32)
    return tuple(torch.from_numpy(x).cuda().bfloat16() for x in (q, k, v))


@pytest.mark.parametrize("t", [129, 1500])
def test_flash64_shipped_forward_bits_unchanged(gen, t):
    """The shipped forward on the frame gives the bits it gave before the
    frame split, with and without the lse."""
    q, k, v = _probe_inputs(t)
    o, lse = flash64.flash64_forward(q, k, v, with_lse=True)
    assert torch.equal(o, flash64.flash64_forward(q, k, v))
    assert (_digest(o), _digest(lse)) == SHIPPED_DIGESTS[t]


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


@pytest.mark.parametrize("dtype,rows,d,n_head", [
    (torch.bfloat16, 8, 768, 12), (torch.bfloat16, 120, 768, 12),
    (torch.float32, 8, 256, 8), (torch.float32, 8, 512, 4),
    (torch.float32, 120, 256, 8), (torch.bfloat16, 120, 512, 4),
])
def test_decode_attn_kernel_at_whisper_cache_length(gen, dtype, rows, d, n_head):
    """t_max 448 (Whisper's n_text_ctx): offsets across the chunk edges of
    both modes (32, 64 and 128 positions at bf16 d_head 64) and up to the
    last position, scalar and per row: d_head 64 in bf16 at 8 rows (the
    latency mode) and 120 (the throughput mode); fp32 at d_head 32 and 128
    in both modes; bf16 d_head 128 at 120 rows."""
    t_max = 448
    q, kn, vn = (torch.randn(rows, 1, d, generator=gen, device="cuda").to(dtype) for _ in range(3))
    kc = (torch.randn(rows, t_max, d, generator=gen, device="cuda") * 0.5).to(dtype)
    vc = (torch.randn(rows, t_max, d, generator=gen, device="cuda") * 0.5).to(dtype)
    per_row = torch.randint(0, t_max, (rows,), generator=gen, device="cuda", dtype=torch.int32)
    for off in (0, 15, 16, 31, 32, 63, 64, 66, 127, 128, 191, 192, 255, 256, t_max - 1,
                per_row):
        kc2, vc2 = kc.clone(), vc.clone()
        out, _, _ = decode_attn.fused_step(q, kn, vn, kc, vc, off, n_head)
        ref = decode_attn.fused_step_plain(q, kn, vn, kc2, vc2, off, n_head)
        assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype], off
        assert torch.equal(kc, kc2) and torch.equal(vc, vc2)


def test_decode_attn_smem_bytes_match_the_kernel(gen):
    """The wrapper's shared-memory sizing is the C side's."""
    import ctypes

    from whisper_flamingo_tpu_torch.ops import cuda_build

    fn = cuda_build.load("decode_attn").wf_decode_attn_smem_bytes
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5
    for t_max in (1, 40, 448, 1500, 20000):
        for dh in (32, 64, 128):
            for item in (2, 4):
                for latency in (False, True):
                    for indirect in (False, True):
                        assert (fn(t_max, dh, item, int(latency), int(indirect))
                                == decode_attn.smem_bytes(t_max, dh, item, latency, indirect))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d,n_head,t_max", [
    (120, 768, 12, 132), (120, 1280, 20, 68), (8, 768, 12, 132), (8, 1280, 20, 68),
    (40, 256, 8, 448), (120, 512, 4, 448),
], ids=["beam15", "av", "beam15-latency", "av-latency", "dh32", "dh128"])
def test_decode_attn_through_row_table(gen, dtype, rows, d, n_head, t_max):
    """The kernel read through a beam row table (``decode_attn.beam_rows``)
    at beam15's and the AV cell's self caches (120 rows: the throughput
    mode; 8: the latency mode) and at d_head 32 and 128, offsets from 3 to
    t_max - 1, scalar, a device scalar and per row: bit-equal to the kernel
    over the cache gathered by the table, within TOL of the plain version
    through the table, the same cache writes; the identity table gives the
    kernel's bits without one, and the table ignored fails TOL."""
    own = torch.arange(rows, device="cuda", dtype=torch.int32)[:, None]
    pos = torch.arange(t_max, device="cuda")[None]
    per_row = torch.randint(3, t_max, (rows,), generator=gen, device="cuda", dtype=torch.int32)
    device_scalar = torch.tensor([t_max // 3], dtype=torch.int32, device="cuda")
    for off in (3, 31, 32, 33, 64, t_max // 2, t_max - 1, device_scalar, per_row):
        q, kn, vn = (torch.randn(rows, 1, d, generator=gen, device="cuda").to(dtype)
                     for _ in range(3))
        kc = (torch.randn(rows, t_max, d, generator=gen, device="cuda") * 0.5).to(dtype)
        vc = (torch.randn(rows, t_max, d, generator=gen, device="cuda") * 0.5).to(dtype)
        offs = decode_attn._row_offsets(off, rows, "cuda")
        table = torch.randint(0, rows, (rows, t_max), generator=gen, device="cuda",
                              dtype=torch.int32)
        # no entry names a position its row writes in the same launch
        table = torch.where(offs[table.long()] == pos, own, table)
        src = torch.where(pos < offs[:, None], table.long(), own.long())
        kg, vg = kc[src, pos], vc[src, pos]
        kp, vp = kc.clone(), vc.clone()
        direct = decode_attn.fused_step(q, kn, vn, kg, vg, off, n_head)[0]
        with decode_attn.beam_rows(table):
            got = decode_attn.fused_step(q, kn, vn, kc, vc, off, n_head)[0]
            ref = decode_attn.fused_step_plain(q, kn, vn, kp, vp, off, n_head)
        assert torch.equal(got, direct)
        assert (got.float() - ref.float()).abs().max().item() <= TOL[dtype]
        assert torch.equal(kc, kp) and torch.equal(vc, vp)
        ignored = decode_attn.fused_step(q, kn, vn, kp.clone(), vp.clone(), off, n_head)[0]
        assert (ignored.float() - ref.float()).abs().max().item() > TOL[dtype]
        plain_rows = decode_attn.fused_step(q, kn, vn, kp.clone(), vp.clone(), off, n_head)[0]
        with decode_attn.beam_rows(own.expand(rows, t_max).contiguous()):
            identity = decode_attn.fused_step(q, kn, vn, kp.clone(), vp.clone(), off, n_head)[0]
        assert torch.equal(identity, plain_rows)


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


@pytest.mark.parametrize("n", [1, 31, 32, 33, 63, 64, 447, 1023])
def test_dtw_band_boundaries_bit_equal(gen, n):
    """At the edges of a warp's 32 rows, of the ring between warps, and at
    the most rows a trace takes: bit-equal to the plain version on N(0, 1)
    costs and on tie-rich integer costs (M 1500, and M 37: the trace rows
    start at every phase of a 16-byte span)."""
    rng = np.random.default_rng(n)
    for m, ints in ((1500, False), (37, True)):
        x = rng.integers(0, 3, (n, m)) if ints else rng.standard_normal((n, m))
        x = torch.from_numpy(x.astype(np.float32)).cuda()
        assert torch.equal(dtw.dtw_trace(x), dtw.dtw_trace_plain(x)), (m, ints)


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


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("rows", [1, 7, 8, 9, 16, 120, 128, 129, 1024])
def test_decode_mlp_row_counts(gen, int8, rows):
    """bf16 x at small's widths over every row tile (8 .. 128) and the row
    tiles a CTA walks past 128 rows (129, 1024): within the tolerance of
    the largest output, the same bits twice."""
    from whisper_flamingo_tpu_torch.ops import decode_mlp

    w1, b1, w2, b2, s1, s2 = _mlp_weights(gen, 768, 3072, torch.bfloat16, int8)
    x = torch.randn(rows, 768, generator=gen, device="cuda").bfloat16()
    out = decode_mlp._launch(x, w1, b1, w2, b2, s1, s2)
    again = decode_mlp._launch(x, w1, b1, w2, b2, s1, s2)
    assert out.shape == x.shape and torch.equal(out, again)
    ref = decode_mlp.fused_mlp_plain(x, w1, b1, w2, b2, s1, s2)
    scale = max(ref.float().abs().max().item(), 1.0)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2 * scale


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
    w1, b1, w2, b2, s1, s2 = _mlp_weights(gen, 64, 256, torch.bfloat16, True)
    x = torch.randn(4, 64, generator=gen, device="cuda").bfloat16()
    with pytest.raises(ValueError):  # x of another width than the weights'
        decode_mlp._launch(x[:, :48].contiguous(), w1, b1, w2, b2, s1, s2)
    with pytest.raises(ValueError):  # int8 weights without their second scale
        decode_mlp._launch(x, w1, b1, w2, b2, s1, None)
    decode_mlp._launch(x, w1, b1, w2, b2, s1, s2)  # checked once, then cached
    with pytest.raises(ValueError):  # x not 16-byte aligned, on the cached route
        decode_mlp._launch(x.view(-1)[1:].view(-1)[:3 * 64].view(3, 64), w1, b1, w2, b2, s1, s2)


# The builds of csrc/decode_mlp.cu the test runs: the shipped one, and with
# the test's own flag HOPPER_HANG_TRAP, so that a barrier wait that never
# completes faults instead of spinning.
EARLY_FC2 = {"shipped": [], "trap": ["-DHOPPER_HANG_TRAP=268435456"]}


@pytest.fixture(scope="module")
def early_fc2_libs():
    """The decode-MLP library in each of EARLY_FC2's builds."""
    from whisper_flamingo_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return {name: cuda_build.load("decode_mlp", flags) for name, flags in EARLY_FC2.items()}


@pytest.mark.parametrize("variant", sorted(EARLY_FC2))
@pytest.mark.parametrize("int8", [False, True])
def test_decode_mlp_early_fc2_launch(gen, monkeypatch, early_fc2_libs, variant, int8):
    """The reduced case of fc2's early launch (it once failed at the
    128-row tile): at small's widths, bf16 x, 120 and 128 rows first, then
    8, 32 and 1024 rows; every call after stale barriers are left in shared
    memory, 20 calls a size, each the bits of the shipped build."""
    import ctypes

    from whisper_flamingo_tpu_torch.ops import cuda_build, decode_mlp

    stale = cuda_build.load("wgmma_check").wf_stale_barriers
    stale.argtypes, stale.restype = [ctypes.c_void_p], ctypes.c_int
    libs = early_fc2_libs
    w1, b1, w2, b2, s1, s2 = _mlp_weights(gen, 768, 3072, torch.bfloat16, int8)
    for rows in (120, 128, 8, 32, 1024):
        x = torch.randn(rows, 768, generator=gen, device="cuda").bfloat16()
        want = decode_mlp._launch(x, w1, b1, w2, b2, s1, s2)
        with monkeypatch.context() as m:
            m.setattr(decode_mlp, "_CHECKED", {})  # handles from the variant's library
            m.setattr(decode_mlp, "_lib", lambda: decode_mlp._bind(libs[variant]))
            for _ in range(20):
                cuda_build.check(stale(cuda_build.stream_ptr(x)), "stale barriers")
                got = decode_mlp._launch(x, w1, b1, w2, b2, s1, s2)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (variant, int8, rows)


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


def _decode_loop(task, mel, xt):
    from whisper_flamingo_tpu_torch import decoding

    feats = decoding._features(task.model, mel, task.compute_dtype)
    init = torch.tensor([task.initial_tokens] * mel.shape[0], device="cuda")
    return task._main_loop(feats, init, xt)


def _launches_per_forward(task, mel, xt):
    """The launches (runtime calls that put an operation on the card; a
    graph replay counts once) of each incremental forward of one profiled
    decode, and the operations the profiler saw launched by
    ``cudaGraphLaunch``."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from whisper_flamingo_tpu_torch import decoding

    ranges = []
    apply = decoding.decoder_apply

    def timed(params, dims, tokens, *args, **kwargs):
        t0 = time.time_ns()
        out = apply(params, dims, tokens, *args, **kwargs)
        if kwargs.get("cache") is not None and tokens.shape[-1] == 1:
            ranges.append((t0, time.time_ns()))
        return out

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decoding.decoder_apply = timed
        try:
            _decode_loop(task, mel, xt)
        finally:
            decoding.decoder_apply = apply
        torch.cuda.synchronize()
    raw = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    ops = [e.correlation_id() for e in raw if e.device_type() == cuda]
    with_ops = set(ops)
    calls = {}
    for e in raw:
        if e.device_type() != cuda and e.correlation_id() in with_ops:
            calls.setdefault(e.correlation_id(), (e.start_ns(), e.name()))
    per_forward = [sum(a <= t <= b for t, _ in calls.values()) for a, b in ranges]
    graph_ops = sum(calls.get(c, (0, ""))[1] == "cudaGraphLaunch" for c in ops)
    return per_forward, graph_ops


def _graphs_against_eager(model, mel, xt, opts):
    """The task's step graphs against the unsegmented step (a task with no
    holder): loop outputs bit-equal, one capture, every forward after the
    warm-up replayed; returns the launches of each forward of a decode at
    the captured key (the first copies the batch's slabs in)."""
    import whisper_flamingo_tpu_torch as wt
    from whisper_flamingo_tpu_torch import profiling
    from whisper_flamingo_tpu_torch.models.whisper import StepGraphs

    eager = wt.DecodingTask(model, opts)
    eager.step_graphs = None
    want = _decode_loop(eager, mel, xt)
    task = wt.DecodingTask(model, opts)
    with profiling.collect() as sink:
        got = _decode_loop(task, mel, xt)
    forwards = sum(s.name == "decode.forward" for s in sink.spans)
    assert forwards > StepGraphs.WARMUP
    assert sink.counters["decode.graph_captures"] == 1
    assert sink.counters["decode.graph_steps"] == forwards - StepGraphs.WARMUP
    assert sink.counters["decode.eager_steps"] == StepGraphs.WARMUP
    again = _decode_loop(task, mel, xt)  # the key's graphs, the slabs refilled
    for out in (got, again):
        for key in ("tokens", "sum_logprobs", "fin_scores"):
            if key in want:
                diff = (out[key].double() - want[key].double()).abs().nan_to_num(0.0).max()
                assert torch.equal(out[key], want[key]), (key, float(diff))
    per_forward, graph_ops = _launches_per_forward(task, mel, xt)
    assert len(task.step_graphs._built) == 1
    return per_forward, graph_ops


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("beam", [None, 3])
def test_debug_step_graphs_equal_eager(gen, dtype, beam):
    """Greedy and beam at debug widths with d_head 64: the replayed step
    gives the unsegmented step's tokens and scores bit for bit, in 2 + 3
    launches a layer + 1 a forward."""
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
    opts = wt.DecodingOptions(language="en", fp16=dtype == torch.bfloat16, sample_len=12,
                              beam_size=beam)
    per_forward, graph_ops = _graphs_against_eager(model, mel, None, opts)
    launches = 3 + 3 * dims.n_text_layer
    assert per_forward == [launches + 2] + [launches] * (len(per_forward) - 1), per_forward
    assert graph_ops > 0


def test_small_gated_beam15_step_graphs_equal_eager(gen):
    """The beam cell's path at its widths: Whisper ``small`` with one gated
    text stream at mBERT's width (gates at 1), bf16, beam 15 on b8: the
    replayed step gives the unsegmented step's tokens, ``sum_logprobs`` and
    ``fin_scores`` bit for bit, in at most 45 launches a forward."""
    import whisper_flamingo_tpu_torch as wt
    from whisper_flamingo_tpu_torch.models.dims import MODEL_DIMS

    dims = MODEL_DIMS["small"]
    extras = wt.ModelExtras(add_gated_x_attn=1, num_langs=1, bert_dim=768)
    model = wt.init_params(torch.Generator(device="cuda").manual_seed(2), dims, extras,
                           device="cuda")
    with torch.no_grad():
        for blk in model.decoder.blocks:
            blk.ff_gate.fill_(1.0)
            blk.gated_x_attn_layers[0].attn_gate.fill_(1.0)
    rng = np.random.default_rng(1)
    mel = torch.from_numpy(rng.standard_normal((8, 80, 3000)).astype(np.float32) * 0.5).cuda()
    xt = torch.from_numpy(rng.standard_normal((1, 8, 128, 768)).astype(np.float32)).cuda()
    opts = wt.DecodingOptions(language="en", without_timestamps=True, beam_size=15,
                              sample_len=24)
    per_forward, graph_ops = _graphs_against_eager(model, mel, xt, opts)
    assert max(per_forward) <= 45, per_forward
    assert graph_ops > 0


# the probe kernels: bf16 outputs within one ulp of their scale (2^-7 of the
# largest magnitude; fp32 sums in another order can flip a bf16 rounding)
PROBE_REL = 2.0 ** -7


@pytest.mark.parametrize("variant", ["augv", "csbound"])
@pytest.mark.parametrize("t", [1, 63, 127, 129, 300, 1500])
def test_flash64_variant_kernels_match_plain(gen, variant, t):
    """The forward variants at the probe's scales (q, k 0.3 N(0, 1)), at the
    edges of the frame's 128-row blocks and tiles (T % 4 != 0 among them);
    the online softmax of augv rounds its probabilities against a running
    max, so it is held at the shipped kernel's 1e-2 of the output scale;
    two launches give the same bits."""
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
    if variant == "csbound":  # kmax computed beforehand, as when timed alone
        assert torch.equal(fn(q, k, v, fv.key_norm_max(k)), out)
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
@pytest.mark.parametrize("d,n", [(64, 1536), (128, 1536), (256, 1536), (128, 3072)])
def test_mma_pair_kernel_matches_plain(gen, d, n, iters):
    """The pair loop at the probe's scales and four points, at 256 rows and
    at 33,792 (the plan's two launches of each point: 64 rows a CTA, and as
    many warpgroups a CTA as fit); reruns give the same bits."""
    from whisper_flamingo_tpu_torch.ops import mma_pair

    for rows in (256, 2 * 132 * 128):
        w = torch.randn(rows, n, generator=gen, device="cuda").bfloat16()
        v = (torch.randn(n, d, generator=gen, device="cuda") * 0.1).bfloat16()
        u = (torch.randn(d, n, generator=gen, device="cuda") * 0.1).bfloat16()
        ref = mma_pair.pair_chain_plain(w, v, u, iters)
        scale = ref.float().abs().max().item()
        before = mma_pair.pair_chain.launches
        out, again = mma_pair.pair_chain(w, v, u, iters), mma_pair.pair_chain(w, v, u, iters)
        p = mma_pair.plan(rows, n, d)
        assert mma_pair.pair_chain.launches == before + 2 and torch.equal(out, again), p
        assert scale > 0 and (out.float() - ref.float()).abs().max().item() <= PROBE_REL * scale, p


def test_mma_pair_kernel_takes_half_chunks_and_odd_row_blocks(gen):
    """n / C of 160 or 96 (a last chunk of 32 columns, zero-padded), and
    8,512 rows (133 blocks of 64) in CTAs of two or four warpgroups (the
    last CTA's later row blocks idle), each in the plan's own launch."""
    from whisper_flamingo_tpu_torch.ops import mma_pair

    for d, n, rows in ((64, 1280, 192), (64, 1536, 8512), (128, 1280, 8512), (256, 1536, 128)):
        w = torch.randn(rows, n, generator=gen, device="cuda").bfloat16()
        v = (torch.randn(n, d, generator=gen, device="cuda") * 0.1).bfloat16()
        u = (torch.randn(d, n, generator=gen, device="cuda") * 0.1).bfloat16()
        ref = mma_pair.pair_chain_plain(w, v, u, 2)
        out = mma_pair.pair_chain(w, v, u, 2)
        scale = ref.float().abs().max().item()
        p = mma_pair.plan(rows, n, d)
        assert (out.float() - ref.float()).abs().max().item() <= PROBE_REL * scale, (d, n, rows, p)


def test_mma_pair_kernel_refuses_what_it_cannot_take(gen):
    from whisper_flamingo_tpu_torch.ops import mma_pair

    w = torch.randn(128, 128, generator=gen, device="cuda").bfloat16()
    v = torch.randn(128, 64, generator=gen, device="cuda").bfloat16()
    u = torch.randn(64, 128, generator=gen, device="cuda").bfloat16()
    with pytest.raises(ValueError):  # rows not a multiple of 64
        mma_pair.pair_chain(w[:32].contiguous(), v, u, 1)
    with pytest.raises(ValueError):  # d 96
        mma_pair.pair_chain(w, v.repeat(1, 2)[:, :96].contiguous(), u.repeat(2, 1)[:96].contiguous(), 1)
    with pytest.raises(TypeError):  # fp32
        mma_pair.pair_chain(w.float(), v.float(), u.float(), 1)
    with pytest.raises(ValueError):  # iters 0
        mma_pair.pair_chain(w, v, u, 0)
    with pytest.raises(ValueError):  # n 96: no cluster leaves a multiple of 32 columns
        mma_pair.pair_chain(w[:, :96].contiguous(), v[:96].contiguous(), u[:, :96].contiguous(), 1)


# The cached cross-attention kernel (ops/xattn_step) at the cells' shapes:
# (slab rows, heads, query rows a slab row, keys, valid keys or None)
XATTN_SHAPES = {
    "av_audio_beam15": (8, 20, 15, 1500, None),
    "av_gated_beam15": (8, 20, 15, 448, (86, 375)),
    "small_audio_beam15": (8, 12, 15, 1500, None),
    "small_text_beam15": (8, 12, 15, 128, None),
    "serve_16_rows": (16, 20, 1, 1500, None),
    "prefill_224": (8, 20, 224, 1500, None),
    "prefill_beam15_t3": (8, 20, 45, 448, (86, 375)),
}


def _xattn_inputs(gen, slabs, heads, rows, keys, valid, dtype=torch.bfloat16):
    from whisper_flamingo_tpu_torch.ops.attention import head_split_kv

    d = heads * 64
    q = torch.randn(slabs, rows, d, generator=gen, device="cuda").to(dtype)
    k = (head_split_kv(torch.randn(slabs, keys, d, generator=gen, device="cuda"), heads)
         * 64 ** -0.25).to(dtype)
    v = head_split_kv(torch.randn(slabs, keys, d, generator=gen, device="cuda"), heads).to(dtype)
    mask = None
    if valid is not None:  # a capacity slab: zero past each row's keys, masked there
        lengths = torch.randint(valid[0], valid[1] + 1, (slabs,), generator=gen, device="cuda")
        past = torch.arange(keys, device="cuda")[None] >= lengths[:, None]
        k.masked_fill_(past[:, None, :, None], 0)
        v.masked_fill_(past[:, None, :, None], 0)
        mask = torch.zeros(slabs, 1, 1, keys, device="cuda").masked_fill_(
            past[:, None, None], float("-inf"))
    return q, k, v, mask


# The kernel's own limits against its plain version: the largest |err| and
# the rms error over the plain output's rms. Over eight seeds at these
# shapes the sound kernel read at most 3.9e-3 (2 ulp of bf16 at 0.5) and
# 2.0e-4; a dropped 28-key last tile read at least 0.043 and 0.13, an
# ignored mask 0.19 and 0.26 (test_xattn_limits_refuse_planted_faults).
XATTN_MAX_ERR = 8e-3
XATTN_RMS_REL = 5e-3


def _xattn_close(out, ref):
    diff = out.float() - ref.float()
    err, rms = diff.abs().max().item(), (diff.norm() / ref.float().norm()).item()
    return err <= XATTN_MAX_ERR and rms <= XATTN_RMS_REL, (err, rms)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", sorted(XATTN_SHAPES))
def test_xattn_kernel_matches_plain(gen, name, dtype):
    """The kernel against its plain version (``attention.xa_qkv_plain``)
    at each cell's shape; two launches give the same bits."""
    from whisper_flamingo_tpu_torch.ops import xattn_step
    from whisper_flamingo_tpu_torch.ops.attention import xa_qkv_plain

    slabs, heads, rows, keys, valid = XATTN_SHAPES[name]
    q, k, v, mask = _xattn_inputs(gen, slabs, heads, rows, keys, valid, dtype)
    before = xattn_step.xattn_step.launches
    out = xattn_step.xattn_step(q, k, v, heads, mask)
    again = xattn_step.xattn_step(q, k, v, heads, mask)
    assert xattn_step.xattn_step.launches == before + 2
    ref = xa_qkv_plain(q, k, v, heads, mask)
    assert out.dtype == dtype and out.shape == q.shape
    close, errs = _xattn_close(out, ref)
    assert close, errs
    assert torch.equal(out, again)


@pytest.mark.parametrize("fault", ["tile_dropped", "mask_ignored"])
def test_xattn_limits_refuse_planted_faults(gen, fault):
    """The limits refuse a kernel that drops the 28-key last tile of 1,500
    audio keys, or one that ignores a gated slab's mask."""
    from whisper_flamingo_tpu_torch.ops import xattn_step
    from whisper_flamingo_tpu_torch.ops.attention import xa_qkv_plain

    if fault == "tile_dropped":
        q, k, v, mask = _xattn_inputs(gen, 8, 20, 15, 1500, None)
        got = xattn_step.xattn_step(q, k[:, :, :1472].contiguous(), v[:, :, :1472].contiguous(),
                                    20)
    else:
        q, k, v, mask = _xattn_inputs(gen, 8, 20, 15, 448, (86, 375))
        got = xattn_step.xattn_step(q, k, v, 20)
    close, errs = _xattn_close(got, xa_qkv_plain(q, k, v, 20, mask))
    assert not close, errs


def test_xattn_kernel_in_a_cuda_graph(gen):
    """Captured in a CUDA graph (as the decode step's segments capture it),
    a replay gives the eager launch's bits, with new q values read."""
    from whisper_flamingo_tpu_torch.ops import xattn_step

    q, k, v, mask = _xattn_inputs(gen, 8, 20, 15, 448, (86, 375))
    xattn_step.xattn_step(q, k, v, 20, mask)  # eager first: the launch's one-time set-up
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin()
        out = xattn_step.xattn_step(q, k, v, 20, mask)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(2):
        q.copy_(torch.randn(q.shape, generator=gen, device="cuda"))
        graph.replay()
        assert torch.equal(out, xattn_step.xattn_step(q, k, v, 20, mask))


def test_xattn_route_counts_the_kernel(gen):
    """``xa_qkv_attention`` sends bf16 slabs to the kernel and fp32 and
    int8 ones to the plain product, each call counted."""
    from whisper_flamingo_tpu_torch import profiling
    from whisper_flamingo_tpu_torch.ops import xattn_step
    from whisper_flamingo_tpu_torch.ops.attention import xa_qkv_attention

    q, k, v, mask = _xattn_inputs(gen, 2, 4, 15, 448, (86, 375))
    before = xattn_step.xattn_step.launches
    with profiling.collect() as sink:
        out = xa_qkv_attention(q, k, v, 4, mask=mask)
        xa_qkv_attention(q.float(), k.float(), v.float(), 4, mask=mask)
        scale = torch.ones(2, 4, 1, 1, device="cuda")
        xa_qkv_attention(q, k.to(torch.int8), v.to(torch.int8), 4, scale, scale, mask=mask)
    assert xattn_step.xattn_step.launches == before + 1
    assert sink.counters["decode.xattn_kernel"] == 1
    assert sink.counters["decode.xattn_plain"] == 2
    assert torch.equal(out, xattn_step.xattn_step(q, k, v, 4, mask))


def test_xattn_plan_from_the_runtime_occupancy(gen):
    """The card's occupancy for the kernel falls as a block's key tiles
    grow and is 0 past what a block's shared memory holds; the plan on it
    runs the AV beam step's audio and gated slabs in one wave of at least
    two blocks an SM."""
    from whisper_flamingo_tpu_torch.ops import xattn_step

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.bfloat16, torch.float16):
        occ = xattn_step.occupancy(0, dtype)
        counts = [occ(tpc) for tpc in (1, 2, 4, 6, 12, 24, 40)]
        assert counts[0] >= 2 and all(a >= b >= 1 for a, b in zip(counts, counts[1:])), counts
        assert occ(64) == 0
        for keys in (1500, 448):
            cluster, tpc = xattn_step.plan(8, 15, keys, 20, sms, occ)
            assert 2 * sms <= 8 * 20 * cluster <= occ(tpc) * sms


def test_xattn_kernel_refuses_what_it_cannot_take(gen):
    from whisper_flamingo_tpu_torch.ops import xattn_step

    q, k, v, mask = _xattn_inputs(gen, 2, 4, 15, 200, None)
    with pytest.raises(TypeError):  # fp32
        xattn_step.xattn_step(q.float(), k.float(), v.float(), 4)
    with pytest.raises(TypeError):  # int8 slabs
        xattn_step.xattn_step(q, k.to(torch.int8), v.to(torch.int8), 4)
    with pytest.raises(ValueError):  # a non-contiguous K
        xattn_step.xattn_step(q, k.transpose(2, 3).contiguous().transpose(2, 3), v, 4)
    flat = torch.empty(k.numel() + 1, dtype=k.dtype, device="cuda")
    shifted = flat[1:].view(k.shape)  # 2 bytes off a 16-byte boundary
    shifted.copy_(k)
    with pytest.raises(ValueError):  # misaligned
        xattn_step.xattn_step(q, shifted, v, 4)
    with pytest.raises(ValueError):  # a per-query mask
        xattn_step.xattn_step(q, k, v, 4, torch.zeros(2, 1, 15, 200, device="cuda"))
    with pytest.raises(ValueError):  # d_head 32
        xattn_step.xattn_step(q, k.reshape(2, 8, 200, 32), v.reshape(2, 8, 200, 32), 8)
