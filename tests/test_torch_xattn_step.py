"""The cached cross-attention's plain version (``attention.xa_qkv_plain``)
and the kernel's launch plan (``ops/xattn_step``), on the CPU: the plain
version equals the ``xa_qkv_attention`` route over the fp32 K slabs that
``init_cache`` kept before K moved to the compute dtype, bit for bit, for beam groups folded
into the query rows, many-row prefills and capacity masks; ``init_cache``
keeps the same K values in the compute dtype; a bf16 beam decode gives the
same tokens over either slab dtype; and the plan fits every cell's shape.
The kernel itself is held to this plain version on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from whisper_flamingo_tpu_torch import decoding
from whisper_flamingo_tpu_torch.decoding import DecodingOptions, DecodingTask
from whisper_flamingo_tpu_torch.models.dims import MODEL_DIMS
from whisper_flamingo_tpu_torch.models.whisper import ModelExtras, init_cache, init_params
from whisper_flamingo_tpu_torch.ops import xattn_step
from whisper_flamingo_tpu_torch.ops.attention import xa_qkv_attention, xa_qkv_plain

DIMS = MODEL_DIMS["debug"]
HEADS, DH = 2, 64
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _slabs(seed, b, m, tk, dtype):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, m, HEADS * DH, generator=gen).to(dtype)
    k = (torch.randn(b, HEADS, tk, DH, generator=gen) * DH ** -0.25).to(dtype)
    v = torch.randn(b, HEADS, tk, DH, generator=gen).to(dtype)
    return q, k, v


def _capacity_mask(valid, cap):
    mask = torch.zeros((len(valid), 1, 1, cap))
    for i, n in enumerate(valid):
        mask[i, ..., n:] = float("-inf")
    return mask


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("group,t", [(1, 1), (1, 3), (15, 1), (15, 3)])
def test_plain_equals_route_over_beam_groups(dtype, group, t):
    """G beams x t tokens folded into one slab row's queries, as
    ``attention_block`` folds them, over 1,500 audio keys; the route is
    given the parent's fp32 K slab."""
    b = 2
    q, k, v = _slabs(0, b * group, t, 1500, DTYPES[dtype])
    k, v = k[::group].contiguous(), v[::group].contiguous()
    qf = q.reshape(b, group * t, HEADS * DH)
    got = xa_qkv_plain(qf, k, v, HEADS)
    want = xa_qkv_attention(qf, k.float(), v, HEADS)
    assert got.dtype == q.dtype and got.shape == qf.shape
    assert torch.equal(got, want)
    assert torch.equal(xa_qkv_attention(qf, k, v, HEADS), want)  # the route over K in q's dtype


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rows", [17, 40, 224])
def test_plain_equals_route_many_rows(dtype, rows):
    """More rows than one 16-row tile: a prompt's prefill."""
    q, k, v = _slabs(1, 2, rows, 1500, DTYPES[dtype])
    assert torch.equal(xa_qkv_plain(q, k, v, HEADS),
                       xa_qkv_attention(q, k.float(), v, HEADS))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("valid", [(86, 200, 448), (448, 86, 375)])
def test_plain_equals_route_with_capacity_mask(dtype, valid):
    """Gated slabs held at the 448-key capacity, masked past each stream's
    length; the keys past it are zero, as ``init_cache`` leaves them."""
    q, k, v = _slabs(2, 3, 15, 448, DTYPES[dtype])
    for i, n in enumerate(valid):
        k[i, :, n:] = 0
        v[i, :, n:] = 0
    mask = _capacity_mask(valid, 448)
    got = xa_qkv_plain(q, k, v, HEADS, mask)
    assert torch.equal(got, xa_qkv_attention(q, k.float(), v, HEADS, mask=mask))
    assert torch.isfinite(got.float()).all()
    # the masked keys take no part: the same as attending to each row's own keys
    for i, n in enumerate(valid):
        alone = xa_qkv_plain(q[i:i + 1], k[i:i + 1, :, :n].contiguous(),
                                       v[i:i + 1, :, :n].contiguous(), HEADS)
        torch.testing.assert_close(got[i:i + 1].float(), alone.float(), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def models():
    plain = init_params(torch.Generator().manual_seed(0), DIMS, device="cpu")
    gated = init_params(torch.Generator().manual_seed(1), DIMS,
                        ModelExtras(add_gated_x_attn=1, num_langs=1, bert_dim=32), device="cpu")
    with torch.no_grad():  # open the gates: a zero gate would hide the streams
        for blk in gated.decoder.blocks:
            blk.ff_gate.fill_(0.5)
            for sub in blk.gated_x_attn_layers:
                sub.attn_gate.fill_(0.5)
    return {"plain": plain, "gated": gated}


def _fp32_k(cache):
    """The parent's slabs: K upcast to fp32, holding the compute-dtype values."""
    for key in ("xa_k", "xt_k"):
        if key in cache and cache[key].dtype != torch.int8:
            cache[key] = cache[key].float()
    return cache


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("at_ctx", [False, True])
def test_init_cache_keeps_k_in_the_compute_dtype(models, dtype, at_ctx):
    """K is stored in the compute dtype, with the values the fp32 slab held;
    the cached attention over either is the same."""
    dt = DTYPES[dtype]
    gen = torch.Generator().manual_seed(3)
    feats = torch.randn(2, DIMS.n_audio_ctx, DIMS.n_audio_state, generator=gen)
    xt = torch.randn(1, 2, 7, 32, generator=gen)
    params = models["gated"]
    cache = init_cache(params, DIMS, feats, xt=xt, dtype=dt, xt_at_ctx=at_ctx)
    parent = _fp32_k(init_cache(params, DIMS, feats, xt=xt, dtype=dt, xt_at_ctx=at_ctx))
    for key in ("xa_k", "xa_v", "xt_k", "xt_v"):
        assert cache[key].dtype == dt
        assert torch.equal(cache[key].float(), parent[key].float())
    heads = DIMS.n_text_head
    q = torch.randn(2, 15, DIMS.n_text_state, generator=gen).to(dt)
    mask = cache.get("xt_mask")
    for key in ("xa", "xt"):
        k, v = cache[f"{key}_k"][0], cache[f"{key}_v"][0]
        kp = parent[f"{key}_k"][0]
        if key == "xt":
            k, v, kp = k[0], v[0], kp[0]
        m = mask if key == "xt" else None
        assert torch.equal(xa_qkv_plain(q, k, v, heads, m),
                           xa_qkv_attention(q, kp, v, heads, mask=m))


@pytest.mark.parametrize("kind", ["plain", "gated"])
def test_bf16_beam_tokens_as_over_fp32_k(models, kind, monkeypatch):
    """A bf16 beam decode on the CPU gives the same tokens and scores over
    the compute-dtype K slabs as over the parent's fp32 ones."""
    rng = np.random.default_rng(4)
    mel = torch.from_numpy(rng.standard_normal((2, 80, 3000)).astype(np.float32) * 0.5)
    xt = None
    if kind == "gated":
        xt = torch.from_numpy(rng.standard_normal((1, 2, 6, 32)).astype(np.float32))
    options = DecodingOptions(language="en", without_timestamps=True, sample_len=6, fp16=True,
                              beam_size=3)
    got = DecodingTask(models[kind], options).run(mel, xt=xt)
    init = decoding.init_cache
    monkeypatch.setattr(decoding, "init_cache", lambda *a, **kw: _fp32_k(init(*a, **kw)))
    want = DecodingTask(models[kind], options).run(mel, xt=xt)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.avg_logprob for r in got] == [r.avg_logprob for r in want]


# (slab rows, query rows a slab row, keys, heads): the cells' calls
SHAPES = {
    "av_audio_step": (8, 15, 1500, 20),
    "av_gated_step": (8, 15, 448, 20),
    "beam15_audio_step": (8, 15, 1500, 12),
    "beam15_text_step": (8, 15, 128, 12),
    "serve_step": (16, 1, 1500, 20),
    "longform_step": (1, 1, 1500, 20),
    "av_prefill": (8, 45, 1500, 20),
    "prompt_prefill": (8, 224, 1500, 20),
}


def h100_like(tpc):
    """A stub of the card's occupancy for the plan: a block of ``tpc`` key
    tiles takes about 23 KB and 4.25 KB a tile of shared memory (at most
    227 KB), an SM holds 228 KB with 1 KB more a block, and its registers
    hold 7 blocks."""
    smem = 23 * 1024 + 4352 * tpc
    return 0 if smem > 227 * 1024 else min(7, 228 * 1024 // (smem + 1024))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_fits_every_cell(name):
    """The plan covers every key once, in blocks the card can hold; a beam
    step's grid (the AV and text cells) runs in one wave of at least two
    blocks an SM of the card's 132."""
    slabs, rows, keys, heads = SHAPES[name]
    cluster, tpc = xattn_step.plan(slabs, rows, keys, heads, 132, h100_like)
    assert cluster in (1, 2, 4, 8)
    assert (cluster - 1) * tpc * 64 < keys <= cluster * tpc * 64
    assert h100_like(tpc) > 0
    blocks = slabs * heads * -(-rows // 16) * cluster
    if name.endswith("audio_step") or name == "av_gated_step":
        assert 2 * 132 <= blocks <= h100_like(tpc) * 132


def test_plan_refuses_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match="shared memory"):
        xattn_step.plan(1, 16, 64 * 400, 1, 132, h100_like)


def test_wrapper_raises_without_a_kernel():
    """The wrapper launches the kernel or raises: off the card it raises,
    and the route sends it only CUDA tensors."""
    q = torch.empty(2, 15, 128, dtype=torch.bfloat16)
    k = torch.empty(2, 2, 1500, 64, dtype=torch.bfloat16)
    for device in ("cpu", "meta"):
        with pytest.raises(RuntimeError, match="no kernel"):
            xattn_step.xattn_step(q.to(device), k.to(device), k.to(device), 2)
        assert not xattn_step.takes(q.to(device), k.to(device), 2)
