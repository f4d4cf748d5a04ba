"""The yardstick's arithmetic against hand counts."""

import pytest

from perfbench import flops, roofline, spec


def test_flash64_bound_at_the_encoder_shape():
    # 4 x 96 x 1500^2 x 64 operations at 989 TFLOP/s
    assert roofline.flash64_fwd_s(96, 1500, "bfloat16") * 1e3 == pytest.approx(0.05591, abs=5e-6)


def test_decode_attn_bound_at_8_rows_offset_66():
    # 2 B x 8 rows x 768 x (2 x 66 + 6) bytes at 3.35 TB/s
    assert roofline.decode_attn_s(8, 768, 66, "bfloat16") * 1e3 == pytest.approx(0.000506,
                                                                                  abs=5e-7)
    assert roofline.decode_attn_s(2, 768, [66, 66], "bfloat16") == pytest.approx(
        roofline.decode_attn_s(2, 768, 66, "bfloat16"))


def test_flash64_backward_counts_five_products():
    t = roofline.flash64_bwd_s(96, 1500, "bfloat16")
    assert t == pytest.approx(5 * 2 * 96 * 1500 ** 2 * 64 / 989e12)


def test_model_flops_large_v2_b8():
    dims = spec.config("whisper-large-v2")["dims"]
    assert flops.model_flops(dims, 8) == pytest.approx(22.6e12, rel=5e-3)


def test_model_flops_matches_the_ports_arithmetic():
    from whisper_flamingo_tpu_torch.models.dims import ModelDimensions
    from whisper_flamingo_tpu_torch.profiling import model_flops

    for name in ("whisper-large-v2", "flamingo-small-text"):
        dims = spec.config(name)["dims"]
        for kw in ({}, {"mel_frames": 1000, "text_len": 96, "n_xt_streams": 1, "xt_len": 128}):
            assert flops.model_flops(dims, 8, **kw) == model_flops(ModelDimensions(**dims), 8,
                                                                   **kw)


def test_cached_tokens_sum_to_the_teacher_forced_decoder():
    # the cached decoder's tokens 0..T-1 plus the static K/V do the
    # teacher-forced decoder's products, less the masked half of its T x T
    # self-attention, which the causal cache never computes
    dims = spec.config("flamingo-small-text")["dims"]
    t, d = 64, dims["n_text_state"]
    cached = flops.decode_flops(dims, range(t)) + flops.static_kv_flops(dims)
    full = flops.model_flops(dims, 1, text_len=t) - flops.encoder_flops(dims)
    masked = dims["n_text_layer"] * 4 * d * (t * t - t * (t + 1) // 2)
    assert cached == pytest.approx(full - masked, rel=1e-12)
