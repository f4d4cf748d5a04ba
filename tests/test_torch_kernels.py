"""The port's kernel modules on the CPU: each plain version against the JAX
package's Pallas kernel run in interpret mode, and the wrappers' CPU rule
(a CPU tensor takes the plain version and launches nothing).

Tolerances: fp32 throughout; 1e-5 for the attention outputs (values of
order 1, sums in another order and, for flash64, an online vs whole-row
softmax on the JAX side's "mxu" row sum), 1e-6 for the updated caches
(the same one multiplication per element).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_flamingo_tpu.ops import decode_attn as jdecode
from whisper_flamingo_tpu.ops.flash64 import flash64_attention as jflash

from whisper_flamingo_tpu_torch.ops import decode_attn, flash64


@pytest.mark.parametrize("t", [640, 300])
def test_flash64_plain_matches_jax_interpret(t):
    rng = np.random.default_rng(t)
    q, k, v = (rng.standard_normal((1, 2, t, 64)).astype(np.float32) * 0.3 for _ in range(3))
    ref = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    got = flash64.flash64_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def _decode_inputs(rng, b, t_max, d):
    q, k_raw, v_raw = (rng.standard_normal((b, 1, d)).astype(np.float32) for _ in range(3))
    k_cache = rng.standard_normal((b, t_max, d)).astype(np.float32) * 0.5
    v_cache = rng.standard_normal((b, t_max, d)).astype(np.float32) * 0.5
    return q, k_raw, v_raw, k_cache, v_cache


def _check_decode(inputs, j_offset, t_offset, n_head):
    q, k_raw, v_raw, k_cache, v_cache = inputs
    ref, rk, rv = jdecode.fused_step(
        *(jnp.asarray(a) for a in inputs), j_offset, n_head
    )
    kc, vc = torch.from_numpy(k_cache.copy()), torch.from_numpy(v_cache.copy())
    got = decode_attn.fused_step_plain(
        torch.from_numpy(q), torch.from_numpy(k_raw), torch.from_numpy(v_raw),
        kc, vc, t_offset, n_head,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(kc.numpy(), np.asarray(rk), atol=1e-6, rtol=0)
    np.testing.assert_allclose(vc.numpy(), np.asarray(rv), atol=1e-6, rtol=0)


@pytest.mark.parametrize("offset", [0, 7, 39])
def test_decode_attn_plain_scalar_offset(offset):
    rng = np.random.default_rng(offset)
    inputs = _decode_inputs(rng, 3, 40, 128)
    _check_decode(inputs, offset, offset, n_head=2)


def test_decode_attn_plain_per_row_offsets():
    rng = np.random.default_rng(1)
    inputs = _decode_inputs(rng, 4, 24, 128)
    offsets = np.asarray([0, 5, 23, 11], np.int32)
    _check_decode(inputs, jnp.asarray(offsets), torch.from_numpy(offsets), n_head=2)


def test_decode_attn_plain_lockstep_rows(monkeypatch):
    """Many rows sharing one scalar offset (the beam step), against the
    JAX lockstep kernel (``_kernel_multi``) forced on; the port's offset is
    a one-element device tensor, as the decoder passes it."""
    monkeypatch.setattr(jdecode, "MULTI_ENABLED", True)
    rng = np.random.default_rng(3)
    inputs = _decode_inputs(rng, 40, 24, 128)
    assert jdecode._pick_multi(40, 24, 128, 4) == 8
    for offset in (0, 13, 23):
        _check_decode(
            inputs, jnp.int32(offset), torch.tensor([offset], dtype=torch.int32), n_head=2
        )


def test_wrappers_take_plain_version_for_cpu_tensors():
    """On CPU tensors the wrappers run the plain versions and leave their
    launch counters alone."""
    flash64.flash64_forward.launches = 0
    flash64.flash64_backward.launches = 0
    decode_attn.fused_step.launches = 0
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 50, 64, generator=g) for _ in range(3))
    out = flash64.flash64_attention(q, k, v)
    assert torch.equal(out, flash64.flash64_attention_plain(q, k, v))

    qd, kd, vd = (torch.randn(2, 1, 64, generator=g) for _ in range(3))
    kc, vc = torch.zeros(2, 8, 64), torch.zeros(2, 8, 64)
    kc2, vc2 = kc.clone(), vc.clone()
    out, k_out, v_out = decode_attn.fused_step(qd, kd, vd, kc, vc, 3, 1)
    assert k_out is kc and v_out is vc  # updated in place
    ref = decode_attn.fused_step_plain(qd, kd, vd, kc2, vc2, 3, 1)
    assert torch.equal(out, ref) and torch.equal(kc, kc2)
    assert flash64.flash64_forward.launches == 0
    assert flash64.flash64_backward.launches == 0
    assert decode_attn.fused_step.launches == 0


@pytest.mark.parametrize("latency", [False, True])
def test_decode_attn_smem_sizing(latency):
    """The wrapper's shared-memory sizing of the decode-attention kernel:
    chunk 0 of K and V plus the ring (5 x 8 KB in the latency mode, 4 x 4 KB
    in the throughput mode), the new row, the warps' V partials (16 warps,
    4) and t_max fp32 logits; in the throughput mode `small`'s bf16 step at
    t_max 448 stays under the 20 KB that lets 11 blocks share an H100 SM,
    and the 227 KB limit is reached only by caches far past Whisper's 448
    positions."""
    chunks, warps = (5 * 8192, 16) if latency else (4 * 4096, 4)
    assert (decode_attn.smem_bytes(448, 64, 2, latency)
            == chunks + 256 + 4 * (warps * 64 + 448))
    assert (decode_attn.smem_bytes(448, 128, 4, latency)
            == chunks + 1024 + 4 * (warps * 128 + 448))
    if not latency:
        assert decode_attn.smem_bytes(448, 64, 2, latency) + 1024 <= 228 * 1024 // 11
    assert decode_attn.smem_bytes(448, 128, 4, latency) <= decode_attn.SMEM_LIMIT
    assert decode_attn.smem_bytes(60000, 128, 4, latency) > decode_attn.SMEM_LIMIT


def test_decode_attn_latency_mode_rule():
    """At most two (row, head) blocks per SM take the latency mode: `small`'s
    greedy b8 step (96 blocks) on an H100's 132 SMs, not its beam-15 step
    (1,440)."""
    assert decode_attn.latency_mode(8 * 12, 132)
    assert decode_attn.latency_mode(264, 132) and not decode_attn.latency_mode(265, 132)
    assert not decode_attn.latency_mode(120 * 12, 132)
