"""The flash64 training path on the CPU: the plain lse and the plain
backward against the JAX package's Pallas kernels in interpret mode, and
autograd through ``Flash64Function`` against autograd of the plain forward.

fp32 throughout; tolerance 1e-5 (values of order 1, sums in another order
and, on the JAX side, the "mxu" ones-column row sum of the rounded
probabilities, which fp32 leaves equal to the fp32 row sum up to order).
At T = 600 the JAX kernel pads to 1024 and runs two 512-row q tiles, so its
dK/dV accumulation across q tiles and its padding are both exercised.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_flamingo_tpu.ops import flash64 as jflash

from whisper_flamingo_tpu_torch.ops import flash64

TOL = 1e-5


def _inputs(t, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((1, 2, t, 64)).astype(np.float32) * 0.5 for _ in range(4))
    return q, k, v, g


@pytest.mark.parametrize("t", [50, 600])
def test_plain_lse_matches_jax_interpret(t):
    q, k, v, _ = _inputs(t, t)
    o_ref, res = jflash._flash64_forward(
        *(jnp.asarray(a.reshape(2, t, 64)) for a in (q, k, v)), True, with_lse=True
    )
    lse_ref = np.asarray(res[3])[:, 0, :t].reshape(1, 2, t)
    o, lse = flash64.flash64_forward_plain(*(torch.from_numpy(a) for a in (q, k, v)), with_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref).reshape(1, 2, t, 64), atol=TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("t", [50, 600])
def test_plain_backward_matches_jax_interpret(t):
    q, k, v, g = _inputs(t, t + 1)
    fwd = lambda q_, k_, v_: jflash.flash64_attention(q_, k_, v_, interpret=True)  # noqa: E731
    _, vjp = jax.vjp(fwd, *(jnp.asarray(a) for a in (q, k, v)))
    ref = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    o, lse = flash64.flash64_forward_plain(tq, tk, tv, with_lse=True)
    got = flash64.flash64_backward_plain(tq, tk, tv, o, lse, tg)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), r, atol=TOL, rtol=0, err_msg=name)


def test_autograd_function_matches_autograd_of_plain_forward():
    """Gradients through Flash64Function (plain lse forward + plain
    backward on the CPU) equal PyTorch's autograd through the plain forward,
    with q/k/v as the head-split views the encoder hands over."""
    rng = np.random.default_rng(7)
    x = [torch.from_numpy(rng.standard_normal((2, 130, 128)).astype(np.float32) * 0.5)
         for _ in range(3)]
    w = torch.from_numpy(rng.standard_normal((2, 130, 128)).astype(np.float32))

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in x]
        views = [a.view(2, 130, 2, 64).transpose(1, 2) for a in leaves]
        out = fn(*views)
        (out.transpose(1, 2).reshape(2, 130, 128) * w).sum().backward()
        return out.detach(), [a.grad for a in leaves]

    out, got = grads(flash64.flash64_attention)
    assert out.grad_fn is None
    ref_out, ref = grads(flash64.flash64_attention_plain)
    torch.testing.assert_close(out, ref_out, atol=TOL, rtol=0)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=TOL, rtol=0)


def test_attention_takes_the_function_only_with_grad():
    """Inference (no input requiring grad, or grad disabled) runs the
    forward without lse and builds no graph."""
    q = torch.randn(1, 2, 20, 64)
    assert flash64.flash64_attention(q, q, q).grad_fn is None
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert flash64.flash64_attention(qg, q, q).grad_fn is None
    assert flash64.flash64_attention(qg, q, q).grad_fn is not None
