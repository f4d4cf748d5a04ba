"""The two probe kernels' plain versions against the JAX probes, on the CPU.

- ``ops/flash64_variants.py``: ``flash64_fwd_augv_plain`` and
  ``flash64_fwd_csbound_plain`` against ``tools/flash64_fwd_probe.py``'s
  ``make_variant("augv")`` and ``make_variant("csbound+augv")``, the Pallas
  kernel run in interpret mode (the test patches ``pl.pallas_call`` with
  ``interpret=True``; nothing of the JAX tree changes), at T = 600 and
  T = 1500 (the probe pads T to 1024 / 1536 and masks the keys past T).
  Tolerances: fp32 1e-5 (the fp32 sums run in another order); bf16 one
  ulp at the output's scale, 2^-7 * max|ref| (the scores differ in their
  last fp32 bits, which can flip the bf16 rounding of a probability).
- ``ops/mma_pair.py``: ``pair_chain_plain`` against
  ``tools/packed_probe2.py``'s ``make_kernel(d, 1536, iters)`` in interpret
  mode, d 64 and 128, iters 1-3, at the same 2^-7 * max|ref| (each product
  sums in fp32 in another order before its bf16 rounding).
- The decay of the pair probe's operands, the steady operands that do not
  decay, the pair kernel's launch plan (``mma_pair.plan``) at the probe's
  four points and what it refuses, the wrapper's refusals (raised before
  anything is built), the wrappers' device rule and the two command-line
  probes with ``--device cpu``.
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from whisper_flamingo_tpu_torch.ops import flash64, flash64_variants, mma_pair
from whisper_flamingo_tpu_torch.tools import flash64_fwd_probe, packed_probe2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_REL = 2.0 ** -7


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(ROOT, "tools",
                                                                            f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jfwd():
    return _jax_tool("flash64_fwd_probe")


@pytest.fixture(scope="module")
def jpair():
    return _jax_tool("packed_probe2")


@pytest.fixture
def interpret(monkeypatch):
    """Run every ``pl.pallas_call`` of the JAX probes in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(t, seed, bh=2):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((bh, t, 64), dtype=np.float32) * 0.3 for _ in range(2))
    return q, k, rng.standard_normal((bh, t, 64), dtype=np.float32)


PLAIN = {"augv": flash64_variants.flash64_fwd_augv_plain,
         "csbound+augv": flash64_variants.flash64_fwd_csbound_plain}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [600, 1500])
@pytest.mark.parametrize("name", ["augv", "csbound+augv"])
def test_variant_plain_matches_jax_probe(jfwd, interpret, name, t, dtype):
    q, k, v = _qkv(t, seed=t)
    ref = jfwd.make_variant(name)(*(jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)))
    ref = np.asarray(ref.astype(jnp.float32))
    got = PLAIN[name](*(torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, t, 64)
    tol = 1e-5 if dtype == "float32" else BF16_REL * np.abs(ref).max()
    assert np.abs(got.float().numpy() - ref).max() <= tol


def test_csbound_underflow_matches_jax(jfwd, interpret):
    """A row whose scores all lie far below its Cauchy-Schwarz bound (q
    orthogonal to a long key) underflows to l = 0 in both packages: the same
    non-finite row, not guarded."""
    q, k, v = _qkv(600, seed=1)
    q[0, 5] = 0.0
    q[0, 5, 0] = 100.0  # |q| = 100
    k[0, :, 0] = 0.0
    k[0, 7, 1] = 10.0  # kmax = 10: bound 1000, every score 0
    ref = np.asarray(jfwd.make_variant("csbound+augv")(*(jnp.asarray(x) for x in (q, k, v))))
    got = flash64_variants.flash64_fwd_csbound_plain(*(torch.from_numpy(x) for x in (q, k, v)))
    got = got.numpy()
    assert not np.isfinite(ref[0, 5]).any() and not np.isfinite(got[0, 5]).any()
    rows = np.ones(600, bool)
    rows[5] = False
    np.testing.assert_allclose(got[0, rows], ref[0, rows], atol=1e-5)
    np.testing.assert_allclose(got[1], ref[1], atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_key_norm_max(dtype):
    """The fused reduction (fp32 inside, no fp32 copy of K) against float64,
    on fp32 keys and on the bf16 keys the kernel reads."""
    k = torch.from_numpy(_qkv(50, seed=2)[1]).to(dtype)
    want = torch.linalg.vector_norm(k.double(), dim=-1).amax(dim=-1)
    got = flash64_variants.key_norm_max(k)
    assert got.dtype == torch.float32 and got.shape == (2,)
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=0)


def _pair_operands(d, seed, rows=512, n=1536):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, n), dtype=np.float32),
            rng.standard_normal((n, d), dtype=np.float32) * 0.1,
            rng.standard_normal((d, n), dtype=np.float32) * 0.1)


@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("d", [64, 128])
def test_pair_chain_plain_matches_jax_probe(jpair, interpret, d, iters):
    w, v, u = _pair_operands(d, seed=d)
    ref = jpair.make_kernel(d, 1536, iters)(*(jnp.asarray(x, jnp.bfloat16) for x in (w, v, u)))
    ref = np.asarray(ref.astype(jnp.float32))
    got = mma_pair.pair_chain_plain(*(torch.from_numpy(x).bfloat16() for x in (w, v, u)), iters)
    assert got.dtype == torch.bfloat16 and got.shape == (512, 1536)
    assert np.abs(ref).max() > 0
    assert np.abs(got.float().numpy() - ref).max() <= BF16_REL * np.abs(ref).max()


def test_pair_operands_decay_to_zero(jpair, interpret):
    """At the probe's scales w shrinks ~10^3-fold per iteration: after N
    iterations it is all zero, in the port's plain version and in the JAX
    probe alike, and a long run computes on zeros."""
    w, v, u = (torch.from_numpy(x).bfloat16() for x in _pair_operands(64, seed=0))
    n = mma_pair.first_zero_iteration(w, v, u, 64)
    assert n is not None and 8 <= n <= 20
    assert mma_pair.pair_chain_plain(w, v, u, n - 1).any()
    assert not mma_pair.pair_chain_plain(w, v, u, n).any()
    args = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (w, v, u)]
    assert not np.asarray(jpair.make_kernel(64, 1536, n)(*args).astype(jnp.float32)).any()
    assert np.asarray(jpair.make_kernel(64, 1536, n - 1)(*args).astype(jnp.float32)).any()


def test_probe_wrappers_device_rule():
    """CPU tensors take the plain versions and count no launch (a tensor on
    a device without a kernel raises: ``tests/test_torch_hygiene.py``)."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(70, seed=3))
    counts = (flash64_variants.flash64_fwd_augv.launches,
              flash64_variants.flash64_fwd_csbound.launches, mma_pair.pair_chain.launches)
    assert torch.equal(flash64_variants.flash64_fwd_augv(q, k, v),
                       flash64_variants.flash64_fwd_augv_plain(q, k, v))
    assert torch.equal(flash64_variants.flash64_fwd_csbound(q, k, v),
                       flash64_variants.flash64_fwd_csbound_plain(q, k, v))
    w, pv, pu = (torch.from_numpy(x).bfloat16() for x in _pair_operands(64, 4, rows=16, n=128))
    assert torch.equal(mma_pair.pair_chain(w, pv, pu, 2), mma_pair.pair_chain_plain(w, pv, pu, 2))
    assert counts == (flash64_variants.flash64_fwd_augv.launches,
                      flash64_variants.flash64_fwd_csbound.launches,
                      mma_pair.pair_chain.launches)


def test_csbound_takes_a_precomputed_kmax():
    """Given kmax (as the kernel is timed alone), csbound is the function it
    is without it."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(70, seed=6))
    kmax = flash64_variants.key_norm_max(k)
    assert torch.equal(flash64_variants.flash64_fwd_csbound(q, k, v, kmax),
                       flash64_variants.flash64_fwd_csbound(q, k, v))


def test_augv_and_shipped_agree():
    """augv sums the rounded probabilities, shipped the fp32 ones: in fp32
    they are one function."""
    q, k, v = (torch.from_numpy(x)[None] for x in _qkv(200, seed=5))
    ref = flash64.flash64_forward_plain(q, k, v)
    for fn in (flash64_variants.flash64_fwd_augv_plain, flash64_variants.flash64_fwd_csbound_plain):
        assert (fn(q, k, v) - ref).abs().max().item() <= 1e-5


def test_flash64_fwd_probe_cli_on_cpu(capsys):
    assert flash64_fwd_probe.main(["--device", "cpu", "--iters", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu") and "(1, 2, 300, 64)" in lines[0]
    names = [ln.split(":")[0].strip() for ln in lines[1:]]
    assert names == ["shipped", "augv", "csbound+augv"]
    deltas = [float(ln.split("=")[-1]) for ln in lines[1:]]
    assert deltas[0] == 0.0 and max(deltas) < 1e-2


def test_packed_probe2_cli_on_cpu(capsys):
    assert packed_probe2.main(["--device", "cpu", "--iters", "4"]) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0] == "device: cpu (plain version, host clock)  rows: 128"
    assert [ln[:28].strip() for ln in lines[1:5]] == [p[0] for p in packed_probe2.POINTS]
    assert [int(ln.split("iters=")[1].split(":")[0]) for ln in lines[1:5]] == [4, 2, 1, 1]
    assert "d=64 rate / d=128 rate:" in out and "packed useful / d=64 raw:" in out
    assert "w is all zero after" in lines[-1]


FILL_ROWS = 2 * 132 * 128  # phase 16's row count that fills the card


@pytest.mark.parametrize("rows", [512, FILL_ROWS])
@pytest.mark.parametrize("point", [p[0] for p in packed_probe2.POINTS])
def test_pair_plan_fits_each_probe_point(point, rows):
    """Each of the probe's four points has a launch at 512 and 33,792 rows:
    one the kernel is built for, whose CTA fits 227 KB of shared memory,
    whose clusters split n into slices of whole 32-column halves, and which
    fills the card once the rows do (as many warpgroups a CTA as fit) or,
    below that, spreads the rows over clusters of at least 8 CTAs, one CTA
    an SM at most."""
    _, d, n, _, _ = next(p for p in packed_probe2.POINTS if p[0] == point)
    p = mma_pair.plan(rows, n, d)
    assert (p.cluster, p.rows_per_cta) in mma_pair.LAUNCHES[d]
    assert p.smem == mma_pair.smem_bytes(n, d, p.cluster, p.rows_per_cta) <= 227 * 1024
    assert n % p.cluster == 0 and (n // p.cluster) % 32 == 0
    assert p.ctas == -(-rows // p.rows_per_cta) * p.cluster
    if rows == FILL_ROWS:
        assert p.ctas >= mma_pair.SMS and p.rows_per_cta == {64: 256, 128: 128, 256: 64}[d]
    else:
        assert p.ctas <= mma_pair.SMS and p.cluster >= 8


@pytest.mark.parametrize("rows,n,d", [
    (32, 1536, 64),     # rows not a multiple of 64
    (0, 1536, 64),      # no rows
    (512, 1536, 96),    # d 96
    (512, 96, 64),      # no cluster leaves whole 32-column halves
    (512, 768, 256),    # d 256 takes clusters of 16 only: 48 columns a CTA
    (512, 3072, 256),   # d 256's slices of the packed n fit no CTA
    (512, 6144, 128),   # u and v at d 128 fit no cluster of 16
    (512, 16384, 64),   # nor at d 64
])
def test_pair_plan_refuses_what_the_kernel_cannot_take(rows, n, d):
    with pytest.raises(ValueError):
        mma_pair.plan(rows, n, d)


def test_pair_chain_refusals_raise_before_any_build(monkeypatch):
    """The operand checks run before the kernel library is built or loaded:
    each refusal raises its own error and nothing reaches ``cuda_build``."""
    from whisper_flamingo_tpu_torch.ops import cuda_build

    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(cuda_build, "load", no_build)
    w, v, u = (torch.from_numpy(x).bfloat16() for x in _pair_operands(64, 7, rows=128, n=256))
    p = mma_pair.check_operands(w, v, u, 1)
    assert p == mma_pair.plan(128, 256, 64)
    with pytest.raises(ValueError, match="do not chain"):
        mma_pair.check_operands(w, v[:128].contiguous(), u, 1)
    with pytest.raises(TypeError):
        mma_pair.check_operands(w.float(), v.float(), u.float(), 1)
    with pytest.raises(ValueError, match="contiguous"):
        mma_pair.check_operands(w.t().contiguous().t(), v, u, 1)
    with pytest.raises(ValueError, match="aligned"):
        mma_pair.check_operands(torch.cat([w.flatten(), w.flatten()[:1]])[1:].view(128, 256),
                                v, u, 1)
    with pytest.raises(ValueError, match="iters"):
        mma_pair.check_operands(w, v, u, 0)
    with pytest.raises(ValueError, match="rows"):
        mma_pair.check_operands(w[:32], v, u, 1)
    with pytest.raises(ValueError, match="d in"):
        mma_pair.check_operands(w, v.repeat(1, 2)[:, :96].contiguous(),
                                u.repeat(2, 1)[:96].contiguous(), 1)
    with pytest.raises(ValueError, match="no launch"):
        mma_pair.check_operands(w[:, :96].contiguous(), v[:96].contiguous(),
                                u[:, :96].contiguous(), 1)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_steady_operands_do_not_decay(d):
    """The steady operands keep the plain loop's output non-zero and within
    10x of its starting scale at every one of 32 iterations (128 rows, n
    256), where the probe's own operands are zero after about a dozen."""
    w, v, u = packed_probe2.make_operands(128, 256, d, "cpu", seed=3, steady=True)
    start = w.float().abs().max().item()
    for _ in range(32):
        w = mma_pair.pair_chain_plain(w, v, u, 1)
        scale = w.float().abs().max().item()
        assert torch.isfinite(w.float()).all() and start / 10 <= scale <= 10 * start
