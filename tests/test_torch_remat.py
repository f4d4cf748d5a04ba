"""The port's rematerialization specs against the JAX package's, on the CPU
in fp32.

Every spec JAX's ``_remat_wrap`` takes without arguments (``"none"``,
``"full"``, ``"dots"`` and each argument-free ``jax.checkpoint_policies``
name) gives one CE step's loss and gradients equal (``torch.equal``) to
no remat, and within 1e-4 (of the largest magnitude for gradients, relative
for the loss) of JAX's same spec. An op count over the backward shows the
policy at work: under ``"dots"`` the 2-D products (``mm`` / ``addmm``) of a
block are saved and not run again, under ``"full"`` they are. Dims have
d_head 64, so the encoder runs flash64's plain forward and backward.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from whisper_flamingo_tpu.models import whisper as jw
from whisper_flamingo_tpu.training import steps as jsteps

from whisper_flamingo_tpu_torch.models import whisper as tw
from whisper_flamingo_tpu_torch.training import optim, steps

from test_torch_model import hide_stub_triton  # noqa: F401
from test_torch_training import DIMS, JDIMS, _batch, _close_by_key, _jbatch, _pair

JAX_NAMES = sorted(n for n in tw.REMAT_POLICIES if n != "dots")
SPECS = ["none", "full", "dots", *JAX_NAMES]
F32 = jnp.float32


@pytest.fixture(scope="module", autouse=True)
def one_thread():  # module-wide: the reference and every rerun sum in one order
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _loss_and_grads(model, batch, remat):
    b = steps.to_device(batch, model.device)
    feats = tw.encoder_apply(model, DIMS, b["input_ids"], remat=remat)
    logits, _ = tw.decoder_apply(model, DIMS, b["dec_input_ids"], feats, remat=remat)
    loss = steps.ce_loss(logits, b["labels"])
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return loss.detach(), grads


@pytest.fixture(scope="module")
def reference():
    jparams, model, extras = _pair()
    optim.whisper_optimizer(model, 1e-3)  # marks every parameter trainable
    return jparams, model, extras, _loss_and_grads(model, _batch(), False)


@pytest.mark.parametrize("remat", SPECS)
def test_remat_spec_gives_the_same_loss_and_gradients(reference, remat):
    jparams, model, extras, (loss0, grads0) = reference
    loss, grads = _loss_and_grads(model, _batch(), remat)
    assert torch.equal(loss, loss0)
    for n, g in grads.items():
        assert torch.equal(g, grads0[n]), n

    jb = _jbatch(_batch())

    def loss_fn(p):
        feats = jw.encoder_apply(p, JDIMS, jb["input_ids"], dtype=F32, remat=remat)
        logits, _ = jw.decoder_apply(p, JDIMS, jb["dec_input_ids"], feats, dtype=F32,
                                     remat=remat)
        return jsteps.ce_loss(logits, jb["labels"])

    jloss, jgrads = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, jparams))
    assert loss.item() == pytest.approx(float(jloss), rel=1e-4)
    _close_by_key(grads, jgrads, extras, 1e-4, "grad")


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(model, remat):
    b = steps.to_device(_batch(), model.device)
    feats = tw.encoder_apply(model, DIMS, b["input_ids"], remat=remat)
    logits, _ = tw.decoder_apply(model, DIMS, b["dec_input_ids"], feats, remat=remat)
    loss = steps.ce_loss(logits, b["labels"])
    with _OpCount() as ops:
        loss.backward()
    for p in model.parameters():
        p.grad = None
    aten = torch.ops.aten
    return {k: ops.counts.get(getattr(aten, k).default, 0) for k in ("mm", "addmm", "bmm")}


def test_dots_saves_the_projections_and_recomputes_the_rest(reference):
    """The backward runs no extra 2-D product under ``"dots"`` (the
    projections' outputs were saved), one per projection under ``"full"``;
    both rerun the batched attention products that ``"dots"`` does not
    save, and ``"dots_saveable"`` saves those too."""
    _, model, _, _ = reference
    none, full, dots, all_dots = (_backward_ops(model, r)
                                  for r in ("none", "full", "dots", "dots_saveable"))
    two_d = lambda c: c["mm"] + c["addmm"]  # noqa: E731
    assert two_d(dots) == two_d(none) < two_d(full)
    assert dots["bmm"] == full["bmm"] > none["bmm"]
    assert all_dots["bmm"] == none["bmm"] and two_d(all_dots) == two_d(none)


@pytest.mark.parametrize("spec", ["false", "save_only_these_names", "offload_dot_with_no_batch_dims",
                                  "dots_with_batch_dims", 3])
def test_unknown_remat_specs_raise(spec):
    with pytest.raises(ValueError, match="jax.checkpoint_policies"):
        tw._remat_wrap(lambda x: x, spec)
