"""Ranges around the port's public entry points, in traced runs only.

The benchmark may not edit the program, so in a ``--trace 1`` run it
replaces, for the run, the module attributes through which the program
calls its kernels and layers with wrappers that open a harness range and
note the call's shapes: ``ops.flash64.flash64_forward`` and
``flash64_backward`` (looked up at call time by ``Flash64Function`` and
``flash64_attention``), ``ops.decode_attn.fused_step`` (looked up by the
cached decoder) and the ``encoder_apply`` / ``decoder_apply`` names of
``decoding`` and ``serving``, and ``WhisperOptimizer.step``. The wrappers add no device work: a per-row
offset tensor is cloned once per decoder call, outside the kernel's range.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch

from .trace import Recorder


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


@contextlib.contextmanager
def instrument(rec: Recorder):
    if not rec.traced:
        yield
        return
    from whisper_flamingo_tpu_torch import decoding, serving
    from whisper_flamingo_tpu_torch.ops import decode_attn, flash64
    from whisper_flamingo_tpu_torch.training.optim import WhisperOptimizer

    saved = []

    def patch(mod, name, wrapper_of):
        orig = getattr(mod, name)
        saved.append((mod, name, orig))
        # the wrapper carries the function's attributes (its launch counters)
        setattr(mod, name, functools.wraps(orig)(wrapper_of(orig)))

    def fwd(orig):
        def wrapped(qh, kh, vh, *, with_lse=False):
            b, h, t, _ = qh.shape
            rec.calls["flash64_fwd"].append(
                {"bh": b * h, "t": t, "dtype": _dtype_name(qh), "with_lse": with_lse})
            with rec.range("flash64_fwd"):
                return orig(qh, kh, vh, with_lse=with_lse)
        return wrapped

    def bwd(orig):
        def wrapped(qh, kh, vh, o, lse, do):
            b, h, t, _ = qh.shape
            rec.calls["flash64_bwd"].append({"bh": b * h, "t": t, "dtype": _dtype_name(qh)})
            with rec.range("flash64_bwd"):
                return orig(qh, kh, vh, o, lse, do)
        return wrapped

    state = {"offsets": None}

    def step(orig):
        def wrapped(q, k_raw, v_raw, k_cache, v_cache, offset, n_head):
            off = offset if isinstance(offset, int) else state["offsets"]
            rec.calls["decode_attn"].append(
                {"rows": q.shape[0], "d": q.shape[-1], "offsets": off, "dtype": _dtype_name(q)})
            with rec.range("decode_attn"):
                return orig(q, k_raw, v_raw, k_cache, v_cache, offset, n_head)
        return wrapped

    def encoder(orig):
        def wrapped(*args, **kwargs):
            with rec.range("encoder"):
                return orig(*args, **kwargs)
        return wrapped

    last = {"t": None}

    def decoder(label):
        def wrap(orig):
            def wrapped(params, dims, tokens, *args, **kwargs):
                cache = kwargs.get("cache")
                incremental = cache is not None and tokens.shape[-1] == 1
                offset = kwargs.get("offset", 0)
                if incremental and isinstance(offset, torch.Tensor):
                    state["offsets"] = offset.detach().clone()
                now = time.perf_counter()
                if incremental:
                    if last["t"] is not None:
                        rec.host_ms[f"step.{label}"].append((now - last["t"]) * 1e3)
                    last["t"] = now
                else:
                    last["t"] = None  # a prefill or a new batch ends a run of steps
                with rec.range("decoder_step" if incremental else "decoder_prefill"):
                    return orig(params, dims, tokens, *args, **kwargs)
            return wrapped
        return wrap

    def optimizer(orig):
        def wrapped(self):
            with rec.range("optimizer"):
                return orig(self)
        return wrapped

    patch(flash64, "flash64_forward", fwd)
    patch(WhisperOptimizer, "step", optimizer)
    patch(flash64, "flash64_backward", bwd)
    patch(decode_attn, "fused_step", step)
    patch(decoding, "encoder_apply", encoder)
    patch(decoding, "decoder_apply", decoder("decode"))
    patch(serving, "decoder_apply", decoder("serve"))
    try:
        yield
    finally:
        for mod, name, orig in reversed(saved):
            setattr(mod, name, orig)
