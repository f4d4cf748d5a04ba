"""Faults planted under the program, for the checks that ``correct`` has to
fail: the benchmark's CPU tests run each cell with them at the debug
widths, and ``perfbench.calibrate --fault`` reads them on the chip at the
cell's own size. Each is a context manager that patches one public
attribute of the port for its duration; no benchmark run uses them."""

import contextlib
from unittest import mock

import torch


@contextlib.contextmanager
def cache_left_unchanged():
    """The decode step's self-attention reads and returns its caches but
    never writes the new token's K/V into them."""
    from whisper_flamingo_tpu_torch.ops import decode_attn

    orig = decode_attn.fused_step

    def broken(q, k_raw, v_raw, k_cache, v_cache, offset, n_head):
        out = orig(q, k_raw, v_raw, k_cache.clone(), v_cache.clone(), offset, n_head)[0]
        return out, k_cache, v_cache

    with mock.patch.object(decode_attn, "fused_step", broken):
        yield


@contextlib.contextmanager
def beam_token_altered():
    """The decode loop's first sampled token of every row, altered."""
    from whisper_flamingo_tpu_torch.decoding import DecodingTask

    orig = DecodingTask._main_loop

    def broken(self, *args):
        out = orig(self, *args)
        out["tokens"][:, self.sample_begin] = (out["tokens"][:, self.sample_begin] + 1) % 50000
        return out

    with mock.patch.object(DecodingTask, "_main_loop", broken):
        yield


@contextlib.contextmanager
def served_token_altered():
    """Each greedy step of the batcher writes a token one past its choice."""
    from whisper_flamingo_tpu_torch.serving import ContinuousBatcher

    orig = ContinuousBatcher._step

    def broken(self, s):
        before = s["lens"].clone()
        orig(self, s)
        moved = s["lens"] > before
        pos = before[:, None]
        tok = s["tokens"].gather(1, pos)
        s["tokens"].scatter_(1, pos, torch.where(moved[:, None], (tok + 1) % 50000, tok))

    with mock.patch.object(ContinuousBatcher, "_step", broken):
        yield


@contextlib.contextmanager
def update_skipped():
    """The optimizer step returns the state unchanged."""
    from whisper_flamingo_tpu_torch.training.optim import WhisperOptimizer

    with mock.patch.object(WhisperOptimizer, "_update", lambda self, grads: None):
        yield


@contextlib.contextmanager
def update_negated():
    """The optimizer step applies its update with the sign flipped."""
    from whisper_flamingo_tpu_torch.training.optim import WhisperOptimizer

    orig = WhisperOptimizer._update

    def broken(self, grads):
        before = [p.detach().clone() for p in self.params]
        orig(self, grads)
        with torch.no_grad():
            torch._foreach_mul_(self.params, -1.0)
            torch._foreach_add_(self.params, before, alpha=2.0)

    with mock.patch.object(WhisperOptimizer, "_update", broken):
        yield


@contextlib.contextmanager
def half_batch():
    """The loss is the mean over the first half of the batch's rows."""
    from whisper_flamingo_tpu_torch.training import steps

    orig = steps.ce_loss

    def broken(logits, labels, *args):
        h = logits.shape[0] // 2
        return orig(logits[:h], labels[:h], *args)

    with mock.patch.object(steps, "ce_loss", broken):
        yield


FAULTS = {f.__name__: f for f in (cache_left_unchanged, beam_token_altered,
                                  served_token_altered, update_skipped, update_negated,
                                  half_batch)}
