"""Beam search through the self cache's row table (``ops.decode_attn.beam_rows``)
on the CPU: the plain decode-attention step read through a table is the step
over a cache gathered by that table, bit for bit; a beam decode that reorders
only the table gives the tokens, scores and finished buffer of one that moves
the cache every step; the int8kv cache, whose steps take the plain attention,
still moves its cache; and the counters say which reorder each beam step took."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from whisper_flamingo_tpu_torch import decoding, profiling
from whisper_flamingo_tpu_torch.decoding import DecodingOptions, DecodingTask
from whisper_flamingo_tpu_torch.models.dims import MODEL_DIMS
from whisper_flamingo_tpu_torch.models.whisper import ModelExtras, StepGraphs, init_params
from whisper_flamingo_tpu_torch.ops import decode_attn

DIMS = MODEL_DIMS["debug"]
BERT_DIM = 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the step ----------------------------------------------------------------------------


def _ancestry(gen, b, t_max, identity):
    """A table as the beam loop leaves it: each position's row drawn at
    random (a beam's history spread over the rows that wrote it)."""
    if identity:
        return torch.arange(b, dtype=torch.int32)[:, None].repeat(1, t_max)
    return torch.randint(0, b, (b, t_max), generator=gen, dtype=torch.int32)


def _lawful(table, off):
    """``table`` with every entry that names a position its row writes in
    the same step (per-row offsets only) sent to the row's own slab."""
    pos = torch.arange(table.shape[1])[None]
    own = torch.arange(table.shape[0], dtype=table.dtype)[:, None]
    return torch.where(off.long()[table.long()] == pos, own, table)


def _gathered(cache, table, off):
    """The cache moved to where the table points: position p < offset of
    row b from row table[b, p]; the rest of each row its own."""
    b, t_max, _ = cache.shape
    pos = torch.arange(t_max)[None]
    own = torch.arange(b)[:, None]
    return cache[torch.where(pos < off[:, None], table.long(), own), pos]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("identity", [False, True], ids=["ancestry", "identity"])
def test_plain_step_through_table_equals_gathered_cache(dtype, identity):
    gen = torch.Generator().manual_seed(7)
    b, t_max, d, n_head = 6, 20, 64, 2
    table = _ancestry(gen, b, t_max, identity)
    per_row = torch.randint(0, t_max, (b,), generator=gen, dtype=torch.int32)
    for off in (0, 1, 7, 12, t_max - 1, per_row):
        q, kn, vn = (torch.randn(b, 1, d, generator=gen).to(dtype) for _ in range(3))
        kc, vc = (torch.randn(b, t_max, d, generator=gen).to(dtype) for _ in range(2))
        offs = decode_attn._row_offsets(off, b, "cpu")
        table = _lawful(table, offs)
        kg, vg = _gathered(kc, table, offs), _gathered(vc, table, offs)
        with decode_attn.beam_rows(table):
            got = decode_attn.fused_step_plain(q, kn, vn, kc, vc, off, n_head)
            out, k_out, v_out = decode_attn.fused_step(q, kn, vn, kc, vc, off, n_head)
        ref = decode_attn.fused_step_plain(q, kn, vn, kg, vg, off, n_head)
        assert torch.equal(got, ref) and torch.equal(out, ref)
        assert k_out is kc and v_out is vc
        rows = torch.arange(b)
        # the new row lands in each row's own slab, at its offset
        assert torch.equal(kc[rows, offs], kg[rows, offs])
        assert torch.equal(vc[rows, offs], vg[rows, offs])


def test_table_is_checked():
    b, t_max, d = 2, 8, 64
    q = torch.zeros(b, 1, d)
    kc = torch.zeros(b, t_max, d)
    with pytest.raises(ValueError):  # not int32
        with decode_attn.beam_rows(torch.zeros(b, t_max, dtype=torch.long)):
            pass
    with pytest.raises(ValueError):  # not the cache's (B, T_max)
        with decode_attn.beam_rows(torch.zeros(b, t_max - 1, dtype=torch.int32)):
            decode_attn.fused_step(q, q, q, kc, kc.clone(), 0, 1)
    assert decode_attn._ROWS.get() is None  # the block's table is gone with it


# -- the beam loop -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    plain = init_params(torch.Generator().manual_seed(0), DIMS, device="cpu")
    gated = init_params(torch.Generator().manual_seed(1), DIMS,
                        ModelExtras(add_gated_x_attn=1, num_langs=1, bert_dim=BERT_DIM),
                        device="cpu")
    with torch.no_grad():  # open the gates: a zero gate would hide the streams
        for blk in gated.decoder.blocks:
            blk.ff_gate.fill_(0.5)
            for sub in blk.gated_x_attn_layers:
                sub.attn_gate.fill_(0.5)
    deep = init_params(torch.Generator().manual_seed(2), replace(DIMS, n_text_layer=12),
                       device="cpu")
    return {"plain": plain, "gated": gated, "deep": deep}


def _inputs(seed, n, gated):
    rng = np.random.default_rng(seed)
    mel = torch.from_numpy(rng.standard_normal((n, 80, 3000)).astype(np.float32) * 0.5)
    xt = None
    if gated:
        xt = torch.from_numpy(rng.standard_normal((1, n, 6, BERT_DIM)).astype(np.float32))
    return mel, xt


def _options(fp16=False, quantize=None, beam=15, sample_len=10):
    return DecodingOptions(language="en", without_timestamps=True, sample_len=sample_len,
                           fp16=fp16, beam_size=beam, quantize=quantize)


def _loop(task, mel, xt, monkeypatch, apply=None):
    """``_main_loop``'s outputs, the logits of every incremental forward and
    whether a table was set around it."""
    steps, tables = [], []
    inner = apply or decoding.decoder_apply

    def recording(params, dims, tokens, *args, **kwargs):
        incremental = kwargs.get("cache") is not None and tokens.shape[-1] == 1
        if incremental:
            tables.append(decode_attn._ROWS.get() is not None)
        out = inner(params, dims, tokens, *args, **kwargs)
        if incremental:
            steps.append(out[0].clone())
        return out

    feats = decoding._features(task.model, mel, task.compute_dtype)
    init = torch.tensor([task.initial_tokens] * mel.shape[0])
    with monkeypatch.context() as m:
        m.setattr(decoding, "decoder_apply", recording)
        with profiling.collect() as sink:
            out = task._main_loop(feats, init, xt)
    return out, steps, tables, sink


def _moved_each_step(apply):
    """The reference: before every forward the self cache is moved to where
    the loop's table points, the table set back to the identity, and the
    step read with no table, as a beam search that moves the cache does."""

    def moving(params, dims, tokens, *args, **kwargs):
        rows, cache, off = decode_attn._ROWS.get(), kwargs["cache"], kwargs["offset"]
        if rows is None or tokens.shape[-1] != 1:
            return apply(params, dims, tokens, *args, **kwargs)
        idx = rows[:, :off].long()
        for key in ("k", "v"):
            pre = cache[key][:, :, :off]
            pre.copy_(pre.gather(1, idx[None, :, :, None].expand_as(pre)))
        rows.copy_(torch.arange(rows.shape[0], dtype=rows.dtype)[:, None].expand_as(rows))
        with decode_attn.beam_rows(None):
            return apply(params, dims, tokens, *args, **kwargs)

    return moving


def _same(a, b):
    (out_a, steps_a), (out_b, steps_b) = a, b
    assert out_a.keys() == out_b.keys() >= {"tokens", "sum_logprobs", "fin_tokens",
                                            "fin_scores", "fin_count"}
    for k in out_a:
        assert torch.equal(out_a[k], out_b[k]), k
    assert len(steps_a) == len(steps_b) > 2
    for i, (x, y) in enumerate(zip(steps_a, steps_b)):
        assert torch.equal(x, y), f"step {i}"


@pytest.mark.parametrize("reference", ["moved_by_the_test", "copied_by_the_loop"])
@pytest.mark.parametrize("kind,fp16,segmented", [
    ("plain", False, False), ("gated", False, False), ("gated", True, False),
    ("gated", False, True),
], ids=["plain", "gated", "gated-bf16", "gated-segmented"])
def test_beam15_through_table_equals_moved_cache(models, monkeypatch, kind, fp16, segmented,
                                                 reference):
    mel, xt = _inputs(3, 2, kind == "gated")

    def task():
        t = DecodingTask(models[kind], _options(fp16))
        if segmented:  # the card's step: the segments, fused_step between them
            t.step_graphs = StepGraphs(capture=False)
        return t

    out, steps, tables, sink = _loop(task(), mel, xt, monkeypatch)
    assert all(tables) and sink.counters["decode.reorder_copied"] == 0
    assert sink.counters["decode.reorder_indirect"] == len(steps) + 1
    if reference == "moved_by_the_test":
        ref = _loop(task(), mel, xt, monkeypatch, _moved_each_step(decoding.decoder_apply))
    else:  # the loop's own reorder of the cache, as under int8kv
        with monkeypatch.context() as m:
            m.setattr(decoding, "self_step_kernel", lambda cache: False)
            ref = _loop(task(), mel, xt, monkeypatch)
        assert not any(ref[2]) and ref[3].counters["decode.reorder_copied"] == len(steps) + 1
    _same((out, steps), ref[:2])


def test_int8kv_beam_moves_its_cache(models, monkeypatch):
    """int8kv's steps take the plain quantized attention, which reads no
    table: the loop still moves the cache and its scales, and no table is
    set. Its tokens are held to the JAX package's in test_torch_quant."""
    mel, _ = _inputs(4, 2, False)
    opts = _options(quantize="int8kv", beam=5)
    out, steps, tables, sink = _loop(DecodingTask(models["plain"], opts), mel, None,
                                     monkeypatch)
    assert not any(tables) and "decode.reorder_indirect" not in sink.counters
    assert sink.counters["decode.reorder_copied"] == len(steps) + 1 > 2


def test_120_row_beam_step_reorders_the_table_once(models, monkeypatch):
    """8 clips x beam 15 over 12 decoder layers: one table reorder a beam
    step, and every layer's step reads through the table."""
    mel, _ = _inputs(5, 8, False)
    reads = []
    plain = decode_attn.fused_step_plain

    def reading(*a):
        reads.append(decode_attn._ROWS.get() is not None)
        return plain(*a)

    monkeypatch.setattr(decode_attn, "fused_step_plain", reading)
    out, steps, tables, sink = _loop(DecodingTask(models["deep"], _options(sample_len=5)),
                                     mel, None, monkeypatch)
    assert out["tokens"].shape[0] == 120
    n_steps = sum(1 for s in sink.spans if s.name == "decode.step")
    assert sink.counters["decode.reorder_indirect"] == n_steps == len(steps) + 1
    assert "decode.reorder_copied" not in sink.counters
    assert len(reads) == 12 * len(steps) and all(reads)
