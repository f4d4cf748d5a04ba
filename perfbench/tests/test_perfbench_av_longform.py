"""The audio-visual and long-form cells' generators on the CPU at small sizes:
a window, the replay and the check against the plain reference, in fp32 (the
compared numbers at rounding), in bf16 (inside the limits) and under the fp8
control (outside them), and the per-layer readers of a traced run."""

import copy

import pytest

from perfbench import spec
from perfbench.drivers import av_decode, longform
from perfbench.readings import Readings
from perfbench.trace import Recorder

from .conftest import DEBUG_DIMS

SEED = 2 ** 31 + 77


def _av_config(dtype):
    cfg = copy.deepcopy(spec.config("flamingo-large-av"))
    cfg["dims"] = dict(DEBUG_DIMS)
    cfg["trunk"] = {"embed_dim": 32, "n_layers": 2, "n_heads": 2, "ffn_dim": 64,
                    "conv_pos": 8, "conv_pos_groups": 2, "frontend_dim": 512}
    cfg["extras"]["bert_dim"] = 32  # != the decoder's 64: xt_projection runs
    cfg["video"] = dict(cfg["video"], height=32, width=32)
    cfg["dtype"] = dtype
    return cfg


def _av_traffic():
    traffic = dict(spec.traffic("lrs3-beam15"), clips=8, batch=4, clip_seconds=[0.4, 1.2])
    traffic["decoding"] = dict(traffic["decoding"], beam_size=3, sample_len=6)
    return traffic


def _lf_config(dtype):
    cfg = copy.deepcopy(spec.config("whisper-large-v2"))
    cfg["dims"] = dict(DEBUG_DIMS)
    cfg["dtype"] = dtype
    return cfg


def _lf_traffic():
    traffic = dict(spec.traffic("longform-words"), recording_seconds=50, alignment_heads="debug")
    traffic["decoding"] = dict(traffic["decoding"], sample_len=12)
    return traffic


def _run(driver, cfg, traffic, limits, traced=False, control=None, units=2):
    rec = Recorder(traced, "cpu")
    d = driver.Driver(cfg, traffic, SEED, rec, "cpu", control=control, units=units)
    d.setup()
    stats = d.run_window()
    d.release()
    checks = d.check(limits)
    return rec, stats, {name: (value, limit) for name, value, limit in checks}, d.numbers


def _passes(checks):
    return all(value <= limit for value, limit in checks.values())


@pytest.mark.parametrize("dtype,control", [("float32", None), ("bfloat16", None),
                                           ("float32", "fp8")])
def test_av_cell(dtype, control):
    limits = spec.limits("flamingo-large-av.lrs3-beam15")
    rec, stats, checks, numbers = _run(av_decode, _av_config(dtype), _av_traffic(), limits,
                                       control=control)
    assert stats["failed"] == 0 and stats["attempted"] == 8
    assert numbers["rows_checked"] == 8
    if control:
        assert not _passes(checks)
        assert numbers["logit_rel_err_rms"] > limits["logit_rel_err_rms"]
        assert numbers["trunk_rel_err"] > limits["trunk_rel_err"]
    elif dtype == "float32":
        assert numbers["logit_rel_err_rms"] < 1e-5 and numbers["trunk_rel_err"] < 1e-5
    else:
        assert _passes(checks), checks


def test_av_traced_readers():
    rec, stats, checks, _ = _run(av_decode, _av_config("float32"), _av_traffic(),
                                 spec.limits("flamingo-large-av.lrs3-beam15"), traced=True)
    assert stats["graph_captures"] == 0  # set-up saw every length
    frames, pad = stats["notes"]["av.frames"], stats["notes"]["av.pad_frames"]
    assert frames > 0 and pad > 0
    r = Readings(rec, stats)
    assert spec.reader("captures_per_batch.av")(r) == 0.0
    assert spec.reader("step_ms.av")(r) > 0
    assert spec.reader("mfu.av")(r) > 0
    # no device time on the CPU, and no flash64 call off the card
    assert spec.reader("encoder_ms.av")(r) is None
    assert spec.reader("flash64_fwd_roofline.av")(r) is None


@pytest.mark.parametrize("dtype,control", [("float32", None), ("bfloat16", None),
                                           ("float32", "fp8")])
def test_longform_cell(dtype, control):
    limits = spec.limits("whisper-large-v2.longform-words")
    rec, stats, checks, numbers = _run(longform, _lf_config(dtype), _lf_traffic(), limits,
                                       control=control, units=1)
    assert stats["failed"] == 0 and stats["attempted"] >= 2
    assert numbers["dtw_path_gap"] == 0.0  # the DP's optimum over the program's own matrix
    assert stats["e2e"]["audio_s_per_s"] == pytest.approx(
        _lf_traffic()["recording_seconds"] / stats["window_s"])  # the recording's own seconds
    if control:
        assert not _passes(checks)
        assert numbers["logit_rel_err_rms"] > limits["logit_rel_err_rms"]
        assert numbers["align_weight_err"] > limits["align_weight_err"]
    elif dtype == "float32":
        assert numbers["logit_rel_err_rms"] < 1e-5 and numbers["align_rel_err"] < 1e-4
        assert numbers["align_weight_err"] < 1e-5
        assert numbers["align_matrix_gap"] < 1e-5
    else:
        assert _passes(checks), checks


@pytest.mark.parametrize("fault", ["wrong_heads", "wrong_median"])
def test_longform_alignment_faults_fail(fault, monkeypatch):
    """Alignment read from other heads than the published ones, or a median
    filter of another width: the tokens are the same, the limits on the
    alignment fail."""
    from whisper_flamingo_tpu_torch import timing

    limits = spec.limits("whisper-large-v2.longform-words")
    name = {"wrong_heads": "align_weight_err", "wrong_median": "align_matrix_gap"}[fault]
    if fault == "wrong_median":
        orig = timing.median_filter
        monkeypatch.setattr(timing, "median_filter", lambda x, width: orig(x, width - 2))
    rec = Recorder(False, "cpu")
    d = longform.Driver(_lf_config("bfloat16"), _lf_traffic(), SEED, rec, "cpu", units=1)
    d.setup()
    if fault == "wrong_heads":
        d.model.alignment_heads = ~d.model.get_alignment_heads()
    d.run_window()
    d.release()
    checks = {n: (v, lim) for n, v, lim in d.check(limits)}
    assert checks["logit_rel_err_rms"][0] <= limits["logit_rel_err_rms"]
    assert checks[name][0] > limits[name], checks


def test_longform_traced_readers():
    rec, stats, _, _ = _run(longform, _lf_config("float32"), _lf_traffic(),
                            spec.limits("whisper-large-v2.longform-words"), traced=True, units=1)
    r = Readings(rec, stats)
    assert 0 < spec.reader("align_share.longform")(r) < 100
    assert spec.reader("step_ms.longform")(r) > 0
    assert spec.reader("decode_attn_roofline.longform")(r) is None  # no device time on the CPU
    assert rec.calls["dtw"] and all(c["m"] > 0 for c in rec.calls["dtw"])
    assert spec.reader("dtw_roofline.longform")(r) is None  # no device time on the CPU
