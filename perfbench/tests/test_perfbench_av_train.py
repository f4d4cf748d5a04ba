"""The step-2 training cell and the data-parallel fine-tuning cell on the CPU
at the debug widths: their names resolve, their traffic is a function of
the seed with the same work for every seed, the step-2 FLOP count against a
count by hand, and a whole run of each, sound (correct), under the fp8
control and with the program broken underneath (not correct). The step-2
cell runs a smaller pool of shorter clips at 32 x 32 (the published front
end over 16 x 400 crops of 88 x 88 a batch would take minutes here); the
data-parallel cell its own traffic, on 4 gloo ranks."""

import copy

import numpy as np
import pytest

from perfbench import av_flops, av_train_flops, spec
from perfbench import flops as F
from perfbench.drivers import av_train, finetune, finetune_dp
from perfbench.faults import update_negated, update_skipped
from perfbench.run import run_cell
from perfbench.trace import Recorder

from .conftest import DEBUG_DIMS, small_config

SEED = 3_000_000_041
AV = "flamingo-large-av-step2.lrs3-train-b16"
DP = "whisper-large-v2.finetune-dp4"
BENCH = spec.benchmark()


def _av_config():
    cfg = copy.deepcopy(spec.config("flamingo-large-av-step2"))
    cfg["dims"] = dict(DEBUG_DIMS)
    cfg["trunk"] = {"embed_dim": 32, "n_layers": 2, "n_heads": 2, "ffn_dim": 64,
                    "conv_pos": 8, "conv_pos_groups": 2, "frontend_dim": 512}
    cfg["extras"]["bert_dim"] = 32  # != the decoder's 64: xt_projection runs
    cfg["video"] = dict(cfg["video"], height=32, width=32)
    return cfg


def _av_traffic():
    return dict(spec.traffic("lrs3-train-b16"), batch=4, pool=2, clip_seconds=[0.4, 1.2],
                target_tokens=[8, 24])


@pytest.mark.parametrize("cell,chips", [(AV, 1), (DP, 4)])
def test_new_cells_resolve(cell, chips):
    w = spec.workload(BENCH, cell)
    assert w["chips"] == chips
    cfg = spec.config(w["config"])
    assert all(k in cfg for k in next(c["reduced"] for c in BENCH["configs"]
                                      if c["name"] == w["config"]))
    assert hasattr(spec.driver(spec.traffic(w["traffic"])["driver"]), "Driver")
    assert set(spec.limits(cell)) >= {"loss_gap", "grad_norm_gap", "change_norm_gap",
                                      "change_gap"}
    assert [m["name"] for m in spec.end_to_end(BENCH, cell)] == ["train_step_ms", "setup_s"]
    suffix = "avtrain" if cell == AV else "dp4"
    layer = [m["name"] for m in spec.per_layer(BENCH, cell)]
    assert layer and all(n.endswith("." + suffix) for n in layer)
    assert all(callable(spec.reader(n)) for n in layer)


def test_step2_traffic_is_the_seeds():
    cfg, traffic = _av_config(), spec.traffic("lrs3-train-b16")
    a, b, c = (av_train.Driver(cfg, traffic, s, Recorder(False), "cpu") for s in (5, 5, 6))
    ia, ib, ic = (d._items(np.random.default_rng(d.seed)) for d in (a, b, c))
    assert len(ia) == 96
    assert all(np.array_equal(x["wav"], y["wav"]) and np.array_equal(x["video"], y["video"])
               and x["labels"] == y["labels"] for x, y in zip(ia[:4], ib[:4]))
    assert sorted(len(x["wav"]) for x in ia) == sorted(len(x["wav"]) for x in ic)
    assert sorted(len(x["video"]) for x in ia) == sorted(len(x["video"]) for x in ic)
    assert [len(x["wav"]) for x in ia] != [len(x["wav"]) for x in ic]
    assert min(len(x["video"]) for x in ia) == 50 and max(len(x["video"]) for x in ia) == 375
    lengths = sorted(len(x["dec_input_ids"]) for x in ia)
    assert lengths[0] == 16 and lengths[-1] == 128


def test_step2_draws_cover_every_modality():
    tr = spec.config("flamingo-large-av-step2")["train"]
    for seed in (1, 2 ** 31 + 5, 3_000_000_041):
        s, modes = av_train.draw_seed(seed, tr)
        assert sorted(modes) == ["audio", "both", "video"]
        assert s == av_train.draw_seed(seed, tr)[0]


def test_dp_ranks_draw_their_own_batches_of_the_same_work():
    cfg, traffic = small_config("whisper-large-v2"), spec.traffic("finetune-dp4")
    items = [finetune.Driver(cfg, traffic, finetune_dp.rank_seed(7, r), Recorder(False), "cpu")
             for r in range(4)]
    got = [d._items(np.random.default_rng(d.seed)) for d in items]
    assert len({tuple(len(x["wav"]) for x in g) for g in got}) == 4  # each rank its order
    assert len({tuple(sorted(len(x["wav"]) for x in g)) for g in got}) == 1  # the same work
    again = finetune.Driver(cfg, traffic, finetune_dp.rank_seed(7, 2), Recorder(False), "cpu")
    assert [x["labels"] for x in again._items(np.random.default_rng(again.seed))] == [
        x["labels"] for x in got[2]]


def test_step2_flops_by_hand():
    cfg = _av_config()
    d, v, layers = 64, 51865, 2
    t, frames, s = 24, 200, 50  # tokens, mel frames, video frames
    ta = 100
    lin = 2 * t * d * d
    gated = (lin * 2 * 3 + 2 * s * d * d * 2 * 2 + 2 * t * s * d * 2 * 3
             + 2 * t * d * 4 * d * 2 * 3)
    frozen = (lin * 4 * 2 + 2 * t * t * d * 2 * 3 + lin * 2 * 2 + 2 * ta * d * d * 2
              + 2 * t * ta * d * 2 * 2 + 2 * t * d * 4 * d * 2 * 2)
    decoder = layers * (gated + frozen) - lin + 2 * t * d * v * 2
    row = (av_flops.trunk_flops(cfg["trunk"], s, 32, 32) + F.encoder_flops(cfg["dims"], frames)
           + 2 * s * 32 * d + decoder)
    assert av_train_flops.step_flops(cfg, 3, frames, t, s) == pytest.approx(3 * row, rel=1e-12)


def _run_av(monkeypatch, control=None):
    orig, small = spec.traffic, _av_traffic()
    monkeypatch.setattr(spec, "traffic",
                        lambda name: small if name == "lrs3-train-b16" else orig(name))
    return run_cell(AV, SEED, 0, False, device="cpu", config=_av_config(), control=control,
                    units=2)


def _run_dp(control=None):
    return run_cell(DP, SEED, 0, False, device="cpu", config=small_config("whisper-large-v2"),
                    control=control, units=1)


def test_step2_sound_run_is_correct(monkeypatch):
    out = _run_av(monkeypatch)
    assert out["correct"], out["checks"]
    assert sorted(out["_notes"]["modes"]) == ["audio", "both", "video"]


def test_step2_control_is_not_correct(monkeypatch):
    assert not _run_av(monkeypatch, "fp8")["correct"]


def test_step2_fault_is_not_correct(monkeypatch):
    with update_negated():
        assert not _run_av(monkeypatch)["correct"]


def test_dp_sound_run_is_correct():
    out = _run_dp()
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4 and out["attempted"] == 1


def test_dp_control_is_not_correct():
    assert not _run_dp("fp8")["correct"]


def test_dp_fault_is_not_correct():
    with update_skipped():  # planted in this process: rank 0's update, which is checked
        assert not _run_dp()["correct"]
