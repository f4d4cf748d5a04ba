"""The traffic is a function of the seed, and every seed gets the same work."""

import numpy as np
import torch

from perfbench import spec
from perfbench.drivers import finetune, offline_decode, serve
from perfbench.trace import Recorder

from .conftest import small_config


def _driver(mod, cell, seed, **kw):
    w = spec.workload(spec.benchmark(), cell)
    return mod.Driver(small_config(w["config"]), spec.traffic(w["traffic"]), seed,
                      Recorder(False), "cpu", **kw)


def test_serve_schedule():
    cell = "whisper-large-v2.serve-poisson"
    a, b, c = (_driver(serve, cell, s, seconds=10) for s in (7, 7, 2 ** 31 + 9))
    (da, sa, ba, wa), (db, sb, bb, wb), (dc, sc, bc, wc) = (
        d.schedule(6.0, 10) for d in (a, b, c))
    assert np.array_equal(da, db) and np.array_equal(ba, bb)
    assert all(np.array_equal(x, y) for x, y in zip(wa, wb))
    assert len(da) == 60 and not np.array_equal(ba, bc)
    assert sorted(ba) == sorted(bc) and sorted(sa) == sorted(sc)
    assert abs(da[-1] - dc[-1]) < 10 / 6  # the same gaps in another order, less one
    assert 4 <= ba.min() and ba.max() <= 224 and 30 <= np.median(ba) <= 34


def test_offline_pool():
    cell = "flamingo-small-text.beam15"
    a, b, c = (_driver(offline_decode, cell, s) for s in (5, 5, 6))
    pa, pb, pc = a._inputs(), b._inputs(), c._inputs()
    assert all(torch.equal(x["audio"], y["audio"]) and x["texts"] == y["texts"]
               for x, y in zip(pa, pb))
    lengths = [sorted(len(t) for t in x["texts"][0]) for x in pa]
    assert lengths == [sorted(len(t) for t in x["texts"][0]) for x in pc]
    assert max(lengths[0]) == 126 and min(lengths[0]) == 30  # 128 and 32 tokens


def test_finetune_items():
    cell = "whisper-large-v2.finetune"
    a, b, c = (_driver(finetune, cell, s) for s in (3, 3, 4))
    ia, ib, ic = (d._items(np.random.default_rng(d.seed)) for d in (a, b, c))
    assert all(np.array_equal(x["wav"], y["wav"]) and x["labels"] == y["labels"]
               for x, y in zip(ia, ib))
    assert sorted(len(x["wav"]) for x in ia) == sorted(len(x["wav"]) for x in ic)
    assert sorted(len(x["dec_input_ids"]) for x in ia) == list(range(16, 129, 16))
