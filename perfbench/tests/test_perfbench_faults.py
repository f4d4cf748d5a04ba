"""A whole run of each cell at the debug widths on the CPU (the harness's
look for a chip skipped), with the limits of ``perfbench/limits``: a sound
run comes out correct; the control (the reference computed in fp8 in the
program's place) and the program broken underneath come out not correct,
once for each fault the cell can have."""

import pytest

from perfbench.faults import (beam_token_altered, cache_left_unchanged, half_batch,
                              served_token_altered, update_negated, update_skipped)
from perfbench.run import run_cell

from .conftest import small_config

SEED = 3_000_000_019
CELLS = {
    "flamingo-small-text.beam15": ("flamingo-small-text", {"units": 1}),
    "whisper-large-v2.serve-poisson": ("whisper-large-v2", {"seconds": 3}),
    "whisper-large-v2.finetune": ("whisper-large-v2", {"units": 1}),
}


def _run(cell, control=None):
    cfg_name, window = CELLS[cell]
    return run_cell(cell, SEED, window.get("seconds", 0), False, device="cpu",
                    config=small_config(cfg_name), control=control, units=window.get("units", 0))


FAULTS = [
    ("flamingo-small-text.beam15", cache_left_unchanged),
    ("flamingo-small-text.beam15", beam_token_altered),
    ("whisper-large-v2.serve-poisson", cache_left_unchanged),
    ("whisper-large-v2.serve-poisson", served_token_altered),
    ("whisper-large-v2.finetune", update_skipped),
    ("whisper-large-v2.finetune", update_negated),
    ("whisper-large-v2.finetune", half_batch),
]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct(cell):
    out = _run(cell, control="fp8")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(cell, fault):
    with fault():
        out = _run(cell)
    assert not out["correct"], out["checks"]
