"""Rank 0's completed train steps (3 x the forward of its own batch,
``perfbench.flops``, the remat recompute not counted) over the window's
length times one card's bf16 dense peak, in %."""

from perfbench import roofline


def read(r):
    flops, window = r.stats.get("flops"), r.stats.get("window_s")
    if not flops or not window:
        return None
    return 100.0 * flops / (window * roofline.BF16_PEAK_FLOPS)
