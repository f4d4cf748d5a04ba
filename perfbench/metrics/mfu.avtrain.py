"""The operations of the train steps the window completed
(``perfbench.av_train_flops``: the frozen forwards once, each product's
backward for the operands that need a gradient, the remat recompute not
counted) over the window's length times the bf16 dense peak, in %."""

from perfbench import roofline


def read(r):
    flops, window = r.stats.get("flops"), r.stats.get("window_s")
    if not flops or not window:
        return None
    return 100.0 * flops / (window * roofline.BF16_PEAK_FLOPS)
