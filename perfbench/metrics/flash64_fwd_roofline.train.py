"""The flash64 forward's share (%) of its roofline in the training cell:
every forward call, the lse forwards of the step and of the remat
recompute included, at its least time (``roofline.flash64_fwd_s``) over
the device time in its ranges."""

from perfbench import roofline


def read(r):
    return r.roofline_pct("flash64_fwd", lambda c: roofline.flash64_fwd_s(
        c["bh"], c["t"], c["dtype"], c["with_lse"]))
