"""The flash64 forward's share (%) of its roofline in the step-2 training
cell: the frozen encoder's forwards (no lse, no backward) at their least
time (``roofline.flash64_fwd_s``) over the device time in their ranges."""

from perfbench import roofline


def read(r):
    return r.roofline_pct("flash64_fwd", lambda c: roofline.flash64_fwd_s(
        c["bh"], c["t"], c["dtype"], c["with_lse"]))
