"""The flash64 forward's share (%) of its roofline in the decode cells: the
calls' summed least time (``roofline.flash64_fwd_s``) over the device time
of the operations launched in their ranges."""

from perfbench import roofline


def read(r):
    return r.roofline_pct("flash64_fwd", lambda c: roofline.flash64_fwd_s(
        c["bh"], c["t"], c["dtype"], c["with_lse"]))
