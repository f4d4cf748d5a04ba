"""The flash64 backward's share (%) of its roofline: each call counted as
its five products (``roofline.flash64_bwd_s``) over the device time of its
three kernels."""

from perfbench import roofline


def read(r):
    return r.roofline_pct("flash64_bwd", lambda c: roofline.flash64_bwd_s(
        c["bh"], c["t"], c["dtype"]))
