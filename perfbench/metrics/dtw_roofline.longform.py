"""The DTW kernel's share (%) of its bound: each call's chain floor
(``dtw_bound.dtw_s``, N + M dependent steps) over the device time of the
operations launched in the ``dtw`` range."""

from perfbench import dtw_bound


def read(r):
    return r.roofline_pct("dtw", lambda c: dtw_bound.dtw_s(c["n"], c["m"]))
