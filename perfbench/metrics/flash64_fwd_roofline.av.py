"""The flash64 forward's share (%) of its roofline in the audio-visual cell
(the large-v2 encoder, (160, 1500, 64) a batch of 8): the calls' summed least
time (``roofline.flash64_fwd_s``) over the device time of the operations
launched in their ranges."""

from perfbench import roofline


def read(r):
    return r.roofline_pct("flash64_fwd", lambda c: roofline.flash64_fwd_s(
        c["bh"], c["t"], c["dtype"], c["with_lse"]))
