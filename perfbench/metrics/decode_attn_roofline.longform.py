"""The decode-attention step's share (%) of its roofline in the long-form
cell (one row, d 1280): each call's least time at its row's cache offset
(``roofline.decode_attn_s``) over the device time in its ranges."""

from perfbench import roofline


def read(r):
    return r.roofline_pct("decode_attn", lambda c: roofline.decode_attn_s(
        c["rows"], c["d"], c["offsets"], c["dtype"]))
