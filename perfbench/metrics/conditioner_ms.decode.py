"""Mean host time (ms) of one ``encode_multi`` call, synchronised on both
sides: the text conditioner's share of a decode batch."""


def read(r):
    return r.mean_host_ms("conditioner")
