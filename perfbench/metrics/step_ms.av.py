"""Mean host time (ms) from one incremental ``decoder_apply`` call of the
decode loop to the next in the audio-visual cell: one beam step,
bookkeeping included."""


def read(r):
    return r.mean_host_ms("step.decode")
