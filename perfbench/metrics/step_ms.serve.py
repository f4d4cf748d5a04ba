"""Mean host time (ms) from one incremental ``decoder_apply`` call of the
continuous batcher to the next: one step of every slot, bookkeeping
included."""


def read(r):
    return r.mean_host_ms("step.serve")
