"""Mean host time (ms) from one incremental ``decoder_apply`` call of a
window's greedy loop to the next in the long-form cell: one step at batch 1,
bookkeeping included (a window's prefill ends a run of steps)."""


def read(r):
    return r.mean_host_ms("step.decode")
