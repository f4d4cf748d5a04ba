"""Device time (ms) per train step on rank 0 of the collectives of the
mesh: the operations launched in the generator's ``allreduce`` range (the
gradients' flat all-reduce, the label count and the loss), waiting for the
other ranks included, over the steps of the traced window."""


def read(r):
    units = r.stats.get("units")
    dev = r.device_s("allreduce")
    if not units or dev <= 0:
        return None
    return 1e3 * dev / units
