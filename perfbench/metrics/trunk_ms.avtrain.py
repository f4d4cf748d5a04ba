"""Device time (ms) per train step of the frozen AV-HuBERT trunk: the
operations launched in the generator's ``trunk`` range (the lip-video front
end and the transformer, forward only), over the steps of the traced
window."""


def read(r):
    units = r.stats.get("units")
    total = r.device_s("trunk")
    if not units or total <= 0:
        return None
    return 1e3 * total / units
