"""Device time (ms) per train step of the frozen Whisper encoder (forward
only): the operations launched in the generator's ``encoder`` range and in
the flash64 forward's range nested in it (in this cell the encoder is
flash64's only caller), over the steps of the traced window."""


def read(r):
    units = r.stats.get("units")
    total = r.device_s("encoder") + r.device_s("flash64_fwd")
    if not units or total <= 0:
        return None
    return 1e3 * total / units
