"""Device time (ms) per train step of the operations launched inside
``WhisperOptimizer.step`` (AdamW over the gated parameters only)."""


def read(r):
    units = r.stats.get("units")
    dev = r.device_s("optimizer")
    if not units or dev <= 0:
        return None
    return 1e3 * dev / units
