"""Device time (ms) per batch of the mel front end and the Whisper encoder
in the audio-visual cell: the operations launched in the harness's ``mel``
and ``encoder`` ranges, over the batches of the traced window."""


def read(r):
    units = r.stats.get("units")
    total = r.device_s("mel") + r.device_s("encoder")
    if not units or total <= 0:
        return None
    return 1e3 * total / units
