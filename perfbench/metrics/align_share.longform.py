"""Share (%) of the window's wall time in word alignment: the host time,
synchronised on both sides, of the generator's ``align`` range (the second
encode of the window's mel and the teacher-forced forward that gives the
cross-attention weights) and its ``dtw`` range (the DTW kernel)."""


def read(r):
    window = r.stats.get("window_s")
    spent = r.host_ms.get("align", []) + r.host_ms.get("dtw", [])
    if not window or not spent:
        return None
    return 100.0 * sum(spent) / (1e3 * window)
