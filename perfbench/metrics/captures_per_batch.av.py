"""Step-graph captures (the program's ``decode.graph_captures`` counter over
the traced window) per batch: 0 once the window's batches share the keys
set-up captured."""


def read(r):
    units, captures = r.stats.get("units"), r.stats.get("graph_captures")
    if not units or captures is None:
        return None
    return captures / units
