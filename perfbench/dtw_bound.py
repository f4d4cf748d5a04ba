"""The least time of the DTW wavefront: its chain of dependent steps.

The DP fills an (N+1, M+1) trace along N + M anti-diagonals, each cell
needing its neighbours of the two diagonals before, so no schedule takes
fewer than N + M dependent steps. One step (a neighbour's cost from the
lane before, the tie cascade, one fp32 add) took 32.88 ns on the H100 when
timed alone (``ops.dtw.chain_floor_ns``, "NVIDIA H100 80GB HBM3, 700.00 W",
PERF.md's kernel table, row 4). The bytes (an fp32 cost read once, an int8
trace written once) take far less at 3.35 TB/s, and the operations less
still, so the floor is the bound.
"""

from __future__ import annotations

CHAIN_STEP_S = 32.88e-9


def dtw_s(n: int, m: int) -> float:
    """Least time of one (N, M) cost matrix's trace."""
    return (int(n) + int(m)) * CHAIN_STEP_S
