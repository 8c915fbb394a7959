"""The arithmetic of the end-to-end metrics and of the check's numbers."""
from __future__ import annotations

import math

import numpy as np


def window_ms(window_s: float, completed: int):
    """The window's milliseconds over the requests completed in it."""
    return None if completed <= 0 else 1e3 * window_s / completed


def percentile_ms(latencies_s: list, q: float):
    """The ``q`` percentile (nearest rank) of every request's time."""
    if not latencies_s:
        return None
    xs = sorted(latencies_s)
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return 1e3 * xs[k - 1]


def rel_gap(got: float, want: float) -> float:
    """|got - want| / |want|; inf where only the reference vanishes."""
    if want == 0.0:
        return 0.0 if got == 0.0 else math.inf
    return abs(got - want) / abs(want)


def worst_leaf_norm_gap(got: list, want: list) -> float:
    """The worst leaf's gap between the norms of ``got`` and ``want`` (lists
    of arrays, one a leaf), over the larger of that leaf's reference norm
    and the median leaf's."""
    g = [float(np.linalg.norm(np.asarray(x, np.float64))) for x in got]
    w = [float(np.linalg.norm(np.asarray(x, np.float64))) for x in want]
    med = float(np.median(w))
    worst = 0.0
    for a, b in zip(g, w):
        den = max(b, med)
        worst = max(worst, abs(a - b) / den if den > 0 else
                    (0.0 if a == 0 else math.inf))
    return worst
