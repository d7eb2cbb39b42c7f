"""Host-side fixed-bucket histograms (port of ``repro.obs.hist``).

A :class:`FixedHistogram` holds one int64 count per static bucket plus
exact running ``count``/``sum``/``min``/``max``, so memory is
O(buckets) forever and percentiles come back within one bucket's
resolution of the exact answer.  Same edges/counts shape as the
reference, so both packages report latency the same way.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np


def log_edges(lo: float, hi: float, per_decade: int = 16) -> List[float]:
    """Log-spaced bucket edges covering [lo, hi], ``per_decade`` per
    decade."""
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
    n = int(math.ceil((math.log10(hi) - math.log10(lo)) * per_decade))
    return [lo * 10 ** (i / per_decade) for i in range(n + 1)]


# serving latencies: 1us .. 100s at 16 buckets/decade (129 buckets)
LATENCY_EDGES_S = log_edges(1e-6, 1e2, per_decade=16)


class FixedHistogram:
    """Fixed-bucket histogram with interpolated percentiles; values
    outside the edges land in the two open-end buckets and percentiles
    there clamp to the exact running min/max."""

    def __init__(self, edges: Sequence[float] = LATENCY_EDGES_S):
        edges = [float(e) for e in edges]
        if len(edges) < 1 or edges != sorted(edges):
            raise ValueError("edges must be >= 1 values, ascending")
        self.edges = np.asarray(edges, np.float64)
        self.counts = np.zeros(len(edges) + 1, np.int64)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float, n: int = 1) -> None:
        v = float(value)
        self.counts[int(np.searchsorted(self.edges, v, side="right"))] += n
        self.count += n
        self.sum += v * n
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (0..100), linear within the
        containing bucket; exact when all mass is one value."""
        if not 0 <= q <= 100:
            raise ValueError(f"percentile wants 0..100, got {q}")
        if self.count == 0:
            return 0.0
        rank = q / 100.0 * self.count
        cum = np.cumsum(self.counts)
        b = int(np.searchsorted(cum, rank, side="left"))
        b = min(b, len(self.counts) - 1)
        lo = self.edges[b - 1] if b > 0 else self.min
        hi = self.edges[b] if b < len(self.edges) else self.max
        lo, hi = max(lo, self.min), min(hi, self.max)
        if hi <= lo:
            return float(lo)
        prev = cum[b - 1] if b > 0 else 0
        inbucket = self.counts[b]
        frac = ((rank - prev) / inbucket) if inbucket else 0.0
        return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))

    def reset(self) -> None:
        self.counts[:] = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
