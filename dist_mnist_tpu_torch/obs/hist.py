"""Streaming histograms: fixed log-bucket, thread-safe, mergeable.

(Copy of the reference package's `obs/hist.py`; the port imports nothing
of the reference.)

The serve reservoirs (`serve/metrics.py`) and any per-step timing signal
share the same problem: percentiles over an unbounded stream without
unbounded memory. A fixed geometric bucket ladder solves it — O(1) per
observation, O(n_buckets) memory, and two histograms with the same
ladder merge by adding counts (so per-process histograms can roll up
across a fleet). Quantile estimates carry the ladder's relative error
(`growth - 1`, ~10% at the default), while count/sum/min/max are exact.

Stdlib-only on purpose: the journal (`obs/events.py`) and supervisor
import freely without pulling numpy/jax.
"""

from __future__ import annotations

import math
import threading

__all__ = ["StreamingHistogram"]

# Default ladder: (1e-3, growth=1.1, 254 buckets) spans ~1e-3 .. ~3e7
# with <=10% relative error — microseconds to hours when the unit is ms.
_DEF_MIN = 1e-3
_DEF_GROWTH = 1.1
_DEF_BUCKETS = 254


class StreamingHistogram:
    """Fixed log-spaced bucket histogram over non-negative values.

    Bucket 0 holds everything <= ``min_value`` (including zeros and any
    stray negatives); the last bucket is the overflow. Interior bucket
    ``i`` covers ``(min_value * growth**(i-1), min_value * growth**i]``.
    """

    def __init__(self, *, min_value: float = _DEF_MIN,
                 growth: float = _DEF_GROWTH, n_buckets: int = _DEF_BUCKETS):
        if not (min_value > 0 and growth > 1 and n_buckets >= 2):
            raise ValueError(
                f"bad ladder: min_value={min_value} growth={growth} "
                f"n_buckets={n_buckets}")
        self.min_value = float(min_value)
        self.growth = float(growth)
        self.n_buckets = int(n_buckets)
        self._log_growth = math.log(self.growth)
        self._counts = [0] * self.n_buckets
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    # -- recording ------------------------------------------------------------

    def _index(self, value: float) -> int:
        if value <= self.min_value:
            return 0
        idx = 1 + int(math.floor(
            math.log(value / self.min_value) / self._log_growth))
        # floating-point edge: value exactly on an edge may round either way
        return min(max(idx, 1), self.n_buckets - 1)

    def observe(self, value: float) -> None:
        v = float(value)
        if math.isnan(v):
            return
        with self._lock:
            self._counts[self._index(v)] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def observe_many(self, values) -> None:
        for v in values:
            self.observe(float(v))

    def merge(self, other: "StreamingHistogram") -> None:
        """Fold ``other`` into self. Ladders must match exactly."""
        if (self.min_value, self.growth, self.n_buckets) != (
                other.min_value, other.growth, other.n_buckets):
            raise ValueError("cannot merge histograms with different ladders")
        with other._lock:
            counts = list(other._counts)
            count, total = other._count, other._sum
            lo, hi = other._min, other._max
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._count += count
            self._sum += total
            if lo < self._min:
                self._min = lo
            if hi > self._max:
                self._max = hi

    # -- reading --------------------------------------------------------------

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else math.nan

    def bucket_upper_edge(self, i: int) -> float:
        """Upper edge of bucket i (inf for the overflow bucket)."""
        if i >= self.n_buckets - 1:
            return math.inf
        return self.min_value * self.growth ** i

    def buckets(self) -> list[tuple[float, int]]:
        """(upper_edge, count) per bucket — the raw exposition surface."""
        with self._lock:
            counts = list(self._counts)
        return [(self.bucket_upper_edge(i), c) for i, c in enumerate(counts)]

    def quantile(self, q: float) -> float:
        """Approximate q-quantile; NaN when empty. Monotonic in q."""
        with self._lock:
            return self._quantile_locked(q)

    def _quantile_locked(self, q: float) -> float:
        if not self._count:
            return math.nan
        rank = max(1.0, math.ceil(q * self._count))
        cum = 0
        for i, c in enumerate(self._counts):
            cum += c
            if cum >= rank:
                # clamp the edge estimate to the exact observed range
                est = self.bucket_upper_edge(i)
                return min(max(est, self._min), self._max)
        return self._max

    def percentiles(self) -> dict:
        with self._lock:
            return {"p50": self._quantile_locked(0.50),
                    "p95": self._quantile_locked(0.95),
                    "p99": self._quantile_locked(0.99)}

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "count": self._count,
                "sum": self._sum,
                "mean": self._sum / self._count if self._count else math.nan,
                "min": self._min if self._count else math.nan,
                "max": self._max if self._count else math.nan,
                "p50": self._quantile_locked(0.50),
                "p95": self._quantile_locked(0.95),
                "p99": self._quantile_locked(0.99),
            }

    def representative_values(self, cap: int = 2048) -> list[float]:
        """Reconstruct a bounded sample that approximates the distribution
        (bucket midpoints repeated by count, thinned above ``cap``) so the
        raw-array ``MetricWriter.histogram`` protocol keeps working after
        the reservoirs it used to read are gone."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
            lo = self._min
            hi = self._max
        if not total:
            return []
        scale = min(1.0, cap / total)
        out: list[float] = []
        prev_edge = 0.0
        for i, c in enumerate(counts):
            edge = self.bucket_upper_edge(i)
            if c:
                mid = prev_edge + (min(edge, hi) - prev_edge) / 2 \
                    if math.isfinite(edge) else hi
                mid = min(max(mid, lo), hi)
                out.extend([mid] * max(1, int(round(c * scale))))
            prev_edge = edge if math.isfinite(edge) else prev_edge
        if len(out) > cap:
            # per-bucket rounding can overshoot; out is bucket-ordered, so
            # an even stride is a quantile-preserving thinning
            stride = len(out) / cap
            out = [out[int(i * stride)] for i in range(cap)]
        return out

    def __repr__(self):
        s = self.snapshot()
        return (f"StreamingHistogram(count={s['count']}, mean={s['mean']:.4g},"
                f" p50={s['p50']:.4g}, p99={s['p99']:.4g})")
