"""Mergeable log-bucketed latency histograms (HDR-histogram shape); a copy
of `bng_tpu/telemetry/hist.py`.

Why not the Prometheus Histogram in control/metrics.py: its fixed bucket
tuple cannot recover a p999 at microsecond resolution, and merging two of
them across fleet worker processes loses everything between bucket
bounds. This is the standard HDR answer (log2 octaves subdivided
linearly): bounded relative error, O(1) record, and merge is plain
counter addition — associative and commutative by construction, so
per-worker and per-shard histograms fold into one fleet-wide
distribution in any order.

Geometry: values are recorded in integer nanoseconds. The first 8
buckets are exact (0..7 ns); above that each octave [2^e, 2^(e+1)) is
split into 8 linear sub-buckets, so every bucket's width is 1/8 of its
magnitude — relative quantization error <= 12.5%, percentiles reported
at the bucket midpoint. 488 int64 buckets cover 1 ns .. ~4.6e18 ns
(146 years) in ~4 KB.
"""

from __future__ import annotations

import numpy as np

_SUB = 8  # linear sub-buckets per octave (3 mantissa bits)
_SUB_BITS = 3
# exact buckets 0..7, then octaves e=3..62 (int64 range) x 8 sub-buckets
NBUCKETS = _SUB + (63 - _SUB_BITS) * _SUB


def _bucket_of(v_ns: int) -> int:
    """Bucket index for a non-negative integer nanosecond value."""
    if v_ns < _SUB:
        return v_ns if v_ns > 0 else 0
    e = v_ns.bit_length() - 1  # >= 3
    return (e - _SUB_BITS) * _SUB + ((v_ns >> (e - _SUB_BITS)) & (_SUB - 1)) + _SUB


def _bucket_bounds(idx: int) -> tuple[float, float]:
    """[lo, hi) in ns for bucket idx."""
    if idx < _SUB:
        return float(idx), float(idx + 1)
    b = idx - _SUB
    e = b // _SUB + _SUB_BITS
    m = b % _SUB
    width = 1 << (e - _SUB_BITS)
    lo = (_SUB + m) * width
    return float(lo), float(lo + width)


def counts_percentile(counts: np.ndarray, q: float) -> float:
    """q-th percentile (us, bucket-midpoint, <=12.5% rel. error) from a
    raw bucket-count vector — the ONE rank/cumsum/midpoint core.
    LatencyHist.percentile wraps it (adding the observed min/max
    clamp); the SLO monitor's windowed p99 calls it directly on
    bucket-count DELTAS, so the two can never drift apart."""
    n = int(counts.sum())
    if n == 0:
        return 0.0
    rank = q / 100.0 * (n - 1)
    target = int(np.floor(rank)) + 1  # 1-based sample index
    cum = np.cumsum(counts)
    idx = int(np.searchsorted(cum, target))
    lo, hi = _bucket_bounds(idx)
    return (lo + hi) / 2.0 / 1000.0


class LatencyHist:
    """One mergeable latency distribution. The public unit is
    MICROSECONDS (the stage-latency quantity); storage is ns buckets."""

    __slots__ = ("counts", "n", "sum_us", "min_us", "max_us")

    def __init__(self):
        self.counts = np.zeros(NBUCKETS, dtype=np.int64)
        self.n = 0
        self.sum_us = 0.0
        self.min_us = float("inf")
        self.max_us = 0.0

    # -- recording --------------------------------------------------------

    def record(self, us: float) -> None:
        if us < 0.0:
            us = 0.0
        self.counts[_bucket_of(int(us * 1000.0))] += 1
        self.n += 1
        self.sum_us += us
        if us < self.min_us:
            self.min_us = us
        if us > self.max_us:
            self.max_us = us

    def record_many(self, us_values) -> None:
        """Vectorized bulk record (bench feeds profiler distributions)."""
        us = np.asarray(us_values, dtype=np.float64)
        if us.size == 0:
            return
        us = np.maximum(us, 0.0)
        v = np.maximum((us * 1000.0).astype(np.int64), 0)
        # exponent via frexp (exact for ints < 2^53: v = m * 2^ex, m in
        # [0.5, 1) -> e = ex - 1); small values take the exact buckets
        _m, ex = np.frexp(np.maximum(v, 1).astype(np.float64))
        e = (ex - 1).astype(np.int64)
        shift = np.maximum(e - _SUB_BITS, 0)
        sub = (v >> shift) & (_SUB - 1)
        idx = np.where(v < _SUB, v,
                       (e - _SUB_BITS) * _SUB + sub + _SUB)
        np.add.at(self.counts, idx, 1)
        self.n += int(us.size)
        self.sum_us += float(us.sum())
        self.min_us = min(self.min_us, float(us.min()))
        self.max_us = max(self.max_us, float(us.max()))

    # -- queries ----------------------------------------------------------

    def percentile(self, q: float) -> float:
        """q-th percentile in us (bucket-midpoint; <=12.5% rel. error)."""
        if self.n == 0:
            return 0.0
        mid_us = counts_percentile(self.counts, q)
        # clamp into the observed range: midpoints can overshoot max
        return float(min(max(mid_us, self.min_us), self.max_us))

    def cumulative_le(self, us: float) -> int:
        """Samples <= us (bucket-granular: counts every bucket whose
        lower bound is <= the threshold — the Prometheus export bound)."""
        v_ns = int(us * 1000.0)
        idx = _bucket_of(v_ns)
        return int(self.counts[: idx + 1].sum())

    @property
    def mean_us(self) -> float:
        return self.sum_us / self.n if self.n else 0.0

    # -- merge (associative + commutative: plain counter addition) --------

    def merge(self, other: "LatencyHist") -> "LatencyHist":
        self.counts += other.counts
        self.n += other.n
        self.sum_us += other.sum_us
        self.min_us = min(self.min_us, other.min_us)
        self.max_us = max(self.max_us, other.max_us)
        return self

    def copy(self) -> "LatencyHist":
        h = LatencyHist()
        h.counts = self.counts.copy()
        h.n, h.sum_us = self.n, self.sum_us
        h.min_us, h.max_us = self.min_us, self.max_us
        return h

    # -- wire format (fleet workers ship these over the result pipe) ------

    def to_dict(self) -> dict:
        nz = np.nonzero(self.counts)[0]
        return {
            "n": self.n,
            "sum_us": self.sum_us,
            "min_us": self.min_us if self.n else 0.0,
            "max_us": self.max_us,
            "counts": {int(i): int(self.counts[i]) for i in nz},
        }

    @staticmethod
    def from_dict(d: dict) -> "LatencyHist":
        h = LatencyHist()
        h.n = int(d.get("n", 0))
        h.sum_us = float(d.get("sum_us", 0.0))
        h.min_us = float(d.get("min_us", 0.0)) if h.n else float("inf")
        h.max_us = float(d.get("max_us", 0.0))
        for i, c in d.get("counts", {}).items():
            i = int(i)
            if 0 <= i < NBUCKETS:
                h.counts[i] = int(c)
        return h

    def summary(self) -> dict:
        """{count, p50/p99/p999, mean, max} in us — the report shape."""
        return {
            "count": self.n,
            "p50_us": round(self.percentile(50), 2),
            "p99_us": round(self.percentile(99), 2),
            "p999_us": round(self.percentile(99.9), 2),
            "mean_us": round(self.mean_us, 2),
            "max_us": round(self.max_us, 2) if self.n else 0.0,
        }
