"""Counters, gauges, and log-bucket histograms with per-thread shards.

Hot-path writes (``counter``/``gauge``/``observe``) touch only the
calling thread's private shard — a plain dict update under the GIL, no
shared lock — so the serving retrieve path never contends with other
readers or with a scraper. Reads (:meth:`MetricsRegistry.merged`)
take the registry lock once to snapshot the shard list, then merge.
Shards are registered at first use and kept for the life of the
registry so no samples are lost when a thread exits.

Histograms use fixed log-spaced buckets: bucket ``i`` covers
``[BASE * GROWTH**i, BASE * GROWTH**(i+1))`` with ``BASE = 1e-6`` s and
``GROWTH = sqrt(2)``, i.e. ~10% relative resolution from 1 µs to
~45 min in 64 buckets. Percentiles are read back at the geometric
bucket midpoint.
"""
from __future__ import annotations

import itertools
import math
import threading
from typing import Dict, List, Tuple

HIST_BASE = 1e-6
HIST_GROWTH = math.sqrt(2.0)
HIST_BUCKETS = 64

_LOG_GROWTH = math.log(HIST_GROWTH)

# Global sequence for gauge last-write-wins merge across shards.
_gauge_seq = itertools.count()


def bucket_index(value: float) -> int:
    """Bucket for ``value`` (seconds or any nonnegative quantity)."""
    if value < HIST_BASE:
        return 0
    i = int(math.log(value / HIST_BASE) / _LOG_GROWTH)
    return min(max(i, 0), HIST_BUCKETS - 1)


def bucket_mid(i: int) -> float:
    """Geometric midpoint of bucket ``i`` — the read-back value."""
    lo = HIST_BASE * HIST_GROWTH ** i
    return lo * math.sqrt(HIST_GROWTH)


class Histogram:
    """Fixed log-bucket histogram; single-writer, merged on read."""

    __slots__ = ("counts", "n", "total", "min", "max")

    def __init__(self) -> None:
        self.counts: Dict[int, int] = {}
        self.n = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        i = bucket_index(v)
        self.counts[i] = self.counts.get(i, 0) + 1
        self.n += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def merge(self, other: "Histogram") -> None:
        for i, c in other.counts.items():
            self.counts[i] = self.counts.get(i, 0) + c
        self.n += other.n
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def percentile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1], clamped to observed min/max."""
        if self.n == 0:
            return 0.0
        target = q * self.n
        seen = 0
        for i in sorted(self.counts):
            seen += self.counts[i]
            if seen >= target:
                return min(max(bucket_mid(i), self.min), self.max)
        return self.max

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def to_dict(self) -> dict:
        return {
            "n": self.n,
            "sum": self.total,
            "min": self.min if self.n else 0.0,
            "max": self.max if self.n else 0.0,
            "counts": {str(i): c for i, c in sorted(self.counts.items())},
            "base": HIST_BASE,
            "growth": HIST_GROWTH,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        h = cls()
        h.counts = {int(i): int(c) for i, c in d.get("counts", {}).items()}
        h.n = int(d.get("n", 0))
        h.total = float(d.get("sum", 0.0))
        if h.n:
            h.min = float(d.get("min", 0.0))
            h.max = float(d.get("max", 0.0))
        return h


class _Shard:
    """One thread's private metric storage. Never shared for writing."""

    __slots__ = ("counters", "gauges", "hists")

    def __init__(self) -> None:
        self.counters: Dict[str, float] = {}
        # name -> (seq, value); highest seq wins across shards.
        self.gauges: Dict[str, Tuple[int, float]] = {}
        self.hists: Dict[str, Histogram] = {}


class MetricsRegistry:
    """Thread-sharded metrics: lock-free writes, locked merge on read."""

    def __init__(self) -> None:
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._shards: List[_Shard] = []

    def _shard(self) -> _Shard:
        sh = getattr(self._tls, "shard", None)
        if sh is None:
            sh = _Shard()
            with self._lock:
                self._shards.append(sh)
            self._tls.shard = sh
        return sh

    # -- hot-path writes ------------------------------------------------
    def counter(self, name: str, delta: float = 1.0) -> None:
        c = self._shard().counters
        c[name] = c.get(name, 0.0) + delta

    def gauge(self, name: str, value: float) -> None:
        self._shard().gauges[name] = (next(_gauge_seq), float(value))

    def observe(self, name: str, value: float) -> None:
        h = self._shard().hists
        hist = h.get(name)
        if hist is None:
            hist = h[name] = Histogram()
        hist.observe(value)

    # -- reads ----------------------------------------------------------
    def merged(self) -> Tuple[Dict[str, float], Dict[str, float],
                              Dict[str, Histogram]]:
        """Merge all shards: (counters, gauges, histograms)."""
        with self._lock:
            shards = list(self._shards)
        counters: Dict[str, float] = {}
        gauges: Dict[str, Tuple[int, float]] = {}
        hists: Dict[str, Histogram] = {}
        for sh in shards:
            for name, v in list(sh.counters.items()):
                counters[name] = counters.get(name, 0.0) + v
            for name, (seq, v) in list(sh.gauges.items()):
                prev = gauges.get(name)
                if prev is None or seq > prev[0]:
                    gauges[name] = (seq, v)
            for name, h in list(sh.hists.items()):
                tgt = hists.get(name)
                if tgt is None:
                    tgt = hists[name] = Histogram()
                tgt.merge(h)
        return counters, {k: v for k, (_, v) in gauges.items()}, hists

    def reset(self) -> None:
        """Drop all shards. Existing threads re-register on next write."""
        with self._lock:
            self._shards = []
        # Threads that still hold a stale shard in their TLS would write
        # into a detached dict; rebind lazily by clearing our own TLS and
        # marking via a generation check is overkill here — reset() is a
        # test/benchmark affordance, callers quiesce writers first.
        self._tls = threading.local()
