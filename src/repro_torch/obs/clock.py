"""Injectable clock — the single raw-clock site of the lifecycle modules.

The runtime, the swap server and the stores obtain time through a
:class:`Clock` (usually via the
:class:`~repro_torch.obs.telemetry.Telemetry` facade), so a test can
replace it with :class:`FixedClock` and replay a trace byte for byte.

Two implementations:

* :class:`SystemClock` — wraps the real wall/monotonic clocks.
* :class:`FixedClock` — fully deterministic; ``perf()`` auto-advances by
  a fixed tick so spans get stable nonzero durations, which makes
  telemetry JSONL byte-reproducible in tests.
"""
from __future__ import annotations

import time


class Clock:
    """Time source interface: ``wall()`` epoch seconds, ``perf()`` monotonic."""

    def wall(self) -> float:
        raise NotImplementedError

    def perf(self) -> float:
        raise NotImplementedError


class SystemClock(Clock):
    """Real clocks. The only place in the tree that calls ``time.*`` raw."""

    def wall(self) -> float:
        return time.time()

    def perf(self) -> float:
        return time.perf_counter()


class FixedClock(Clock):
    """Deterministic clock for tests.

    ``wall()`` returns a constant; ``perf()`` returns a monotonically
    increasing value that advances by ``tick`` on every call, so code
    that measures ``perf() - perf()`` deltas sees stable, nonzero
    durations regardless of host speed.
    """

    def __init__(self, wall: float = 1_700_000_000.0,
                 perf: float = 0.0, tick: float = 1e-3) -> None:
        self._wall = float(wall)
        self._perf = float(perf)
        self._tick = float(tick)

    def wall(self) -> float:
        return self._wall

    def perf(self) -> float:
        self._perf += self._tick
        return self._perf

    def advance(self, dt: float) -> None:
        """Jump both clocks forward by ``dt`` seconds."""
        self._wall += dt
        self._perf += dt
