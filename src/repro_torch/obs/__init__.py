"""repro_torch.obs — stdlib-only lifecycle telemetry, the port's own copy
of ``repro/obs`` (the same API and the same JSONL record schema).

Three primitives behind one facade:

* **spans** — context-manager timers emitting JSONL trace events with
  name, parent, wall time, duration, and free-form attrs;
* **counters / gauges** — thread-safe registry with per-thread shards
  merged on read, so the serving hot path never takes a contended lock;
* **histograms** — fixed log-spaced buckets (1 µs base, √2 growth) with
  p50/p95/p99 extraction.

All clock access flows through the injectable :class:`Clock`;
:class:`SystemClock` in :mod:`repro_torch.obs.clock` is the single
raw-clock site of the lifecycle modules.

Module-level conveniences delegate to the process-wide singleton:

    from repro_torch import obs
    obs.configure(path="run.jsonl")
    with obs.span("construct", stage="graph"):
        ...
    obs.counter("serving.seqlock_retries")
    obs.flush()

The JAX package's trace renderer (``repro/obs/report.py``) reads the
same JSONL; the port has no renderer of its own yet.
"""
from __future__ import annotations

from .clock import Clock, FixedClock, SystemClock
from .metrics import Histogram, MetricsRegistry
from .sink import JsonlSink, MemorySink, NullSink, Sink
from .telemetry import Span, Telemetry, configure, get_telemetry

__all__ = [
    "Clock", "FixedClock", "SystemClock",
    "Histogram", "MetricsRegistry",
    "Sink", "NullSink", "MemorySink", "JsonlSink",
    "Span", "Telemetry", "configure", "get_telemetry",
    "span", "counter", "gauge", "observe", "flush", "snapshot",
]


def span(name: str, **attrs) -> Span:
    return get_telemetry().span(name, **attrs)


def counter(name: str, delta: float = 1.0) -> None:
    get_telemetry().counter(name, delta)


def gauge(name: str, value: float) -> None:
    get_telemetry().gauge(name, value)


def observe(name: str, value: float) -> None:
    get_telemetry().observe(name, value)


def flush() -> None:
    get_telemetry().flush()


def snapshot() -> dict:
    return get_telemetry().snapshot()
