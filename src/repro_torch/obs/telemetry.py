"""Telemetry facade: spans + metrics + sink behind one object.

One :class:`Telemetry` instance owns a clock, a metrics registry, and a
sink. Spans are context managers that always *measure* (callers rely on
``span.elapsed()`` for report fields like ``build_seconds``) but only
*emit* JSONL when the instance is enabled. Counters/gauges/histograms
write to per-thread shards (see :mod:`repro_torch.obs.metrics`) and are
serialized cumulatively on :meth:`Telemetry.flush`.

A module-level singleton (:func:`get_telemetry` / :func:`configure`)
lets instrumented library code default to the process-wide instance
while tests inject private ones. ``configure`` mutates the singleton
*in place* so references captured at construction time (e.g. a store
built before the benchmark configured telemetry) observe the change.

JSONL schema (one object per line, sorted keys, compact separators):

* ``{"type": "span", "name", "span_id", "parent_id", "thread",
  "t_wall", "dur_s", "attrs"}``
* ``{"type": "counter"|"gauge", "name", "value", "t_wall"}``
* ``{"type": "hist", "name", "t_wall", "n", "sum", "min", "max",
  "counts", "base", "growth"}`` — cumulative at flush time.
"""
from __future__ import annotations

import itertools
import json
import threading
from typing import Dict, Optional, Tuple

from .clock import Clock, SystemClock
from .metrics import Histogram, MetricsRegistry
from .sink import JsonlSink, NullSink, Sink


def _dumps(obj: dict) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=float)


class Span:
    """Context-manager timer. Measures always; emits only when enabled."""

    __slots__ = ("name", "attrs", "span_id", "parent_id",
                 "t_wall", "duration_s", "_tel", "_t0")

    def __init__(self, tel: "Telemetry", name: str,
                 attrs: Optional[dict] = None) -> None:
        self._tel = tel
        self.name = name
        self.attrs = dict(attrs) if attrs else {}
        self.span_id: Optional[int] = None
        self.parent_id: Optional[int] = None
        self.t_wall = 0.0
        self.duration_s = 0.0
        self._t0 = 0.0

    def set(self, key: str, value) -> "Span":
        self.attrs[key] = value
        return self

    def elapsed(self) -> float:
        """Seconds since span entry (usable before and after exit)."""
        if self.duration_s:
            return self.duration_s
        return self._tel._clock.perf() - self._t0

    def __enter__(self) -> "Span":
        tel = self._tel
        self.span_id = next(tel._span_ids)
        self.t_wall = tel._clock.wall()
        stack = tel._span_stack()
        self.parent_id = stack[-1].span_id if stack else None
        stack.append(self)
        self._t0 = tel._clock.perf()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        tel = self._tel
        self.duration_s = tel._clock.perf() - self._t0
        stack = tel._span_stack()
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        tel._emit_span(self)


class Telemetry:
    """Facade over clock + metrics registry + sink."""

    def __init__(self, *, sink: Optional[Sink] = None,
                 clock: Optional[Clock] = None,
                 enabled: bool = True) -> None:
        self._sink: Sink = sink if sink is not None else NullSink()
        self._clock: Clock = clock if clock is not None else SystemClock()
        self.enabled = bool(enabled)
        self.metrics = MetricsRegistry()
        self._span_ids = itertools.count(1)
        self._tls = threading.local()
        self._ti_lock = threading.Lock()
        self._thread_ids: Dict[int, int] = {}

    # -- internals -------------------------------------------------------
    def _span_stack(self):
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _thread_index(self) -> int:
        ti = getattr(self._tls, "ti", None)
        if ti is None:
            ident = threading.get_ident()
            with self._ti_lock:
                ti = self._thread_ids.setdefault(ident,
                                                 len(self._thread_ids))
            self._tls.ti = ti
        return ti

    def _emit_span(self, sp: Span) -> None:
        if not self.enabled:
            return
        self._sink.write_line(_dumps({
            "type": "span",
            "name": sp.name,
            "span_id": sp.span_id,
            "parent_id": sp.parent_id,
            "thread": self._thread_index(),
            "t_wall": sp.t_wall,
            "dur_s": sp.duration_s,
            "attrs": sp.attrs,
        }))

    # -- public API ------------------------------------------------------
    @property
    def clock(self) -> Clock:
        return self._clock

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs or None)

    def counter(self, name: str, delta: float = 1.0) -> None:
        if self.enabled:
            self.metrics.counter(name, delta)

    def gauge(self, name: str, value: float) -> None:
        if self.enabled:
            self.metrics.gauge(name, float(value))

    def observe(self, name: str, value: float) -> None:
        if self.enabled:
            self.metrics.observe(name, float(value))

    def snapshot(self) -> dict:
        """Merged metric state: counters, gauges, histogram summaries."""
        counters, gauges, hists = self.metrics.merged()
        return {
            "counters": dict(sorted(counters.items())),
            "gauges": dict(sorted(gauges.items())),
            "hists": {k: h.to_dict() for k, h in sorted(hists.items())},
        }

    def percentiles(self, name: str,
                    qs: Tuple[float, ...] = (0.5, 0.95, 0.99)
                    ) -> Dict[str, float]:
        _, _, hists = self.metrics.merged()
        h = hists.get(name, Histogram())
        return {f"p{int(q * 100)}": h.percentile(q) for q in qs}

    def flush(self) -> None:
        """Serialize cumulative metric state to the sink, then flush it."""
        if self.enabled:
            counters, gauges, hists = self.metrics.merged()
            t = self._clock.wall()
            for name in sorted(counters):
                self._sink.write_line(_dumps({
                    "type": "counter", "name": name,
                    "value": counters[name], "t_wall": t}))
            for name in sorted(gauges):
                self._sink.write_line(_dumps({
                    "type": "gauge", "name": name,
                    "value": gauges[name], "t_wall": t}))
            for name in sorted(hists):
                rec = {"type": "hist", "name": name, "t_wall": t}
                rec.update(hists[name].to_dict())
                self._sink.write_line(_dumps(rec))
        self._sink.flush()

    def reset_metrics(self) -> None:
        self.metrics.reset()

    def reconfigure(self, *, sink: Optional[Sink] = None,
                    clock: Optional[Clock] = None,
                    enabled: Optional[bool] = None) -> "Telemetry":
        """Mutate this instance in place (late-bound refs see the change)."""
        if sink is not None:
            old = self._sink
            self._sink = sink
            old.close()
        if clock is not None:
            self._clock = clock
        if enabled is not None:
            self.enabled = bool(enabled)
        return self


# Process-wide singleton. Disabled by default: library code is
# instrumented unconditionally and pays ~one attribute check until an
# entry point (benchmark, example, test) calls ``configure``.
_GLOBAL = Telemetry(enabled=False)


def get_telemetry() -> Telemetry:
    return _GLOBAL


def configure(*, path: Optional[str] = None, sink: Optional[Sink] = None,
              clock: Optional[Clock] = None, enabled: bool = True,
              max_bytes: int = 64 * 1024 * 1024,
              max_files: int = 4) -> Telemetry:
    """(Re)configure the process-wide telemetry singleton in place."""
    if sink is None and path is not None:
        sink = JsonlSink(path, max_bytes=max_bytes, max_files=max_files)
    if sink is None and not enabled:
        sink = NullSink()
    return _GLOBAL.reconfigure(sink=sink, clock=clock, enabled=enabled)
