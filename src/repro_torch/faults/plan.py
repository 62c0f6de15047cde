"""Deterministic, seeded fault injection (the chaos substrate).

A :class:`FaultPlan` is a *schedule*, not a dice roll at runtime: the
decision for occurrence ``n`` of site ``s`` under seed ``k`` is a pure
function of ``(k, s, n)`` (explicit occurrence lists, or a Bernoulli
draw from ``default_rng((seed, crc32(site), spec_idx, occurrence))``),
so every chaos run is bit-reproducible — two runs with the same seed
inject the same faults at the same points, and a failure found in CI
replays locally from nothing but the seed.

Injection *sites* are named call points threaded through the lifecycle
(``snapshot.write_leaf``, ``snapshot.load``, ``ring.push``,
``swap.flip``, ``train.step``, ``gate.eval``, ...).  Instrumented code
holds a :class:`FaultInjector` (the process singleton by default,
mirroring ``repro_torch.obs``: disabled = one attribute check per site) and
calls :meth:`FaultInjector.fire` at each site.  Four actions:

* ``raise``   raise :class:`InjectedFault` — an ordinary stage failure
              the retry/degradation machinery must absorb;
* ``crash``   raise :class:`InjectedCrash` — simulated process death.
              Retry wrappers MUST NOT catch it; only a top-level chaos
              harness may, modelling a restart;
* ``delay``   sleep ``delay_s`` (injectable sleeper) — exercises stage
              deadlines and gives subprocess-kill tests a window;
* ``corrupt`` flip bytes of the file passed as ``path=`` with a keyed
              RNG — exercises checksum verification and fallback.

Every injection is recorded in :attr:`FaultPlan.log` and emitted as a
``fault.injected`` obs span (+ ``faults.injected`` counter), so a chaos
run can assert its whole schedule is visible in the trace.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import get_telemetry

ACTIONS = ("raise", "crash", "delay", "corrupt")


class InjectedFault(RuntimeError):
    """A scheduled failure: recoverable, retry/degrade machinery owns it."""

    def __init__(self, site: str, occurrence: int, action: str = "raise"):
        super().__init__(f"injected {action} at {site}#{occurrence}")
        self.site = site
        self.occurrence = occurrence
        self.action = action


class InjectedCrash(InjectedFault):
    """Simulated process death.  Never caught by retries — only a chaos
    harness may catch it, at the point that models a process restart."""

    def __init__(self, site: str, occurrence: int):
        super().__init__(site, occurrence, action="crash")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled failure mode at one site.

    ``occurrences``  explicit 0-based occurrence indices to inject at
                     (deterministic targeting — the usual mode);
    ``prob``         else: keyed Bernoulli per occurrence (seeded sweep
                     mode; still bit-reproducible);
    ``max_injections``  cap on how many times this spec may fire;
    ``delay_s``      sleep length for ``action="delay"``.
    """
    site: str
    action: str
    occurrences: Tuple[int, ...] = ()
    prob: float = 0.0
    max_injections: int = 1 << 30
    delay_s: float = 0.0

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r} "
                             f"(known: {ACTIONS})")


def _site_key(site: str) -> int:
    return zlib.crc32(site.encode("utf-8"))


def corrupt_file(path: str, key: Tuple[int, ...], n_bytes: int = 8) -> int:
    """Deterministically flip up to ``n_bytes`` bytes of ``path`` (keyed
    offsets, each byte XOR 0xFF so the value always changes).  Offsets
    skip the first 128 bytes when the file is larger (the ``.npy``
    header region), so the corruption lands in payload data; checksum
    verification catches it either way.  Returns bytes flipped."""
    size = os.path.getsize(path)
    if size == 0:
        return 0
    rng = np.random.default_rng(key)
    lo = 128 if size > 256 else 0
    offs = np.unique(rng.integers(lo, size, size=min(n_bytes, size)))
    with open(path, "r+b") as f:
        for o in offs:
            f.seek(int(o))
            b = f.read(1)
            f.seek(int(o))
            f.write(bytes([b[0] ^ 0xFF]))
    return len(offs)


class FaultPlan:
    """The seeded schedule: per-site occurrence counters plus the spec
    list, deciding (and executing) an action at every ``fire``.

    Thread-safe: the counter bump + decision + log append run under one
    lock (``ring.push`` sites fire from concurrent writers).  ``sleep``
    is injectable so delay faults are free in tests; ``on_inject`` is a
    test seam called with each injection record (subprocess-kill tests
    touch a sentinel file from it)."""

    def __init__(self, seed: int, specs, *, telemetry=None,
                 sleep: Optional[Callable[[float], None]] = None,
                 on_inject: Optional[Callable[[Dict], None]] = None):
        self.seed = int(seed)
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self.tel = telemetry if telemetry is not None else get_telemetry()
        self._sleep = sleep if sleep is not None else time.sleep
        self.on_inject = on_inject
        self._lock = threading.Lock()
        self._occ: Dict[str, int] = {}
        self._fired = [0] * len(self.specs)
        self.log: List[Dict] = []

    # -- the schedule -------------------------------------------------------

    def occurrence(self, site: str) -> int:
        """How many times ``site`` has fired so far."""
        with self._lock:
            return self._occ.get(site, 0)

    def _decide(self, site: str, occ: int
                ) -> Tuple[Optional[FaultSpec], int]:
        for si, spec in enumerate(self.specs):
            if spec.site != site or self._fired[si] >= spec.max_injections:
                continue
            if spec.occurrences:
                if occ in spec.occurrences:
                    return spec, si
            elif spec.prob > 0.0:
                r = np.random.default_rng(
                    (self.seed, _site_key(site), si, occ)).random()
                if r < spec.prob:
                    return spec, si
        return None, -1

    # -- the injection point ------------------------------------------------

    def fire(self, site: str, path: Optional[str] = None, **ctx):
        """Advance ``site``'s occurrence counter and act on any spec the
        schedule selects.  Returns the selected :class:`FaultSpec` (or
        ``None``) for ``delay``/``corrupt``; raises for ``raise`` and
        ``crash``."""
        with self._lock:
            occ = self._occ.get(site, 0)
            self._occ[site] = occ + 1
            spec, si = self._decide(site, occ)
            if spec is not None:
                self._fired[si] += 1
                rec = dict(site=site, occurrence=occ, action=spec.action,
                           seed=self.seed)
                self.log.append(rec)
        if spec is None:
            return None
        tel = self.tel
        with tel.span("fault.injected", site=site, occurrence=occ,
                      action=spec.action):
            pass                      # zero-work span: the trace record
        tel.counter("faults.injected")
        tel.counter(f"faults.{spec.action}")
        if self.on_inject is not None:
            self.on_inject(rec)
        if spec.action == "delay":
            self._sleep(spec.delay_s)
            return spec
        if spec.action == "corrupt":
            if path is not None and os.path.exists(path):
                corrupt_file(path, (self.seed, _site_key(site), occ))
            return spec
        if spec.action == "crash":
            raise InjectedCrash(site, occ)
        raise InjectedFault(site, occ)


class FaultInjector:
    """Process façade instrumented code holds a reference to.  With no
    plan installed (the default, always in production) every site costs
    one attribute check; ``install``/``clear`` mutate in place so
    references captured at construction time observe the change —
    exactly the ``repro_torch.obs`` singleton contract."""

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan

    @property
    def active(self) -> bool:
        return self.plan is not None

    def fire(self, site: str, path: Optional[str] = None, **ctx):
        plan = self.plan
        if plan is None:
            return None
        return plan.fire(site, path=path, **ctx)

    def install(self, plan: FaultPlan) -> FaultPlan:
        self.plan = plan
        return plan

    def clear(self) -> None:
        self.plan = None


_GLOBAL = FaultInjector()


def get_faults() -> FaultInjector:
    return _GLOBAL


def install_plan(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` on the process-wide injector (tests/harnesses
    prefer a private :class:`FaultInjector` threaded through ctors)."""
    return _GLOBAL.install(plan)


def clear_plan() -> None:
    _GLOBAL.clear()
