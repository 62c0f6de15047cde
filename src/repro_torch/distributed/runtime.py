"""Cluster-runtime scaffolding: health, stragglers, elastic restarts, as
``repro/distributed/runtime.py`` (numpy; no transport).

In a synchronous SPMD job the failure model is: hosts vanish
(preemption, hardware), hosts straggle (thermal, network), and capacity
changes between restarts.  The mechanisms live outside the step:

  * ``HeartbeatMonitor``: per-host progress heartbeats with a deadline;
    a missed deadline marks the host suspect.  The clock is injectable,
    so a test drives it with a fake one.
  * ``StragglerTracker``: hosts whose EWMA step time exceeds the median
    times a tolerance.
  * ``ElasticPlan``: the (data, model) mesh for a new chip count, the
    model axis kept where it divides and halved until it does.
  * ``recovery_cost_model``: the expected share of time lost to failures
    under a checkpoint interval.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List

import numpy as np


@dataclasses.dataclass
class HostState:
    last_beat: float
    last_step: int
    ewma_step_s: float = 0.0


class HeartbeatMonitor:
    def __init__(self, hosts: List[str], *, deadline_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.deadline = deadline_s
        self.clock = clock
        now = clock()
        self.hosts: Dict[str, HostState] = {
            h: HostState(now, -1) for h in hosts}

    def beat(self, host: str, step: int) -> None:
        now = self.clock()
        st = self.hosts[host]
        if st.last_step >= 0 and step > st.last_step:
            dt = (now - st.last_beat) / max(step - st.last_step, 1)
            st.ewma_step_s = (0.8 * st.ewma_step_s + 0.2 * dt
                              if st.ewma_step_s else dt)
        st.last_beat = now
        st.last_step = step

    def suspects(self) -> List[str]:
        now = self.clock()
        return [h for h, st in self.hosts.items()
                if now - st.last_beat > self.deadline]

    def healthy(self) -> bool:
        return not self.suspects()


class StragglerTracker:
    """Flags hosts whose EWMA step time exceeds median x tolerance."""

    def __init__(self, monitor: HeartbeatMonitor, tolerance: float = 1.5):
        self.monitor = monitor
        self.tolerance = tolerance

    def stragglers(self) -> List[str]:
        times = {h: st.ewma_step_s for h, st in self.monitor.hosts.items()
                 if st.ewma_step_s > 0}
        if len(times) < 2:
            return []
        med = float(np.median(list(times.values())))
        return [h for h, t in times.items()
                if t > self.tolerance * max(med, 1e-9)]


@dataclasses.dataclass
class ElasticPlan:
    """Restart plan when capacity changes from n_old to n_new chips."""
    n_old: int
    n_new: int
    data_axis: int
    model_axis: int

    @staticmethod
    def plan(n_new: int, *, model_axis: int = 16,
             min_data: int = 1) -> "ElasticPlan":
        """Keep the model axis fixed (the weights' sharding must still
        divide), flex the data axis; refuse meshes that cannot hold the
        model."""
        if n_new % model_axis != 0:
            # degrade the model axis to the largest power-of-two divisor
            m = model_axis
            while m > 1 and n_new % m:
                m //= 2
            model_axis = m
        data = n_new // model_axis
        if data < min_data:
            raise ValueError(f"{n_new} chips cannot hold the job "
                             f"(need >= {min_data * model_axis})")
        return ElasticPlan(0, n_new, data, model_axis)

    def mesh_shape(self):
        return (self.data_axis, self.model_axis)


def recovery_cost_model(ckpt_every_steps: int, step_s: float,
                        restore_s: float, mtbf_hours: float,
                        n_hosts: int) -> Dict[str, float]:
    """Expected overhead of the checkpoint/restart policy at scale: the
    checkpoint interval is chosen from this."""
    failures_per_hour = n_hosts / max(mtbf_hours, 1e-9)
    lost_per_failure = ckpt_every_steps / 2 * step_s + restore_s
    lost_frac = failures_per_hour * lost_per_failure / 3600.0
    ckpt_frac = 0.0  # async saves overlap compute; host IO off the path
    return dict(failures_per_hour=failures_per_hour,
                expected_lost_frac=lost_frac + ckpt_frac,
                lost_s_per_failure=lost_per_failure)
