"""The port's chaos harness (``repro_torch.faults.chaos.run_chaos``) on the
CPU, against the JAX package's.

The ``chaos``-marked tests (``pytest -m chaos``) mirror
``tests/test_chaos.py`` on the port: the standard 6-cycle schedule with
a fault at every required site, the four invariants, crash recovery,
degradation and rollback, byte-identical reports for one seed; and they
hold the port's control flow to JAX's ``run_chaos`` at the same seed:
the injection log ``(site, occurrence, action)``, the crash and recovery
counts.  The port's negatives are its own stream, so its reports are not
byte-equal to JAX's.

One fast test stays in the default tier: a 3-cycle schedule with a
``train.step`` raise, a ``swap.flip`` raise and a ``snapshot.finalize``
crash.  Torch runs on one thread for the byte-identity checks: with two,
CPU sums can follow the machine's load.
"""
import contextlib
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.faults import (REQUIRED_SITES, FaultSpec, default_specs,
                                run_chaos)
from repro_torch.faults.chaos import _make_delta

torch.set_num_threads(2)

#: the seed matrix; CHAOS_SEEDS shards it, as for tests/test_chaos.py
SEEDS = tuple(int(s) for s in
              os.environ.get("CHAOS_SEEDS", "0,1,2").split(","))


@contextlib.contextmanager
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _port_chaos(seed, path, **kw):
    with _one_torch_thread():
        return run_chaos(seed, snapshot_dir=str(path), device="cpu", **kw)


def _control(rep):
    return dict(injected=rep["injected"], crashes=rep["crashes"],
                recoveries=rep["recoveries"],
                sites_injected=rep["sites_injected"])


# ---------------------------------------------------------------------------
# default tier: a reduced schedule, byte-reproducible
# ---------------------------------------------------------------------------

REDUCED = (
    FaultSpec("train.step", "raise", occurrences=(3,), max_injections=1),
    FaultSpec("swap.flip", "raise", occurrences=(0,), max_injections=1),
    FaultSpec("snapshot.finalize", "crash", occurrences=(2,),
              max_injections=1),
)


def test_reduced_schedule_invariants_and_byte_identical_reports(tmp_path):
    """Cycle 0's burst raises at step 3 (retried), cycle 1's flip raises
    (retried), cycle 2's publish crashes before its rename (recovered
    from version 2); all four invariants hold, and two runs give
    byte-identical reports."""
    kw = dict(cycles=3, specs=REDUCED, steps_per_cycle=5)
    a = _port_chaos(0, tmp_path / "a", **kw)
    b = _port_chaos(0, tmp_path / "b", **kw)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert all(a["invariants"].values()), a["invariants"]
    assert a["sites_injected"] == ["snapshot.finalize", "swap.flip",
                                   "train.step"]
    assert a["crashes"] == 1 and a["recoveries"] == 1
    crashed = [c for c in a["cycle_log"] if c.get("crashed")]
    assert crashed == [dict(cycle=2, crashed=True, site="snapshot.finalize",
                            recovered_version=2)]
    assert a["counters"]["lifecycle.stage_retries"] == 2.0
    assert a["served_versions"] == [1, 2] and a["duplicates"] == 0


# ---------------------------------------------------------------------------
# chaos tier: the mirror of tests/test_chaos.py, held to JAX's control flow
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """One port run per seed (torch on one thread)."""
    return {seed: _port_chaos(seed, tmp_path_factory.mktemp(f"p{seed}"))
            for seed in SEEDS}


@pytest.mark.chaos
@pytest.mark.parametrize("seed", SEEDS)
def test_control_flow_matches_jax_run_chaos(reports, tmp_path, seed):
    from repro.faults.chaos import run_chaos as jax_run_chaos
    j = jax_run_chaos(seed, snapshot_dir=str(tmp_path / "j"))
    assert _control(reports[seed]) == _control(j)
    assert reports[seed]["invariants"] == j["invariants"]


@pytest.mark.chaos
@pytest.mark.parametrize("seed", SEEDS)
def test_all_required_sites_injected(reports, seed):
    rep = reports[seed]
    assert set(rep["sites_injected"]) >= set(REQUIRED_SITES), \
        set(REQUIRED_SITES) - set(rep["sites_injected"])
    assert len(rep["injected"]) == len(default_specs())


@pytest.mark.chaos
@pytest.mark.parametrize("seed", SEEDS)
def test_no_torn_or_corrupt_snapshot_served(reports, seed):
    rep = reports[seed]
    assert rep["invariants"]["no_bad_serve"], \
        (rep["served_versions"], rep["good_versions"])


@pytest.mark.chaos
@pytest.mark.parametrize("seed", SEEDS)
def test_recall_never_below_last_good_floor(reports, seed):
    rep = reports[seed]
    assert rep["invariants"]["recall_floor"], rep["recall_by_served"]


@pytest.mark.chaos
@pytest.mark.parametrize("seed", SEEDS)
def test_exactly_once_events_across_crash_recovery(reports, seed):
    rep = reports[seed]
    assert rep["invariants"]["exactly_once"], \
        f"{rep['duplicates']} duplicated ring events"


@pytest.mark.chaos
@pytest.mark.parametrize("seed", SEEDS)
def test_every_injected_fault_is_traced(reports, seed):
    rep = reports[seed]
    assert rep["invariants"]["all_faults_traced"], rep["injected"]


@pytest.mark.chaos
@pytest.mark.parametrize("seed", SEEDS)
def test_crash_recovery_actually_exercised(reports, seed):
    rep = reports[seed]
    assert rep["crashes"] == 1 and rep["recoveries"] == 1
    crashed = [c for c in rep["cycle_log"] if c.get("crashed")]
    assert crashed and crashed[0]["recovered_version"] in \
        rep["good_versions"]
    assert rep["counters"].get("snapshot.corrupt_detected", 0) >= 1
    assert rep["counters"].get("snapshot.quarantined", 0) >= 1


@pytest.mark.chaos
@pytest.mark.parametrize("seed", SEEDS)
def test_degradation_and_rollback_paths_hit(reports, seed):
    c = reports[seed]["counters"]
    assert c.get("lifecycle.rollbacks", 0) >= 1
    assert c.get("lifecycle.recoveries", 0) >= 1
    assert c.get("lifecycle.stage_retries", 0) >= 1
    assert c.get("swap.ingest_shed_batches", 0) >= 1


@pytest.mark.chaos
def test_report_is_bit_reproducible(tmp_path):
    a = _port_chaos(0, tmp_path / "a")
    b = _port_chaos(0, tmp_path / "b")
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


@pytest.mark.chaos
def test_seeds_differ():
    d0 = _make_delta(0, 1, 0.0, 50, 60)
    d1 = _make_delta(1, 1, 0.0, 50, 60)
    assert not np.array_equal(d0.user_id, d1.user_id)
