"""The port's telemetry, fault injection and checkpointer against the JAX
package's (``repro/obs``, ``repro/faults``, ``repro/checkpoint``):

  * the same telemetry calls give the same JSONL records, byte for byte
    under a ``FixedClock``, and the same merged metrics;
  * the same ``FaultPlan`` fires at the same occurrences with the same
    actions, and ``corrupt_file`` flips the same bytes;
  * the port's ``Checkpointer`` round-trips its ``TrainState``
    (parameters, optimizer state, RQ ring buffers, pool, step) bitwise,
    bf16 leaves included, sweeps ``.tmp`` partials, keeps ``keep``
    versions, detects bit rot and writes a final save on preemption.
"""
import dataclasses
import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

from repro import faults as JF
from repro import obs as JO
from repro_torch import faults as PF
from repro_torch import obs as PO
from repro_torch.checkpoint import CheckpointCorruptError, Checkpointer
from repro_torch.checkpoint.checkpointer import flatten

torch.set_num_threads(2)


def _script(O, tel):
    """One fixed sequence of telemetry calls through package ``O``."""
    with tel.span("lifecycle.cycle", cycle=0) as cyc:
        tel.counter("train.steps", 3.0)
        with tel.span("lifecycle.train", steps=3) as sp:
            for v in (1e-6, 3e-4, 0.02, 0.02, 5.0):
                tel.observe("train.step_latency_s", v)
            sp.set("resets", 2)
        with tel.span("lifecycle.publish", version=1) as sp:
            tel.gauge("publish.recall_ratio", 0.93)
            tel.gauge("publish.recall_ratio", 0.97)
            sp.set("gate_passed", True)
        try:
            with tel.span("lifecycle.swap", to_version=1):
                raise ValueError("flip refused")
        except ValueError:
            pass
        cyc.set("elapsed", cyc.elapsed())
    th = threading.Thread(target=lambda: tel.counter("train.steps"))
    th.start()
    th.join()
    tel.counter("serving.retrieve_requests")
    tel.flush()


def _run(O):
    sink = O.MemorySink()
    tel = O.Telemetry(sink=sink, clock=O.FixedClock())
    _script(O, tel)
    return sink.lines, tel.snapshot(), tel.percentiles(
        "train.step_latency_s")


def test_same_calls_give_the_same_jsonl_records():
    lines_j, snap_j, pct_j = _run(JO)
    lines_p, snap_p, pct_p = _run(PO)
    assert lines_p == lines_j                     # byte for byte
    recs = [json.loads(ln) for ln in lines_p]
    assert {r["type"] for r in recs} == {"span", "counter", "gauge", "hist"}
    spans = {r["name"]: r for r in recs if r["type"] == "span"}
    assert set(spans["lifecycle.cycle"]) == {
        "type", "name", "span_id", "parent_id", "thread", "t_wall",
        "dur_s", "attrs"}
    assert spans["lifecycle.swap"]["attrs"]["error"] == "ValueError"
    assert snap_p == snap_j and pct_p == pct_j
    assert snap_p["counters"]["train.steps"] == 4.0


def test_same_calls_with_the_system_clock_agree_but_for_times():
    def run(O):
        sink = O.MemorySink()
        _script(O, O.Telemetry(sink=sink))
        out = []
        for ln in sink.lines:
            r = json.loads(ln)
            r.pop("t_wall")
            r.pop("dur_s", None)
            r.get("attrs", {}).pop("elapsed", None)
            out.append(r)
        return out

    assert run(PO) == run(JO)


def test_jsonl_sink_rotates_the_same_files(tmp_path):
    for O, d in ((JO, tmp_path / "j"), (PO, tmp_path / "p")):
        sink = O.JsonlSink(str(d / "t.jsonl"), max_bytes=300, max_files=3)
        tel = O.Telemetry(sink=sink, clock=O.FixedClock())
        for i in range(12):
            with tel.span("s", i=i):
                pass
        tel.flush()
        sink.close()
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "p")) and len(names) == 3
    for n in names:
        assert ((tmp_path / "j" / n).read_bytes()
                == (tmp_path / "p" / n).read_bytes())


def test_module_singletons_configure_in_place():
    tel = PO.get_telemetry()
    assert tel is PO.get_telemetry() and not tel.enabled
    sink = PO.MemorySink()
    try:
        PO.configure(sink=sink, clock=PO.FixedClock())
        with PO.span("x"):
            PO.counter("c")
        PO.gauge("g", 2.0)
        PO.observe("h", 1e-3)
        assert PO.snapshot()["counters"] == {"c": 1.0}
        PO.flush()
        assert [json.loads(ln)["type"] for ln in sink.lines] == [
            "span", "counter", "gauge", "hist"]
    finally:
        PO.configure(enabled=False)
        tel.reset_metrics()


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------

def _specs(F):
    return [F.FaultSpec("swap.flip", "raise", occurrences=(1, 3)),
            F.FaultSpec("train.step", "crash", occurrences=(4,)),
            F.FaultSpec("ring.push", "raise", prob=0.3, max_injections=5),
            F.FaultSpec("gate.eval", "delay", prob=0.5, delay_s=0.25),
            F.FaultSpec("snapshot.load", "corrupt", occurrences=(0, 2))]


SITES = ("swap.flip", "train.step", "ring.push", "gate.eval",
         "snapshot.load", "health.post_swap")


def _fire_all(F, tmp_path, tag):
    sleeps = []
    sink_tel = JO if F is JF else PO
    tel = sink_tel.Telemetry(sink=sink_tel.MemorySink(),
                             clock=sink_tel.FixedClock())
    plan = F.FaultPlan(7, _specs(F), telemetry=tel, sleep=sleeps.append)
    inj = F.FaultInjector()
    assert not inj.active and inj.fire("swap.flip") is None
    inj.install(plan)
    path = tmp_path / f"{tag}.bin"
    path.write_bytes(bytes(range(256)) * 4)
    outcome = []
    for n in range(40):
        site = SITES[(n * 7) % len(SITES)]
        try:
            spec = inj.fire(site, path=str(path))
            outcome.append((site, None if spec is None else spec.action))
        except F.InjectedCrash as e:
            outcome.append((site, "crash", e.occurrence))
        except F.InjectedFault as e:
            outcome.append((site, "raise", e.occurrence))
    occ = {s: plan.occurrence(s) for s in SITES}
    return (outcome, plan.log, sleeps, occ, path.read_bytes(),
            tel.snapshot()["counters"])


def test_same_fault_plan_fires_at_the_same_occurrences(tmp_path):
    j = _fire_all(JF, tmp_path, "j")
    p = _fire_all(PF, tmp_path, "p")
    assert p == j
    outcome, log = p[0], p[1]
    assert {o[1] for o in outcome} >= {None, "raise", "crash", "delay",
                                        "corrupt"}
    assert len(log) == sum(o[1] is not None for o in outcome)
    with pytest.raises(ValueError, match="unknown fault action"):
        PF.FaultSpec("x", "explode")


def test_global_injector_install_and_clear():
    plan = PF.FaultPlan(0, [PF.FaultSpec("x", "raise", occurrences=(0,))],
                        telemetry=PO.Telemetry(enabled=False))
    try:
        assert PF.install_plan(plan) is plan
        assert PF.get_faults().active
        with pytest.raises(PF.InjectedFault, match="injected raise at x#0"):
            PF.get_faults().fire("x")
    finally:
        PF.clear_plan()
    assert not PF.get_faults().active


@pytest.mark.parametrize("size", [0, 100, 257, 5000])
def test_corrupt_file_flips_the_same_bytes(tmp_path, size):
    data = np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    out = {}
    for name, F in (("j", JF), ("p", PF)):
        f = tmp_path / name
        f.write_bytes(data)
        n = F.corrupt_file(str(f), (3, size), n_bytes=8)
        out[name] = (n, f.read_bytes())
    assert out["p"] == out["j"]
    if size:
        assert out["p"][0] > 0 and out["p"][1] != data
        if size > 256:              # the .npy header region is spared
            assert out["p"][1][:128] == data[:128]


# ---------------------------------------------------------------------------
# checkpointer on the port's TrainState
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained_state(tiny_world, tiny_cfg):
    """The port's TrainState after a 4-step burst on the tiny world (the
    RQ ring buffers, pool, moments and step have all moved)."""
    import repro_torch.core.graph_builder as GB
    from repro_torch.data.edge_dataset import build_neighbor_tables
    from repro_torch.lifecycle import LifecycleConfig, LifecycleRuntime
    from test_torch_lifecycle import port_cfg
    g = GB.build_graph(tiny_world.day0, k_cap=16, hub_cap=12,
                       keep_state=True)
    tables = build_neighbor_tables(g, k_imp=10, n_walks=12, walk_len=3,
                                   backend="numpy", device="cpu",
                                   keep_state=True)
    rt = LifecycleRuntime(port_cfg(tiny_cfg), LifecycleConfig(
        steps_per_cycle=4, batch_per_type=8), g, tables,
        tiny_world.user_feat, tiny_world.item_feat, seed=0, device="cpu")
    rt.train_burst()
    return rt.state


def _assert_same_tree(a, b):
    la, da = flatten(a)
    lb, db = flatten(b)
    assert da == db and len(la) == len(lb)
    for x, y in zip(la, lb):
        assert type(x) is type(y) or (isinstance(x, torch.Tensor)
                                      and isinstance(y, torch.Tensor))
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device
            assert torch.equal(x, y)
        else:
            assert x == y


def test_train_state_roundtrip_bitwise(tmp_path, trained_state):
    st = trained_state
    assert st.step == 4 and st.rq_state.ptr == 4
    assert any(float(h.sum()) > 0 for h in st.rq_state.hists)
    assert st.opt_state["false"].count == 4
    ck = Checkpointer(str(tmp_path))
    ck.save(st.step, st, metadata=dict(seed=0))
    leaves, treedef = flatten(st)
    meta = ck.verify_step(4)
    assert meta["n_leaves"] == len(leaves) and meta["treedef"] == treedef
    assert meta["seed"] == 0 and len(meta["leaf_sha256"]) == len(leaves)
    back, meta2 = ck.restore(st)
    assert meta2["step"] == 4
    _assert_same_tree(back, st)
    assert back.params is not st.params
    names = dict(back.params.named_parameters())
    assert all(p.requires_grad for p in names.values())
    # restoring into a zeroed state gives the saved values back
    zero = dataclasses.replace(
        st, rq_state=dataclasses.replace(
            st.rq_state, hists=tuple(torch.zeros_like(h)
                                     for h in st.rq_state.hists), ptr=0),
        step=0)
    back2, _ = ck.restore(zero)
    _assert_same_tree(back2, st)


def test_bf16_leaves_roundtrip_bitwise(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(5, 7, generator=g).to(torch.bfloat16),
            "b": torch.randn(7, generator=g),
            "n": 3, "x": 0.5, "codes": np.arange(4, dtype=np.int32),
            "none": None}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree)
    with open(tmp_path / "step_1" / "manifest.json") as f:
        meta = json.load(f)
    leaves, _ = flatten(tree)
    i = next(k for k, l in enumerate(leaves) if isinstance(l, torch.Tensor)
             and l.dtype == torch.bfloat16)
    assert meta["bf16_leaves"] == [i]
    raw = np.load(tmp_path / "step_1" / f"{i:06d}.npy")
    assert raw.dtype == np.uint16
    back, _ = ck.restore(tree)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16),
                       tree["w"].view(torch.int16))
    assert torch.equal(back["b"], tree["b"])
    assert back["n"] == 3 and back["x"] == 0.5 and back["none"] is None
    np.testing.assert_array_equal(back["codes"], tree["codes"])


def test_retention_latest_sweep_and_async(tmp_path, trained_state):
    ck = Checkpointer(str(tmp_path), keep=2)
    small = {"rq": trained_state.rq_state}
    for s in (1, 2, 3):
        ck.save(s, small, blocking=(s != 2))
        ck.wait()
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    os.makedirs(tmp_path / "step_9.tmp")
    (tmp_path / "latest.tmp").write_text("9")
    assert sorted(ck.sweep_partials()) == ["latest.tmp", "step_9.tmp"]
    os.makedirs(tmp_path / "step_8.tmp")
    Checkpointer(str(tmp_path), keep=2)         # opening sweeps too
    assert sorted(os.listdir(tmp_path)) == ["latest", "step_2", "step_3"]
    with pytest.raises(ValueError, match="incompatible trees"):
        ck.restore({"rq": trained_state.rq_state, "extra": torch.zeros(1)})


def test_bit_rot_and_crash_mid_write_are_detectable(tmp_path):
    tree = {"a": torch.arange(64, dtype=torch.float32),
            "b": torch.ones(300)}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree)
    PF.corrupt_file(str(tmp_path / "step_1" / "000001.npy"), (0,))
    with pytest.raises(CheckpointCorruptError, match="leaf 1 checksum"):
        ck.verify_step(1)
    os.remove(tmp_path / "step_1" / "000000.npy")
    with pytest.raises(CheckpointCorruptError, match="leaf 0 missing"):
        ck.verify_step(1)
    plan = PF.FaultPlan(0, [PF.FaultSpec("snapshot.finalize", "crash",
                                         occurrences=(0,))],
                        telemetry=PO.Telemetry(enabled=False))
    ck2 = Checkpointer(str(tmp_path / "c"), faults=PF.FaultInjector(plan))
    with pytest.raises(PF.InjectedCrash):
        ck2.save(5, tree)
    assert ck2.latest_step() is None
    assert "step_5.tmp" in os.listdir(tmp_path / "c")
    assert Checkpointer(str(tmp_path / "c")).all_steps() == []
    assert "step_5.tmp" not in os.listdir(tmp_path / "c")


def test_preemption_handler_writes_a_final_checkpoint(tmp_path):
    tree = {"a": torch.arange(4)}
    ck = Checkpointer(str(tmp_path))
    old = signal.getsignal(signal.SIGUSR1)
    try:
        ck.install_preemption_handler(lambda: (7, tree, dict(seed=1)),
                                      sig=signal.SIGUSR1)
        with pytest.raises(SystemExit) as e:
            os.kill(os.getpid(), signal.SIGUSR1)
        assert e.value.code == 143
    finally:
        signal.signal(signal.SIGUSR1, old)
    meta = ck.verify_step(7)
    assert meta["preempted"] is True and meta["seed"] == 1
    back, _ = ck.restore(tree)
    assert torch.equal(back["a"], tree["a"])
