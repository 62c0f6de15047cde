"""The port's trace renderer (``repro_torch.obs.report``) against the JAX
package's: the same telemetry, written once through the JAX package's
``Telemetry`` and once through the port's (``FixedClock``, ``JsonlSink``),
gives byte-equal JSONL, and either renderer turns either file into the
same text.  Then the renderer's own behaviour, as ``tests/test_obs.py``
pins it for the JAX renderer: nesting, the metric summary over several
files, garbage lines, ``main``; and a port chaos run's trace rendered by
both."""
import numpy as np
import pytest
import torch

import repro.obs as JO
import repro.obs.report as JR
import repro_torch.obs as PO
import repro_torch.obs.report as PR
from repro_torch.faults import FaultSpec, run_chaos

torch.set_num_threads(2)


def _emit(obs, path, seed=0):
    """A trace with nested spans and attributes, an exception, counters,
    gauges and a histogram, written through ``obs``'s telemetry."""
    clock = obs.FixedClock()
    tel = obs.Telemetry(sink=obs.JsonlSink(str(path)), clock=clock)
    rng = np.random.default_rng(seed)
    for cycle in range(3):
        with tel.span("lifecycle.cycle", cycle=cycle):
            with tel.span("lifecycle.train", steps=10):
                clock.advance(float(rng.random()))
            with tel.span("lifecycle.swap", to_version=cycle + 1):
                for name in ("swap.build", "swap.replay", "swap.flip"):
                    with tel.span(name):
                        clock.advance(float(rng.random()) * 1e-3)
            try:
                with tel.span("lifecycle.publish"):
                    clock.advance(2.5)
                    raise ValueError("gate")
            except ValueError:
                pass
        tel.counter("serving.seqlock_retries", float(cycle + 1))
        tel.counter("swap.replayed_events", 100.0 * cycle)
        tel.gauge("serving.queue_depth_max", float(rng.integers(0, 256)))
        for v in rng.random(40) * 1e-2:
            tel.observe("serving.retrieve_latency_s", float(v))
    tel.flush()
    return str(path)


@pytest.mark.parametrize("seed", range(2))
def test_both_packages_write_and_render_the_same_trace(tmp_path, seed):
    jp = _emit(JO, tmp_path / "jax.jsonl", seed)
    pp = _emit(PO, tmp_path / "port.jsonl", seed)
    with open(jp, "rb") as a, open(pp, "rb") as b:
        assert a.read() == b.read()
    text = JR.render([jp])
    assert "\n  lifecycle.train" in text and "\n    swap.flip" in text
    for renderer in (JR, PR):
        for p in (jp, pp):
            assert renderer.render([p]) == text
    assert PR.render([jp, pp]) == JR.render([pp, jp]) \
        .replace("port.jsonl", "jax.jsonl")
    assert PR.span_paths(PR.load_records([pp])) == \
        JR.span_paths(JR.load_records([jp]))


def test_metric_summary_merges_files_and_skips_garbage(tmp_path):
    p1 = _emit(PO, tmp_path / "a.jsonl")
    p2 = _emit(PO, tmp_path / "b.jsonl", seed=1)
    with open(p2, "a") as fh:
        fh.write("not json\n\n{\"type\":\"counter\",\"name\":\"x\","
                 "\"value\":1,\"t_wall\":0}\n")
    counters, gauges, hists = PR.metric_summary(PR.load_records([p1, p2]))
    jc, jg, jh = JR.metric_summary(JR.load_records([p1, p2]))
    assert counters == jc and gauges == jg
    assert counters["serving.seqlock_retries"] == 2 * 6.0
    assert counters["x"] == 1
    assert hists["serving.retrieve_latency_s"].n == 240
    assert hists.keys() == jh.keys()
    for name, h in hists.items():
        assert h.to_dict() == jh[name].to_dict()
    assert PR.fmt_s(2e-6) == "2.00us" and PR.fmt_s(0.25) == "250.00ms" \
        and PR.fmt_s(3.0) == "3.000s"


def test_main_prints_the_report_and_returns_zero(tmp_path, capsys):
    p = _emit(PO, tmp_path / "t.jsonl")
    assert PR.main([p]) == 0
    out = capsys.readouterr().out
    assert "span tree" in out and "== histograms ==" in out
    assert out == PR.render([p]) + "\n"


def test_a_port_chaos_trace_renders_the_same_in_both(tmp_path):
    """``run_chaos(trace_path=)`` writes the run's trace; both renderers
    give the same text, with the lifecycle stages under each cycle and
    the injected faults counted."""
    trace = tmp_path / "chaos.jsonl"
    specs = (FaultSpec("swap.flip", "raise", occurrences=(0,),
                       max_injections=1),)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rep = run_chaos(0, snapshot_dir=str(tmp_path / "snaps"), cycles=2,
                        specs=specs, steps_per_cycle=2, device="cpu",
                        trace_path=str(trace))
    finally:
        torch.set_num_threads(n)
    assert all(rep["invariants"].values())
    text = PR.render([str(trace)])
    assert text == JR.render([str(trace)])
    for name in ("lifecycle.cycle", "\n  lifecycle.publish",
                 "\n  lifecycle.swap", "\n    swap.build",
                 "faults.injected"):
        assert name in text, name
