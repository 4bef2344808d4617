"""The port's observability (``repro_torch.obs``, ``launch.report``)
against the reference's (``repro.obs``, ``repro.launch.report``): the 25
cases of ``tests/test_obs.py``, each running the same inputs through both
packages and requiring the same outputs (metrics JSON-lines and
Prometheus text, the tracer's dump with its ring and containment, health
events, gauges and the link-health registry, ``calibration_drift``,
``StepEmulator`` samples, ``trace_timings`` of one gzipped trace,
``ObsSession``'s files, ``report.summarize``'s text) and the reference's
assertions on the port's; plus ``check_obs_metrics`` of
``tests/_mesh_runner.py`` on 4 gloo CPU ranks over (pod, node) = (2, 2)
with ``pod:ib,node:cxl``: every gauge ``from_ledger`` exports reconciles
exactly with the port's ledger snapshot and with the reference's bytes by
level for the same call (the reference in a subprocess).

Times are the only outputs that differ between two runs (a tracer's
timestamps and durations): they are dropped before two dumps are
compared, and the port's are checked for containment as the reference's
test checks its own.  Every other comparison is exact.

Also runnable as a script: ``python tests/test_torch_obs.py --reference
OUT.json`` (the reference's side of the 4-rank check).
"""
import gzip
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MiB = 1 << 20


def _pkg(base: str):
    import importlib
    m = types.SimpleNamespace()
    for attr, mod in (("obs", "obs"), ("metrics", "obs.metrics"),
                      ("trace", "obs.trace"), ("profile", "obs.profile"),
                      ("health", "obs.health"), ("session", "obs.session"),
                      ("ledger", "core.ledger"), ("tuner", "tuner"),
                      ("runtime", "tuner.runtime"),
                      ("costmodel", "tuner.costmodel"),
                      ("topology", "core.topology"),
                      ("report", "launch.report")):
        setattr(m, attr, importlib.import_module(f"{base}.{mod}"))
    m.TOPO = m.topology.parse_topology("pod:ib,node:cxl")
    m.name = base
    return m


@pytest.fixture(scope="module")
def pkgs():
    return _pkg("repro"), _pkg("repro_torch")


def _clean(p) -> None:
    p.trace.disable_tracing()
    p.ledger.reset()
    p.runtime.clear_link_health()


@pytest.fixture(autouse=True)
def _clean_obs_state(pkgs):
    """Tracing hooks, the ledger and the link-health registry are
    process-global in both packages: every case starts and ends clean."""
    for p in pkgs:
        _clean(p)
    yield
    for p in pkgs:
        _clean(p)


def both(pkgs, fn):
    """``fn`` on the reference, then on the port (each package's state
    clean before it runs): (reference's result, port's result)."""
    out = []
    for p in pkgs:
        _clean(p)
        out.append(fn(p))
        _clean(p)
    return tuple(out)


def _untimed(doc: dict) -> dict:
    """A trace document without its timestamps and durations (and the
    samples' measured seconds stay: they are inputs)."""
    evs = [{k: v for k, v in e.items() if k not in ("ts", "dur")}
           for e in doc["traceEvents"]]
    meta = dict(doc["metadata"])
    meta["anomalies"] = [{k: v for k, v in a.items() if k != "ts"}
                         for a in meta.get("anomalies", [])]
    return {**doc, "traceEvents": evs, "metadata": meta}


def _book(p, seconds=1e-3, *, primitive="all_gather", backend="cxl",
          level="node", fabric="cxl", calls=1.0):
    p.ledger.record_timing(primitive, 1 * MiB, 4, backend, seconds,
                           slicing_factor=4, allreduce_mode="two_phase",
                           level=level, fabric=fabric, calls=calls)


def _sample(seconds, *, primitive="all_gather", backend="cxl",
            level="node", fabric="cxl", calls=1.0, msg_bytes=1 * MiB,
            nranks=4):
    return {"primitive": primitive, "msg_bytes": msg_bytes,
            "nranks": nranks, "backend": backend, "slicing_factor": 4,
            "allreduce_mode": "two_phase", "level": level,
            "fabric": fabric, "seconds": float(seconds),
            "calls": float(calls)}


# -- tracer / flight recorder ---------------------------------------------

def test_tracer_ring_buffer_keeps_last_steps(pkgs):
    def run(p):
        tr = p.trace.Tracer(capacity_steps=4)
        tr.enabled = True
        for i in range(10):
            with tr.step(i):
                tr.instant("tick")
        return tr.steps_retained(), tr.dump()
    (r_steps, r_doc), (steps, doc) = both(pkgs, run)
    assert steps == r_steps == [6, 7, 8, 9]
    assert _untimed(doc) == _untimed(r_doc)
    assert [e["args"]["step"] for e in doc["traceEvents"]
            if e.get("cat") == "step"] == [6, 7, 8, 9]
    assert doc["metadata"]["capacity_steps"] == 4


def test_tracer_span_nesting_and_containment(pkgs):
    def run(p):
        tr = p.trace.Tracer()
        tr.enabled = True
        with tr.step(0):
            with tr.span("gather", phase="fwd"):
                with tr.span("inner"):
                    pass
        return tr.dump()
    r_doc, doc = both(pkgs, run)
    assert _untimed(doc) == _untimed(r_doc)
    by_name = {e["name"]: e for e in doc["traceEvents"]
               if e.get("ph") == "X"}
    step, outer, inner = (by_name["step 0"], by_name["gather"],
                          by_name["inner"])
    assert outer["args"] == {"phase": "fwd"}
    for parent, child in ((step, outer), (outer, inner)):
        assert parent["ts"] <= child["ts"]
        assert (child["ts"] + child["dur"]
                <= parent["ts"] + parent["dur"] + 1e-6)


def test_tracer_ledger_hook_bridges_collectives(pkgs):
    def run(p):
        tr = p.trace.enable_tracing(capacity_steps=8)
        with tr.step(3):
            _book(p, 2e-3, calls=2.0)
        doc = tr.dump()
        p.trace.disable_tracing()
        _book(p)
        return doc, tr.dump()
    (r_doc, r_after), (doc, after) = both(pkgs, run)
    assert _untimed(doc) == _untimed(r_doc)
    coll = [e for e in doc["traceEvents"] if e.get("cat") == "collective"]
    assert len(coll) == 1
    assert coll[0]["name"] == "all_gather@cxl [node]"
    assert coll[0]["dur"] == pytest.approx(2e3)
    assert coll[0]["args"]["calls"] == 2.0 and coll[0]["args"]["step"] == 3
    # a disabled tracer stops receiving (hook detached)
    assert _untimed(after) == _untimed(r_after)
    assert sum(e.get("cat") == "collective"
               for e in after["traceEvents"]) == 1


def test_enable_tracing_twice_does_not_duplicate_hook(pkgs):
    def run(p):
        p.trace.enable_tracing()
        tr2 = p.trace.enable_tracing()
        with tr2.step(0):
            _book(p)
        return tr2.dump()
    r_doc, doc = both(pkgs, run)
    assert _untimed(doc) == _untimed(r_doc)
    assert sum(e.get("cat") == "collective"
               for e in doc["traceEvents"]) == 1


def test_tracer_trigger_dumps_anomaly(pkgs, tmp_path):
    def run(p):
        tr = p.trace.enable_tracing(capacity_steps=4)
        with tr.step(0):
            pass
        out = str(tmp_path / f"flight_{p.name}.json")
        tr.trigger("link node/cxl degraded", out)
        with open(out) as f:
            return tr.dumps, json.load(f)
    (r_n, r_doc), (n, doc) = both(pkgs, run)
    assert n == r_n == 1
    assert _untimed(doc) == _untimed(r_doc)
    assert doc["metadata"]["anomalies"][0]["reason"] == \
        "link node/cxl degraded"
    marks = [e for e in doc["traceEvents"] if e.get("cat") == "anomaly"]
    assert marks and marks[0]["ph"] == "i"


# -- metrics registry ------------------------------------------------------

def test_counter_gauge_histogram_basics(pkgs):
    def run(p):
        reg = p.metrics.MetricsRegistry()
        c = reg.counter("repro_steps_total", "steps")
        c.inc()
        c.inc(2.0, phase="fwd")
        with pytest.raises(ValueError):
            c.inc(-1.0)
        g = reg.gauge("repro_plan_epoch")
        g.set(3)
        g.add(2)
        h = reg.histogram("repro_step_seconds", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        with pytest.raises(TypeError):
            reg.gauge("repro_steps_total")
        assert reg.counter("repro_steps_total") is c
        return (reg.value("repro_steps_total"),
                reg.value("repro_steps_total", phase="fwd"),
                reg.value("repro_plan_epoch"), h.samples(),
                reg.to_jsonl(), reg.to_prometheus())
    ref, got = both(pkgs, run)
    assert got == ref
    assert got[:3] == (1.0, 2.0, 5.0)
    samples = {(n, k): v for n, k, v in got[3]}
    assert samples[("repro_step_seconds_bucket", (("le", "1"),))] == 2
    assert samples[("repro_step_seconds_bucket", (("le", "+Inf"),))] == 3
    assert samples[("repro_step_seconds_sum", ())] == pytest.approx(5.55)


def test_prometheus_and_jsonl_export(pkgs):
    def run(p):
        reg = p.metrics.MetricsRegistry()
        reg.counter("repro_x_total", "help text").inc(3, kind="ag")
        reg.histogram("repro_t_seconds", buckets=(1.0,)).observe(0.5)
        return reg.to_prometheus(), reg.to_jsonl()
    ref, (text, jsonl) = both(pkgs, run)
    assert (text, jsonl) == ref
    assert 'repro_x_total{kind="ag"} 3' in text
    assert 'repro_t_seconds_bucket{le="+Inf"} 1' in text
    assert {"name": "repro_x_total", "type": "counter",
            "labels": {"kind": "ag"}, "value": 3.0} in \
        [json.loads(ln) for ln in jsonl.splitlines()]


def test_from_ledger_reconciles_with_snapshot(pkgs):
    snap = {
        "wire_bytes": {"all_gather": 1024.0, "all_reduce": 2048.0},
        "exposed_bytes": {"all_gather": 256.0},
        "hidden_bytes": {"all_gather": 768.0},
        "collective_calls": {"all_gather": 4.0},
        "level_wire_bytes": {"node/cxl": {"all_gather": 1024.0}},
    }

    def run(p):
        reg = p.metrics.MetricsRegistry()
        p.metrics.from_ledger(reg, snap)
        once = reg.to_jsonl()
        p.metrics.from_ledger(reg, snap)       # gauges: overwrite
        return once, reg.to_jsonl(), reg.value(
            "repro_level_wire_bytes", level="node", fabric="cxl",
            kind="all_gather")
    ref, got = both(pkgs, run)
    assert got == ref
    assert got[0] == got[1] and got[2] == 1024.0


def test_observe_timings_histogram_and_busy_counter(pkgs):
    timings = [_sample(1e-3, calls=2.0),
               _sample(2e-3, primitive="all_reduce", backend="ring",
                       level="pod", fabric="ib")]

    def run(p):
        reg = p.metrics.MetricsRegistry()
        n = p.metrics.observe_timings(reg, timings)
        return n, reg.to_jsonl(), reg.value(
            "repro_level_busy_seconds_total", level="node", fabric="cxl")
    ref, got = both(pkgs, run)
    assert got == ref
    assert got[0] == 2 and got[2] == pytest.approx(2e-3)


# -- trace parsing + emulator -----------------------------------------------

def test_classify_hlo_names(pkgs):
    names = ("all-reduce.3", "AllGather_7", "reduce-scatter.0",
             "all-to-all.1", "collective-permute.5", "fusion.12")
    ref, got = both(pkgs, lambda p: [p.profile.classify(n) for n in names])
    assert got == ref
    assert got == [(True, "all_reduce"), (True, "all_gather"),
                   (True, "reduce_scatter"), (True, "all_to_all"),
                   (True, None), (False, None)]


def _choices():
    return [
        {"primitive": "all_gather", "msg_bytes": 4 * MiB, "nranks": 4,
         "backend": "cxl", "slicing_factor": 4,
         "allreduce_mode": "two_phase", "level": "node",
         "fabric": "cxl", "calls": 2.0},
        {"primitive": "all_gather", "msg_bytes": 1 * MiB, "nranks": 2,
         "backend": "ring", "slicing_factor": 1,
         "allreduce_mode": "two_phase", "level": "pod", "fabric": "ib",
         "calls": 1.0},
        {"primitive": "all_reduce", "msg_bytes": 1 * MiB, "nranks": 4,
         "backend": "cxl", "slicing_factor": 4,
         "allreduce_mode": "two_phase", "level": "node",
         "fabric": "cxl", "calls": 1.0},
    ]


def test_match_events_walks_expanded_schedule(pkgs):
    events = [{"name": f"all-gather.{i}", "primitive": "all_gather",
               "ts_us": 10.0 * i, "dur_us": 5.0 + i} for i in range(4)]
    events.append({"name": "all-reduce.0", "primitive": "all_reduce",
                   "ts_us": 100.0, "dur_us": 7.0})
    events.append({"name": "collective-permute.0", "primitive": None,
                   "ts_us": 200.0, "dur_us": 9.0})
    ref, out = both(pkgs, lambda p: p.profile.match_events(events,
                                                          _choices()))
    assert out == ref
    assert len(out) == 5
    assert [t["backend"] for t in out if t["primitive"] == "all_gather"] \
        == ["cxl", "cxl", "ring", "cxl"]


def test_trace_timings_from_gzipped_chrome_trace(pkgs, tmp_path):
    rng = np.random.default_rng(5)
    evs = [{"ph": "X", "name": name, "ts": float(ts), "dur": float(d)}
           for name, ts, d in zip(
               ["all-reduce.1", "fusion.2", "all-gather.0", "all-gather.3",
                "reduce-scatter.4", "collective-permute.1"],
               rng.uniform(0, 100, 6), rng.uniform(0.5, 20, 6))]
    evs.append({"ph": "M", "name": "process_name"})
    path = str(tmp_path / "t.trace.json.gz")
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": evs}, f)
    ref, out = both(pkgs, lambda p: p.profile.trace_timings(path,
                                                           _choices()))
    assert out == ref
    assert sorted(t["primitive"] for t in out) == \
        ["all_gather", "all_gather", "all_reduce"]


def test_profiled_timings_picks_newest_and_books(pkgs, tmp_path):
    nested = tmp_path / "prof" / "plugins" / "profile" / "run1"
    nested.mkdir(parents=True)
    with open(nested / "host.trace.json", "w") as f:
        json.dump({"traceEvents": [
            {"ph": "X", "name": "all-reduce.0", "ts": 0.0, "dur": 4.0}]}, f)

    def run(p):
        out = p.profile.profiled_timings(str(tmp_path / "prof"),
                                         _choices(), book=True)
        booked = p.ledger.snapshot()["timings"]
        empty = p.profile.profiled_timings(str(tmp_path / "nope"),
                                           _choices())
        return out, booked, empty
    ref, got = both(pkgs, run)
    assert got == ref
    assert len(got[1]) == 1 and got[1][0]["seconds"] == pytest.approx(4e-6)
    assert got[2] == []


def test_step_emulator_prices_with_level_oracle(pkgs):
    def run(p):
        emu = p.profile.StepEmulator(topology=p.TOPO, noise_std=0.0,
                                     seed=0)
        c = _choices()[0]
        want = p.costmodel.predict_level_time(
            p.TOPO.level_for("node"), "all_gather", 4, 4 * MiB,
            backend="cxl", slicing_factor=4, allreduce_mode="two_phase")
        t0 = emu.time_choice(c)
        emu.set_degrade("node", 4.0)
        emu.set_degrade("cxl", 2.0)
        emu.set_degrade("*", 0.5)
        t1 = emu.time_choice(c)
        emu.set_degrade("node", 1.0)
        samples = emu.step_timings(_choices())
        return want, t0, t1, sorted(emu.degrade.items()), samples, \
            p.ledger.snapshot()["timings"]
    ref, got = both(pkgs, run)
    assert got == ref
    want, t0, t1 = got[:3]
    assert t0 == pytest.approx(want) and t1 == pytest.approx(want * 4.0)
    assert "node" not in dict(got[3])
    assert [t["calls"] for t in got[4]] == [2.0, 1.0, 1.0]
    assert len(got[5]) == 3


def test_step_emulator_noise_is_seeded(pkgs):
    def run(p):
        emu = p.profile.StepEmulator(topology=p.TOPO, noise_std=0.1, seed=7,
                                     degrade={"node@cxl": 3.0})
        return [emu.time_choice(c) for c in _choices() * 3]
    ref, got = both(pkgs, run)
    assert got == ref
    base = pkgs[1].profile.StepEmulator(topology=pkgs[1].TOPO)
    assert got[0] != pytest.approx(3.0 * base.time_choice(_choices()[0]))


# -- link health -----------------------------------------------------------

def _health_stream(step):
    slow = 8 <= step < 12
    return [_sample(4e-3 if slow else 1e-3),
            _sample(1e-3, primitive="all_reduce", backend="ring",
                    level="pod", fabric="ib")]


def test_health_monitor_flags_and_recovers(pkgs):
    def run(p):
        mon = p.health.HealthMonitor(threshold=2.0, patience=2,
                                     warmup_steps=2, publish=False)
        events = []
        for step in range(20):
            events += mon.observe_step(_health_stream(step), step)
        return events, mon.report(), mon.degraded_links()
    ref, (events, report, degraded) = both(pkgs, run)
    assert (events, report, degraded) == ref
    kinds = [(e["event"], e["link"], e["step"]) for e in events]
    assert ("degraded", "node/cxl", 9) in kinds
    assert any(k[0] == "recovered" for k in kinds)
    assert degraded == []


def test_health_baseline_frozen_while_outlying(pkgs):
    def run(p):
        mon = p.health.HealthMonitor(threshold=2.0, patience=2,
                                     warmup_steps=2, publish=False)
        for step in range(30):
            mon.observe_step([_sample(1e-3 if step < 5 else 5e-3)], step)
        return mon.degraded_links(), mon.report()
    ref, got = both(pkgs, run)
    assert got == ref
    assert got[0] == ["node/cxl"] and got[1]["node/cxl"]["slowdown"] > 2.0


def test_health_exports_gauges_and_registry(pkgs):
    def run(p):
        reg = p.metrics.MetricsRegistry()
        mon = p.health.HealthMonitor(threshold=2.0, patience=1,
                                     warmup_steps=1, registry=reg)
        for step in range(6):
            mon.observe_step([_sample(1e-3 if step < 4 else 9e-3)], step)
        return reg.to_jsonl(), p.runtime.degraded_links(), \
            p.runtime.get_link_health()
    ref, got = both(pkgs, run)
    assert got == ref
    assert got[1] == ["node/cxl"] and got[2]["node/cxl"]["degraded"]


def test_health_ignores_idle_links_and_warmup(pkgs):
    def run(p):
        mon = p.health.HealthMonitor(threshold=2.0, patience=1,
                                     warmup_steps=3, publish=False)
        ev = mon.observe_step([_sample(1e-3)], 0)
        ev += mon.observe_step([_sample(50e-3)], 1)
        return ev, mon.observe_step([], 2), mon.report()
    ref, got = both(pkgs, run)
    assert got == ref
    assert got[0] == [] and got[1] == []


def test_calibration_drift_flags_both_directions(pkgs):
    rng = np.random.default_rng(11)
    cal = {"levels": [
        {"backend": b, "level": lv, "scale": float(s), "samples": float(n)}
        for b, lv, s, n in zip(["cxl", "ring", "ring", "cxl", "ring"],
                               ["1:abc", "0:def", None, "0:def", "1:abc"],
                               [4.0, 1.1, 0.5, *rng.uniform(0.2, 5.0, 2)],
                               rng.integers(1, 20, 5))]}

    def run(p):
        with pytest.raises(ValueError):
            p.health.calibration_drift(cal, threshold=1.0)
        return (p.health.calibration_drift(cal, threshold=1.5),
                p.health.calibration_drift(cal, threshold=3.0),
                p.health.calibration_drift({}, threshold=1.5))
    ref, got = both(pkgs, run)
    assert got == ref
    assert [(h["backend"], h["scale"]) for h in got[0]][:2] == \
        [("cxl", 4.0), ("ring", 0.5)]


# -- tuner calibration: learn -> persist -> warm-start ---------------------

def test_calibration_learns_persists_and_warm_starts(pkgs):
    from repro.core.hw import TPU_V5E
    rp, pp = pkgs
    ref_plan = rp.tuner.generate_plan(rp.tuner.TuneGrid(
        primitives=("all_gather",), sizes=(1 * MiB,), nranks=(4,),
        slicing_factors=(4,), allreduce_modes=("two_phase",)))
    roof = dict(peak_flops=TPU_V5E.peak_flops_bf16, hbm_bw=TPU_V5E.hbm_bw)

    def run(p):
        plan = p.tuner.Plan.from_json(ref_plan.to_json())
        kw = roof if p is pp else {}
        ch = plan.lookup("all_gather", 1 * MiB, 4)
        oracle = p.costmodel.predict_time(
            ch.backend, "all_gather", 4, 1 * MiB,
            slicing_factor=ch.slicing_factor,
            allreduce_mode=ch.allreduce_mode)
        ot = p.tuner.OnlineTuner(plan, min_samples=2, **kw)
        scales = []
        for _ in range(2):
            ot.observe("all_gather", 1 * MiB, 4, ch.backend, 4.0 * oracle,
                       slicing_factor=ch.slicing_factor,
                       allreduce_mode=ch.allreduce_mode)
            scales.append(ot.cal_scale(ch.backend, None, "all_gather"))
        refreshed = ot.refresh()
        ot2 = p.tuner.OnlineTuner(refreshed, min_samples=2, **kw)
        return (scales, ot.calibration_export(), refreshed.to_json(),
                ot2.cal_scale(ch.backend, None, "all_gather"))
    ref, got = both(pkgs, run)
    assert got == ref
    assert got[0][0] == 1.0 and got[0][1] == pytest.approx(4.0, rel=1e-6)
    assert got[2]["meta"]["calibration"]["scales"]
    assert got[3] == pytest.approx(4.0, rel=1e-6)


# -- ObsSession end-to-end -------------------------------------------------

def _session_run(p, tmp_path, slow_from=6, steps=8):
    d = tmp_path / p.name
    d.mkdir()
    metrics_out, trace_out = str(d / "run.jsonl"), str(d / "run.trace.json")
    sess = p.obs.ObsSession(metrics_out=metrics_out, trace_out=trace_out,
                            trace_steps=8, threshold=2.0, patience=1,
                            warmup_steps=2, log=lambda *_: None)
    for step in range(steps):
        with sess.step_span(step):
            with sess.span("sync", phase="bwd"):
                _book(p, 8e-3 if step >= slow_from else 1e-3)
        sess.on_step(step, 0.01, timings=p.ledger.snapshot()["timings"],
                     extra={"loss": 2.5})
        p.ledger.clear_timings()
    sess.on_retune(epoch=2, swapped=True, regret_s=1.5e-4,
                   measured_cells=3)
    summary = sess.finalize(snapshot=p.ledger.snapshot(),
                            extra={"steps": steps})
    again = sess.finalize()
    with open(metrics_out) as f, open(str(d / "run.prom")) as g, \
            open(trace_out) as h:
        return summary, again, f.read(), g.read(), json.load(h)


def test_obs_session_end_to_end(pkgs, tmp_path):
    ref, got = both(pkgs, lambda p: _session_run(p, tmp_path))
    summary, again, jsonl, prom, doc = got
    assert (summary, again, jsonl, prom) == ref[:4]
    assert _untimed(doc) == _untimed(ref[4])
    assert summary["degraded_links"] == ["node/cxl"] and again == {}
    events = pkgs[1].report.load_events(str(tmp_path / "repro_torch"
                                            / "run.jsonl"))
    assert {"step", "retune", "health", "metric", "summary"} <= \
        {e["kind"] for e in events}
    assert "repro_steps_total 8" in prom
    assert doc["metadata"]["anomalies"]
    assert any(e.get("cat") == "collective" for e in doc["traceEvents"])


def test_obs_session_disabled_is_inert(pkgs, tmp_path):
    def run(p):
        sess = p.obs.ObsSession(log=lambda *_: None)
        with sess.step_span(0):
            with sess.span("x"):
                pass
        return (sess.enabled, sess.on_step(0, 0.1, timings=[_sample(1.0)]),
                sess.on_retune(epoch=1, swapped=False), sess.finalize())
    ref, got = both(pkgs, run)
    assert got == ref == (False, [], None, {})
    assert list(tmp_path.iterdir()) == []


# -- report CLI ------------------------------------------------------------

def test_report_summarize(pkgs, tmp_path):
    def run(p):
        metrics_out = str(tmp_path / f"{p.name}.jsonl")
        sess = p.obs.ObsSession(metrics_out=metrics_out, threshold=2.0,
                                patience=1, warmup_steps=2,
                                log=lambda *_: None)
        for step in range(6):
            t = [_sample(6e-3 if step >= 4 else 1e-3, calls=2.0)]
            sess.on_step(step, 0.5 if step == 0 else 0.01, timings=t)
        sess.finalize(snapshot={"wire_bytes": {"all_gather": 4096.0}})
        # each package's report of each package's file
        return [q.report.summarize(q.report.load_events(metrics_out))
                for q in pkgs]
    ref, got = both(pkgs, run)
    assert got == ref and len(set(got)) == 1
    text = got[0]
    assert "steps: 6" in text
    assert "health: link node/cxl degraded" in text
    assert "trace-time wire bytes/step" in text


def test_obs_session_diag_routes_to_report(pkgs, tmp_path):
    def run(p):
        metrics_out = str(tmp_path / f"diag_{p.name}.jsonl")
        logged = []
        sess = p.obs.ObsSession(metrics_out=metrics_out, health=False,
                                log=logged.append)
        sess.diag("serve", "plan loaded but the engine is unsharded")
        sess.finalize()
        events = p.report.load_events(metrics_out)
        # (the session's closing line names its own file)
        return logged[0], events, p.report.summarize(events)
    ref, got = both(pkgs, run)
    assert got == ref
    assert got[0].startswith("[serve] plan loaded")
    assert "diagnostics: 1" in got[2]


def test_report_summarize_trace(pkgs, tmp_path, capsys):
    def run(p):
        tr = p.trace.enable_tracing(capacity_steps=4)
        with tr.step(0):
            _book(p)
        tr.trigger("test anomaly")
        path = str(tmp_path / f"t_{p.name}.json")
        tr.dump(path)
        return path

    r_path, path = both(pkgs, run)
    ref_text = pkgs[0].report.summarize_trace(r_path)
    text = pkgs[1].report.summarize_trace(path)
    # the anomaly's time differs between the runs; the rest is the same
    assert text.split("@")[0] == ref_text.split("@")[0]
    assert text.split(":")[-1] == ref_text.split(":")[-1]
    assert "steps retained [0]" in text and "1 collective slices" in text
    # the port's CLI prints it after the metrics summary
    empty = str(tmp_path / "empty.jsonl")
    open(empty, "w").close()
    pkgs[1].report.main([empty, "--trace", path])
    assert "flight recorder: steps retained [0]" in capsys.readouterr().out


# -- check_obs_metrics on 4 gloo ranks ---------------------------------------

SHAPE = (("pod", 2), ("node", 2))


def _obs_input() -> np.ndarray:
    return np.random.default_rng(23).standard_normal((64, 5)).astype(
        np.float32)


def _topology(base: str):
    """``check_obs_metrics``' two-level topology in package ``base``."""
    import importlib
    topology = importlib.import_module(f"{base}.core.topology")
    hw = importlib.import_module(f"{base}.core.hw")
    return topology.Topology(levels=(
        topology.Level("pod", "ib", ib=hw.InfiniBandConfig(link_bw=12.5e9)),
        topology.Level("node", "cxl",
                       pool=hw.CXLPoolConfig(device_bw=18e9))))


def obs_rank(ctx) -> dict:
    """``check_obs_metrics`` on this rank: a hierarchical AllReduce then
    AllGather over (pod, node) under cxl, its ledger snapshot, and the
    gauges ``from_ledger`` builds from it (as JSON-lines)."""
    import torch

    from repro_torch.core import ledger
    from repro_torch.core.api import Communicator
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.obs import MetricsRegistry, from_ledger
    topo = _topology("repro_torch")
    mesh = make_host_mesh(SHAPE, ctx, pools=True, topology=topo)
    comm = Communicator(backend="cxl", topology=topo, axes=mesh)
    x = torch.from_numpy(np.split(_obs_input(), 4)[ctx.rank].copy())
    ledger.reset()
    out = comm.all_gather(comm.all_reduce(x, ("pod", "node")),
                          ("pod", "node"))
    snap = ledger.snapshot()
    reg = MetricsRegistry()
    from_ledger(reg, snap)
    return {"snap": {k: snap[k] for k in (
        "wire_bytes", "collective_calls", "level_wire_bytes",
        "total_wire_bytes", "exposed_bytes", "hidden_bytes")},
        "jsonl": reg.to_jsonl(), "out": out.numpy()}


def reference_main(out_path: str) -> None:
    """The reference's ``check_obs_metrics`` call over a (2, 2) mesh of
    forced host devices: its ledger snapshot, traced."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.core import ledger
    from repro.core.api import Communicator
    topo = _topology("repro")
    mesh = jax.make_mesh((2, 2), ("pod", "node"))
    comm = Communicator(backend="cxl", topology=topo)
    ledger.reset()
    jax.jit(jax.shard_map(
        lambda a: comm.all_gather(comm.all_reduce(a, ("pod", "node")),
                                  ("pod", "node")),
        mesh=mesh, in_specs=P(("pod", "node")), out_specs=P(),
        check_vma=False)).lower(_obs_input())
    snap = ledger.snapshot()
    with open(out_path, "w") as f:
        json.dump({k: snap[k] for k in ("wire_bytes", "collective_calls",
                                        "level_wire_bytes",
                                        "total_wire_bytes")}, f)


@pytest.fixture(scope="module")
def obs_ranks(tmp_path_factory):
    from repro_torch.launch import ranks
    from repro_torch.launch.mesh import level_groups
    tmp = str(tmp_path_factory.mktemp("torch_obs"))
    ref_path = os.path.join(tmp, "reference.json")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    ref = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                            "--reference", ref_path], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        topo = _topology("repro_torch")
        mine = ranks.spawn(obs_rank, 4, (), device="cpu",
                           partition_bytes=1 << 20,
                           groups=level_groups(SHAPE, topo),
                           timeout_s=120.0)
        log, _ = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log[-3000:]
    with open(ref_path) as f:
        return mine, json.load(f)


def test_obs_metrics_reconcile_on_four_ranks(obs_ranks):
    """Every gauge reconciles exactly with each rank's ledger snapshot
    (per kind, per (level, fabric), launches), the per-level attribution
    partitions the total, the JSON-lines round trip keeps the values,
    and the bytes by level are the reference's for the same call."""
    mine, ref = obs_ranks
    want = np.tile(_obs_input().reshape(4, 16, 5).sum(0), (4, 1))
    for r in mine:
        snap = r["snap"]
        seen = {}
        for line in r["jsonl"].splitlines():
            rec = json.loads(line)
            seen[(rec["name"], tuple(sorted(rec["labels"].items())))] = \
                rec["value"]
        for kind, b in snap["wire_bytes"].items():
            assert seen[("repro_wire_bytes", (("kind", kind),))] == b
        for kind, c in snap["collective_calls"].items():
            assert seen[("repro_collective_launches",
                         (("kind", kind),))] == c
        for lk, kinds in snap["level_wire_bytes"].items():
            level, _, fabric = lk.partition("/")
            for kind, b in kinds.items():
                assert seen[("repro_level_wire_bytes", (
                    ("fabric", fabric), ("kind", kind),
                    ("level", level)))] == b
        lvl_total = sum(b for kinds in snap["level_wire_bytes"].values()
                        for b in kinds.values())
        assert abs(lvl_total - snap["total_wire_bytes"]) < 1e-6
        # the reference's bytes by level and kind for the same call
        assert snap["level_wire_bytes"] == ref["level_wire_bytes"]
        assert snap["wire_bytes"] == ref["wire_bytes"]
        np.testing.assert_allclose(r["out"], want, rtol=1e-5, atol=1e-5)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--reference":
        reference_main(sys.argv[2])
    else:
        raise SystemExit(f"usage: {sys.argv[0]} --reference OUT.json")
