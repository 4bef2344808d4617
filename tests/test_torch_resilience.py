"""Resilience (``repro_torch.resilience``, the pool checkpoint store, the
rank-liveness registry and ``train --resilience / --fault-plan /
--pool-ckpt-interval``) against the reference.

The first part mirrors ``tests/test_resilience.py`` case by case: each
case runs the same inputs (the same event stream, the same trees)
through both packages and asserts equal outcomes - verdicts, topologies,
plan cells (the port's plans priced with the reference's roofline
constants, ``TPU_V5E``, where a plan is compared whole), reports and
restored bytes.  Then what a run of rank processes adds: the fault
plan's reach (``RANK_OPS``) and replaced nodes, heartbeats every rank
maps, the store's shared partitions and their common rollback step,
``mesh_topology`` / ``mesh_plan``.

Then, on gloo CPU ranks:

* one spawn of 4 ranks runs ``llama3.2-smoke`` under ``--backend auto``
  over ``pod:cxl,data:cxl:3+1`` with ``rank_death@1:rank=1``, a
  ``pool_error`` window the store's retries absorb, and a
  ``link_degrade`` of ``data@cxl`` under ``--timing-source emulator``
  that fails ``data`` over to ``ib``, beside the same run without a
  fault: the reference's ``ResilienceController``, fed the port's
  beats, pool errors and samples step by step, reaches the same verdicts
  at the same steps with the same re-plans; every rank agrees; the run
  rolls back to the newest step every rank committed and replays the
  data from there; it finishes far inside its timeout;
* a fault that does reach a collective's exchange fails the run at once;
* the 4 -> 3 survivor reconfiguration (``launch.survivor``) against the
  reference's ``check_survivor_reconfig`` arithmetic on the same numpy
  state and inputs (its step on 3 forced host devices, in a
  subprocess), and the reference's monitor and controller fed the same
  stream;
* the reference launcher's own recovery over a topology that names its
  mesh axis, pinned on the reference alone (subprocess): it confirms at
  step 3 and then fails, the survivor level no longer matching the axis.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(name: str):
    """The modules of one package (``repro`` or ``repro_torch``) that the
    cases drive, by role."""
    import importlib
    m = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return types.SimpleNamespace(
        name=name, pool=m("core.pool"), doorbell=m("core.doorbell"),
        topology=m("core.topology"), hw=m("core.hw"),
        resil=m("resilience"), replan=m("resilience.replan"),
        ckpt=m("training.checkpoint"), runtime=m("tuner.runtime"),
        placement=m("tuner.placement"), tuner=m("tuner"),
        sweep=m("tuner.sweep"))


REF, PORT = _pkg("repro"), _pkg("repro_torch")
BOTH = (REF, PORT)


def _roof() -> dict:
    from repro.core.hw import TPU_V5E
    return dict(peak_flops=TPU_V5E.peak_flops_bf16, hbm_bw=TPU_V5E.hbm_bw)


@pytest.fixture(autouse=True)
def _clean_global_state(monkeypatch):
    """Every case leaves both packages' fault hook and registries as it
    found them, and prices the port's re-plans with the reference's
    roofline constants, so whole plans compare equal."""
    gen = PORT.sweep.generate_plan
    patched = functools.partial(gen, **_roof())
    monkeypatch.setattr(PORT.replan, "generate_plan", patched)
    monkeypatch.setattr(PORT.sweep, "generate_plan", patched)
    yield
    for p in BOTH:
        p.pool.clear_fault_hook()
        p.runtime.clear_active_plan()
        p.runtime.clear_link_health()
        p.runtime.clear_rank_liveness()
        p.topology.set_active_topology(None)


def _both(fn):
    """``fn(pkg)`` on both packages; asserts equal results, returns the
    port's."""
    ref, port = fn(REF), fn(PORT)
    assert port == ref
    return port


def _topo(p, shape=(4, 4)):
    T, L = p.topology.Topology, p.topology.Level
    return T(levels=(L(axis="pod", fabric="ib"),
                     L(axis="node", fabric="cxl", shape=shape),
                     L(axis="gpu", fabric="ici", shape=(2,))))


def _tj(topo) -> dict:
    return topo.to_json()


# -- core.pool fault shim -------------------------------------------------

def test_fault_hook_install_and_clear():
    def case(p):
        seen, out = [], []

        def hook(op, info):
            seen.append((op, dict(info)))
            if info.get("rank") == 1:
                raise p.pool.PoolAccessError("injected")

        out.append(p.pool.get_fault_hook() is None)
        p.pool.check_fault("write", rank=1)
        p.pool.set_fault_hook(hook)
        p.pool.check_fault("write", rank=0)
        try:
            p.pool.check_fault("write", rank=1)
        except p.pool.PoolAccessError:
            out.append("raised")
        p.pool.clear_fault_hook()
        p.pool.check_fault("write", rank=1)
        return out, seen
    assert _both(case) == ([True, "raised"], [("write", {"rank": 0}),
                                              ("write", {"rank": 1})])


@pytest.mark.parametrize("fails,retries,backoff", [
    (2, 3, 0.0),           # absorbs transients
    (9, 3, 0.0),           # exhausts and re-raises
    (9, 3, 0.1),           # exponential backoff, injectable sleep
])
def test_with_retries(fails, retries, backoff):
    def case(p):
        calls, notes, slept = {"n": 0}, [], []

        def fn():
            calls["n"] += 1
            if calls["n"] <= fails:
                raise p.pool.PoolAccessError("fault")
            return "ok"
        try:
            out = p.pool.with_retries(
                fn, retries=retries, backoff_s=backoff, sleep=slept.append,
                on_retry=lambda a, e: notes.append(a))
        except p.pool.PoolAccessError:
            out = "raised"
        return out, calls["n"], notes, [round(s, 9) for s in slept]
    got = _both(case)
    assert got[0] == ("ok" if fails <= retries else "raised")


# -- heartbeats -----------------------------------------------------------

def _heartbeat_case(hb):
    out = [hb.read_all(), hb.stale_ranks(1, timeout_steps=1)]
    for r in range(4):
        hb.pulse(r, 5)
    out.append(hb.read_all())
    hb.pulse(0, 6)
    hb.pulse(1, 6)
    out += [hb.stale_ranks(7, timeout_steps=1),
            hb.stale_ranks(6, timeout_steps=1),
            hb.address(3) == 3 * hb.address(1)]
    return out


def test_heartbeat_pulse_read_stale():
    got = _both(lambda p: _heartbeat_case(p.doorbell.HeartbeatRegion(4)))
    assert got[0] == (-1, -1, -1, -1) and got[3] == [2, 3]
    # the shared words every rank maps read the same
    mem = np.zeros(PORT.doorbell.HeartbeatRegion.region_bytes_for(4),
                   dtype=np.uint8)
    assert _heartbeat_case(PORT.doorbell.HeartbeatRegion(4, mem=mem)) == got


def test_heartbeat_pulse_routes_through_fault_hook():
    def case(p, hb):
        def hook(op, info):
            if op == "heartbeat" and info["rank"] == 1:
                raise p.pool.PoolAccessError("rank 1 dead")
        p.pool.set_fault_hook(hook)
        hb.pulse(0, 3)
        try:
            hb.pulse(1, 3)
            raised = False
        except p.pool.PoolAccessError:
            raised = True
        return raised, hb.read(0), hb.read(1)
    got = _both(lambda p: case(p, p.doorbell.HeartbeatRegion(2)))
    assert got == (True, 3, -1)
    mem = np.zeros(2 * 64, dtype=np.uint8)
    assert case(PORT, PORT.doorbell.HeartbeatRegion(2, mem=mem)) == got


def test_shared_heartbeats_are_read_across_mappings(tmp_path):
    """Two mappings of one file (two rank processes): a beat through
    one reads through the other."""
    path = str(tmp_path / "hb")
    with open(path, "wb") as f:
        f.write(b"\0" * 4 * 64)
    a = PORT.doorbell.HeartbeatRegion(
        4, mem=np.memmap(path, dtype=np.uint8, mode="r+"))
    b = PORT.doorbell.HeartbeatRegion(
        4, mem=np.memmap(path, dtype=np.uint8, mode="r+"))
    a.pulse(2, 7)
    b.pulse(0, 0)
    assert b.read_all() == (0, -1, 7, -1) == a.read_all()


# -- fault plan -----------------------------------------------------------

SPEC = ("link_degrade@10-18:link=node@cxl,factor=4;"
        "rank_death@12:rank=3;pool_error@5-7:rate=0.5")


def test_fault_plan_parse_round_trip():
    got = _both(lambda p: (
        [e.kind for e in p.resil.FaultPlan.parse(SPEC).events],
        p.resil.FaultPlan.parse(SPEC).describe(),
        [dataclasses.asdict(e) for e in p.resil.FaultPlan.parse(SPEC).events]))
    assert got[0] == ["pool_error", "link_degrade", "rank_death"]


@pytest.mark.parametrize("spec", [
    "nonsense", "rank_death@12", "link_degrade@3:factor=2",
    "exorcism@3:rank=1", "pool_error@7-7:rate=1"])
def test_fault_plan_rejects_bad_specs(spec):
    def case(p):
        try:
            p.resil.FaultPlan.parse(spec)
        except ValueError as e:
            return str(e)
        return None
    assert _both(case) is not None


def test_fault_event_active_windows():
    def case(p):
        FE = p.resil.FaultEvent
        t = FE(kind="link_degrade", step=5, link="node", until_step=8)
        d = FE(kind="rank_death", step=5, rank=1, until_step=8)
        return [t.active(s) for s in (4, 5, 7, 8)], d.active(100)
    assert _both(case) == ([False, True, True, False], True)


def test_fault_plan_begin_step_drives_emulator_degrades():
    def case(p):
        calls = []

        class FakeEmu:
            def set_degrade(self, link, factor):
                calls.append((link, factor))

        fp = p.resil.FaultPlan.parse("link_degrade@2-4:link=node@cxl,factor=4")
        fresh = [bool(fp.begin_step(s, emulator=FakeEmu())) for s in range(6)]
        return fresh, calls, fp.injected
    got = _both(case)
    assert got[1] == [("node@cxl", 4.0), ("node@cxl", 1.0)]


def _hook_outcomes(p, seed, accesses=("write",), **kw):
    """Each access's outcome, step by step and rank by rank, under a
    plan with a death and a pool-error window."""
    fp = p.resil.FaultPlan.parse(
        "rank_death@2:rank=1;pool_error@4-6:rate=0.5", seed=seed, **kw)
    outcomes = []
    with fp:
        for s in range(8):
            fp.begin_step(s)
            for r in range(3):
                for op in accesses:
                    try:
                        p.pool.check_fault(op, rank=r)
                        outcomes.append((s, r, op, "ok"))
                    except p.pool.PoolAccessError:
                        outcomes.append((s, r, op, "fail"))
    assert p.pool.get_fault_hook() is None
    return outcomes


def test_fault_plan_pool_hook_dead_rank_and_seeded_errors():
    a = _both(lambda p: _hook_outcomes(p, 3))
    assert a == _hook_outcomes(PORT, 3)             # seeded
    assert all(o == "fail" for s, r, _, o in a if r == 1 and s >= 2)
    window = [o for s, r, _, o in a if 4 <= s < 7 and r != 1]
    assert "fail" in window and "ok" in window
    assert all(o == "ok" for s, r, _, o in a if r != 1 and not 4 <= s < 7)


def test_fault_plan_rank_ops_leave_the_exchange_alone():
    """Scoped to ``RANK_OPS``: a collective's exchange ("write" /
    "read") never fails; a heartbeat and a store access fail exactly as
    under the unscoped plan (the same draws: an access out of scope
    draws nothing)."""
    ops = PORT.resil.RANK_OPS
    assert ops == {"heartbeat", "ckpt_write", "ckpt_read", "kv_write",
                   "kv_read", "refcount"}
    scoped = _hook_outcomes(PORT, 3, ("write", "heartbeat", "read",
                                      "ckpt_write"), ops=ops)
    plain = _hook_outcomes(PORT, 3, ("heartbeat", "ckpt_write"))
    assert all(o == "ok" for *_, op, o in scoped if op in ("write", "read"))
    assert [x for x in scoped if x[2] not in ("write", "read")] == plain
    assert "fail" in {o for *_, o in plain}


def test_fault_plan_replaced_rank_passes_the_death_check():
    fp = PORT.resil.FaultPlan.parse("rank_death@1:rank=1;"
                                    "pool_error@5-6:rate=1.0")
    with fp:
        fp.begin_step(2)
        with pytest.raises(PORT.pool.PoolAccessError):
            PORT.pool.check_fault("ckpt_read", rank=1)
        fp.replace(1)
        PORT.pool.check_fault("ckpt_read", rank=1)
        assert fp.dead_ranks() == {1}          # still dead to the monitor
        fp.begin_step(5)                       # a pool-error window still
        with pytest.raises(PORT.pool.PoolAccessError):  # reaches it
            PORT.pool.check_fault("ckpt_read", rank=1)


def test_fault_plan_uninstall_leaves_foreign_hook():
    def case(p):
        other = lambda op, info: None       # noqa: E731
        fp = p.resil.FaultPlan.parse("rank_death@0:rank=0")
        fp.install()
        p.pool.set_fault_hook(other)
        fp.uninstall()
        return p.pool.get_fault_hook() is other
    assert _both(case)


# -- failure monitor ------------------------------------------------------

def _verdicts(fs) -> list:
    return [(f.kind, f.step, f.rank, f.link,
             {k: v for k, v in f.detail.items()
              if not isinstance(v, float)}) for f in fs]


def _drive(mon, steps, dead=(), die_at=0):
    out = {}
    for s in range(steps):
        for r in range(mon.nranks):
            if r in dead and s >= die_at:
                continue
            mon.heartbeats.pulse(r, s)
        out[s] = _verdicts(mon.end_step(s))
    return out


def test_monitor_confirms_death_at_timeout_plus_patience():
    def case(p):
        mon = p.resil.FailureMonitor(4, heartbeat_timeout=1, patience=2,
                                     publish=False)
        v = _drive(mon, 8, dead={2}, die_at=3)
        return v, mon.dead_ranks()
    v, dead = _both(case)
    assert {s: [x[0] for x in fs] for s, fs in v.items() if fs} == \
        {5: ["rank_death"]} and dead == [2]


def test_monitor_readmits_transient_silence():
    def case(p):
        mon = p.resil.FailureMonitor(4, heartbeat_timeout=1, patience=2,
                                     publish=False)
        out = []
        for s in range(8):
            for r in range(4):
                if not (r == 1 and s == 3):
                    mon.heartbeats.pulse(r, s)
            out.append(_verdicts(mon.end_step(s)))
        return out, mon.dead_ranks()
    assert _both(case) == ([[]] * 8, [])


def test_monitor_publishes_liveness_transitions_only():
    def case(p):
        mon = p.resil.FailureMonitor(2, heartbeat_timeout=1, patience=2)
        _drive(mon, 7, dead={1}, die_at=2)
        return (p.runtime.get_rank_liveness(), p.runtime.get_rank_liveness(1),
                p.runtime.dead_ranks())
    reg, one, dead = _both(case)
    assert one["alive"] is False and one["step"] == 4 and dead == [1]


def test_monitor_pool_error_streak_patience():
    def case(p):
        mon = p.resil.FailureMonitor(2, pool_error_patience=3,
                                     publish=False)
        kinds = []
        for s in range(10):
            for r in range(2):
                mon.heartbeats.pulse(r, s)
            if s in (1, 4, 5, 6, 7):
                mon.record_pool_error(s)
            kinds.append([f.kind for f in mon.end_step(s)])
        return kinds
    assert _both(case)[6] == ["pool_errors"]


def test_monitor_pulse_all_skips_confirmed_dead():
    def case(p):
        mon = p.resil.FailureMonitor(4, publish=False)
        a = mon.pulse_all(0)
        mon.confirmed_dead.add(3)
        return a, mon.pulse_all(1), mon.heartbeats.read(3)
    assert _both(case) == (4, 3, 0)


def test_monitor_own_pulse_is_pulse_all_for_one_rank():
    """``pulse(rank, step)`` on every rank's monitor is ``pulse_all``:
    the same words, the same pool errors, a confirmed rank skipped."""
    fp = PORT.resil.FaultPlan.parse("rank_death@1:rank=2")
    with fp:
        one = PORT.resil.FailureMonitor(4, publish=False)
        each = PORT.resil.FailureMonitor(4, publish=False)
        for s in range(3):
            fp.begin_step(s)
            one.pulse_all(s)
            landed = [each.pulse(r, s) for r in range(4)]
            assert landed == [True, True, s < 1, True]
            assert one.heartbeats.read_all() == each.heartbeats.read_all()
            assert one.pool_errors_step == each.pool_errors_step
            one.end_step(s)
            each.end_step(s)
        each.confirmed_dead.add(2)
        assert each.pulse(2, 3) is False and each.pool_errors_step == 0


def test_monitor_link_penalties_empty_when_healthy():
    def case(p):
        mon = p.resil.FailureMonitor(2, publish=False)
        _drive(mon, 3)
        return mon.link_penalties(), mon.persistent_links(2)
    assert _both(case) == ({}, [])


# -- topology surgery -----------------------------------------------------

def test_survivor_topology_shrinks_owning_group():
    def case(p):
        st = p.resil.survivor_topology
        return (_tj(st(_topo(p, (4, 4)), "node", [5])),
                _tj(st(_topo(p, (4, 4)), "node", [0, 1, 7])))
    a, b = _both(case)
    assert a["levels"][1]["shape"] == [4, 3] and b["levels"][1]["shape"] == \
        [2, 3]


def test_survivor_topology_drops_emptied_group():
    assert _both(lambda p: _tj(p.resil.survivor_topology(
        _topo(p, (2, 4)), "node", [0, 1])))["levels"][1]["shape"] == [4]


@pytest.mark.parametrize("what", ["no_survivors", "out_of_range", "no_axis",
                                  "bare", "bare_sized"])
def test_survivor_topology_edge_cases(what):
    def case(p):
        st = p.resil.survivor_topology
        bare = p.topology.Topology(levels=(
            p.topology.Level(axis="node", fabric="cxl"),))
        call = {"no_survivors": lambda: st(_topo(p, (2,)), "node", [0, 1]),
                "out_of_range": lambda: st(_topo(p, (4, 4)), "node", [8]),
                "no_axis": lambda: st(_topo(p), "rack", [0]),
                "bare": lambda: st(bare, "node", [1]),
                "bare_sized": lambda: st(bare, "node", [1], size=4)}[what]
        try:
            return _tj(call())
        except (ValueError, KeyError) as e:
            return type(e).__name__, str(e)
    got = _both(case)
    if what == "bare_sized":
        assert got["levels"][0]["shape"] == [3]


def test_failover_topology_flips_cxl_to_ib():
    def case(p):
        ib = p.hw.InfiniBandConfig(link_bw=7.5e9)
        L = p.topology.Level
        base = p.topology.Topology(levels=(
            L(axis="pod", fabric="ib"),
            L(axis="node", fabric="cxl", ib=ib, shape=(4, 4))))
        topo = p.resil.failover_topology(base, "node")
        out = [_tj(topo), topo.level_for("node").ib is ib]
        for t, ax in ((topo, "node"), (base, "rack")):
            try:
                p.resil.failover_topology(t, ax)
            except (ValueError, KeyError) as e:
                out.append((type(e).__name__, str(e)))
        return out
    got = _both(case)
    assert got[0]["levels"][1]["fabric"] == "ib" and got[1]


# -- re-planning ----------------------------------------------------------

def _mix(p, node_size=8):
    pl = p.placement
    call = pl.CollectiveCall(primitive="all_gather", msg_bytes=1 << 20)
    return pl.CollectiveMix(axes=(
        pl.AxisTraffic(axis="dp", size=2, calls=(call,)),
        pl.AxisTraffic(axis="fsdp", size=node_size, calls=(call,))))


def _cells(plan, topo) -> dict:
    """A plan's cells by (primitive, bucket, nranks, level axis), but an
    ``ici`` level's: the port prices ``ici`` as NVLink (``core.hw.ICI``),
    by design, so its cells and the fingerprints that hash it differ."""
    axes = {topo.level_key(lv.axis): lv.axis for lv in topo.levels
            if lv.fabric != "ici"}
    return {k[:3] + ((axes[k[3]],) if len(k) == 4 else ()):
            dataclasses.asdict(c) for k, c in plan.entries.items()
            if len(k) == 3 or k[3] in axes}


def _rp(rp) -> tuple:
    """A recovery plan: its reason, topology, cells and placement ranking
    (the assignments in order; their times hold the ``ici`` level's)."""
    pl = rp.placement
    return (rp.reason, _tj(rp.topology), _cells(rp.plan, rp.topology),
            rp.describe(),
            None if pl is None else (pl.meta["axes"],
                                     [c.to_json()["assignment"]
                                      for c in pl.ranked]),
            None if rp.chosen is None else rp.chosen.to_json()["assignment"])


def test_replan_rank_death_shrinks_and_rescales_mix():
    got = _both(lambda p: _rp(p.resil.replan(
        [p.resil.Failure(kind="rank_death", step=8, rank=5)],
        _topo(p, (4, 4)), mix=_mix(p, 8))))
    assert "survivors on node: -[5] -> 4+3" in got[0]
    assert got[4][0]["fsdp"] == 7 and got[2]


def test_replan_persistent_cxl_degrade_fails_over():
    got = _both(lambda p: _rp(p.resil.replan(
        [p.resil.Failure(kind="link_degraded", step=6, link="node/cxl")],
        _topo(p, (4, 4)), link_penalties={"node/cxl": 4.0})))
    assert "failover node/cxl -> ib" in got[0]


@pytest.mark.parametrize("kind,link", [("pool_errors", None),
                                       ("link_degraded", "rack/ib")])
def test_replan_requires_actionable_failures(kind, link):
    def case(p):
        try:
            p.resil.replan([p.resil.Failure(kind=kind, step=3, link=link)],
                           _topo(p))
        except ValueError as e:
            return str(e)
    assert "no actionable" in _both(case)


def test_recovery_plan_apply_publishes():
    def case(p):
        rp = p.resil.replan([p.resil.Failure(kind="rank_death", step=8,
                                             rank=5)], _topo(p, (4, 4)))
        epoch = p.runtime.plan_epoch()
        rp.apply()
        return (p.topology.get_active_topology() is rp.topology,
                p.runtime.get_active_plan() is rp.plan,
                p.runtime.plan_epoch() - epoch)
    assert _both(case) == (True, True, 1)


def test_health_penalties_from_registry_shape():
    lh = {"node/cxl": {"degraded": True, "slowdown": 3.7},
          "pod/ib": {"degraded": False, "slowdown": 2.0},
          "gpu/ici": {"degraded": True}}
    assert _both(lambda p: p.resil.health_penalties(lh)) == \
        {"node/cxl": 3.7, "gpu/ici": 1.0}


def test_link_penalty_exempts_ring_on_cxl():
    def case(p):
        lv = p.topology.Level(axis="node", fabric="cxl")
        lp = p.placement._link_penalty
        pen = {"node/cxl": 8.0}
        return (lp(lv, "cxl", pen), lp(lv, "ring", pen),
                lp(lv, "cxl", {"cxl": 5.0}), lp(lv, "cxl", None))
    assert _both(case) == (8.0, 1.0, 5.0, 1.0)


def test_plan_placement_reranks_under_penalty():
    def case(p):
        mix, topo = _mix(p, 8), _topo(p, (4, 4))
        healthy = p.placement.plan_placement(mix, topo)
        hurt = p.placement.plan_placement(
            mix, topo, link_penalties={"node/cxl": 64.0})
        same = [c for c in hurt.ranked
                if c.assignment == healthy.best.assignment]
        return ([c.to_json()["assignment"] for c in healthy.ranked],
                [c.to_json()["assignment"] for c in hurt.ranked],
                hurt.meta["link_penalties"],
                hurt.best.predicted_exposed_s
                >= healthy.best.predicted_exposed_s,
                same[0].predicted_exposed_s
                > healthy.best.predicted_exposed_s)
    got = _both(case)
    assert got[2:] == ({"node/cxl": 64.0}, True, True)


# -- the port's helpers for a launcher that keeps its ranks ---------------

def test_mesh_topology_keeps_the_running_shapes():
    T = PORT.topology
    running = T.parse_topology("pod:cxl,data:cxl:3+1")
    shrunk = PORT.resil.survivor_topology(running, "data", [1])
    assert PORT.resil.mesh_topology(shrunk, running) == running
    failed = PORT.resil.failover_topology(shrunk, "data")
    got = PORT.resil.mesh_topology(failed, running)
    assert [(lv.axis, lv.fabric, lv.shape) for lv in got.levels] == \
        [("pod", "cxl", None), ("data", "ib", (3, 1))]


def test_mesh_plan_serves_the_recovery_cells_at_the_running_levels():
    """Every lookup at a running level resolves at the recovery plan's
    cell of the survivor level of the same axis."""
    T = PORT.topology
    running = T.parse_topology("pod:cxl,data:cxl:3+1")
    rp = PORT.resil.replan(
        [PORT.resil.Failure(kind="rank_death", step=3, rank=1)], running)
    served = PORT.resil.mesh_plan(rp.plan, rp.topology, running)
    assert served.topology() == rp.topology
    assert set(served.levels()) == {running.level_key("pod"),
                                    running.level_key("data")}
    assert rp.plan.lookup("all_gather", 1 << 24, 3,
                          level=running.level_key("data")) is None
    for prim in ("all_gather", "reduce_scatter", "all_reduce"):
        for size in (1 << 12, 1 << 20, 1 << 28):
            for axis, n in (("data", 3), ("pod", 2)):
                assert served.lookup(prim, size, n,
                                     level=running.level_key(axis)) == \
                    rp.plan.lookup(prim, size, n,
                                   level=rp.topology.level_key(axis))


# -- atomic disk checkpoints ----------------------------------------------

def test_save_is_atomic_and_tmp_is_invisible(tmp_path):
    def case(p):
        d = str(tmp_path / p.name)
        tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
        p.ckpt.save(d, 4, tree, meta={"loss": 1.5})
        out = [p.ckpt.latest_step(d)]
        os.makedirs(os.path.join(d, "step_00000009.tmp"))
        out.append(p.ckpt.latest_step(d))
        try:
            p.ckpt.restore(d, 9, tree)
        except FileNotFoundError as e:
            out.append("interrupted" in str(e))
        p.ckpt.save(d, 9, tree)
        out += [p.ckpt.latest_step(d),
                p.ckpt.restore(d, 9, tree)["w"].tolist(),
                p.ckpt.load_meta(d, 4)["loss"]]
        return out
    assert _both(case) == [4, 4, True, 9, [[0, 1, 2], [3, 4, 5]], 1.5]


# -- pool checkpoint store ------------------------------------------------

def _tree(v=0.0):
    return {"params": np.full((4, 4), v, dtype=np.float32),
            "step_count": np.array(int(v), dtype=np.int32)}


def _images(p, store, steps) -> list:
    """Each committed step's slot image, as the slot holds it."""
    if p is PORT:
        return [store.image(s) for s in steps]
    out = []
    for s in steps:
        slot = [k for k in range(store.slots)
                if store._slot_step[k] == s and store.doorbells.is_ready(k)][0]
        base = store.slot_offset(slot)
        hlen = int.from_bytes(bytes(store._pool[base:base + 8]), "little")
        doc = json.loads(bytes(store._pool[base + 8:base + 8 + hlen]))
        n = 8 + hlen + sum(e["nbytes"] for e in doc["leaves"])
        out.append(bytes(store._pool[base:base + n]))
    return out


def _restored(tree) -> dict:
    return {k: (v.dtype.str, v.shape, v.tobytes()) for k, v in tree.items()}


def test_pool_store_snapshot_restore_round_trip():
    def case(p):
        store = p.ckpt.PoolCheckpointStore(capacity_bytes=1 << 16)
        rep = store.snapshot(3, _tree(3.0), meta={"loss": 0.25})
        tree, meta = store.restore(_tree())
        return rep, _restored(tree), meta, _images(p, store, [3])
    rep, tree, meta, _ = _both(case)
    assert rep["step"] == 3 and rep["retries"] == 0 and meta == \
        {"loss": 0.25}


def test_pool_store_double_buffer_keeps_previous_committed():
    def case(p):
        store = p.ckpt.PoolCheckpointStore(capacity_bytes=1 << 16)
        reps = [store.snapshot(s, _tree(float(s))) for s in (1, 2, 3)]
        tree, _ = store.restore(_tree(), step=2)
        return ([r["slot"] for r in reps], store.latest(), _restored(tree),
                _images(p, store, [2, 3]))
    slots, latest, _, _ = _both(case)
    assert slots == [1, 0, 1] and latest == 3


def test_pool_store_midwrite_death_leaves_restorable_snapshot():
    def case(p):
        store = p.ckpt.PoolCheckpointStore(capacity_bytes=1 << 16,
                                           retries=2)
        store.snapshot(5, _tree(5.0))

        def hook(op, info):
            if op == "ckpt_write":
                raise p.pool.PoolAccessError("pool down")
        p.pool.set_fault_hook(hook)
        try:
            store.snapshot(6, _tree(6.0))
            raised = False
        except p.pool.PoolAccessError:
            raised = True
        p.pool.clear_fault_hook()
        tree, _ = store.restore(_tree())
        return raised, store.latest(), _restored(tree), store.retried
    assert _both(case)[:2] == (True, 5)


def test_pool_store_retries_absorb_transients():
    def case(p):
        fails = {"n": 2}

        def hook(op, info):
            if op == "ckpt_write" and fails["n"] > 0:
                fails["n"] -= 1
                raise p.pool.PoolAccessError("transient")
        store = p.ckpt.PoolCheckpointStore(capacity_bytes=1 << 16,
                                           retries=3)
        p.pool.set_fault_hook(hook)
        rep = store.snapshot(1, _tree(1.0))
        return rep, store.retried, store.latest()
    rep, retried, latest = _both(case)
    assert rep["retries"] == 2 == retried and latest == 1


@pytest.mark.parametrize("what", ["slot_capacity", "one_slot"])
def test_pool_store_capacity_and_slot_validation(what):
    def case(p):
        try:
            if what == "one_slot":
                p.ckpt.PoolCheckpointStore(slots=1)
            else:
                p.ckpt.PoolCheckpointStore(capacity_bytes=4096).snapshot(
                    0, {"w": np.zeros((1024, 1024), dtype=np.float32)})
        except ValueError as e:
            return str(e)
    assert _both(case) is not None


def test_pool_store_reads_through_the_fault_shim_as_the_reference():
    """A restore consults the hook once for the header length, once for
    the header and once a leaf, in the reference's order and with its
    offsets and sizes."""
    def case(p):
        store = p.ckpt.PoolCheckpointStore(capacity_bytes=1 << 16)
        store.snapshot(2, _tree(2.0))
        seen = []
        p.pool.set_fault_hook(lambda op, info: seen.append((op, info)))
        store.snapshot(3, _tree(3.0))
        store.restore(_tree(), step=2)
        return seen
    assert len(_both(case)) == 1 + 2 + 2


def _shared(n, cap=1 << 16):
    region = torch.zeros(n * cap, dtype=torch.uint8)
    return [PORT.ckpt.PoolCheckpointStore(cap, region=region, rank=r,
                                          nranks=n) for r in range(n)]


def test_shared_store_rolls_back_to_the_step_every_rank_committed():
    """One partition a rank in one region: a rank whose writes fail from
    step 1 on keeps step 0, and the others keep step 0 beside their
    newest (the slot kept is the newest common step's), so every rank
    reads the same rollback step from the commit words."""
    stores = _shared(3)
    fp = PORT.resil.FaultPlan.parse("rank_death@1:rank=1",
                                    ops=PORT.resil.RANK_OPS)
    with fp:
        for step in range(5):
            fp.begin_step(step)
            for r, st in enumerate(stores):
                try:
                    st.snapshot(step, _tree(10.0 * r + step))
                except PORT.pool.PoolAccessError:
                    pass
    assert [st.committed() for st in stores] == [[0, 4], [0], [0, 4]]
    assert {st.common_latest() for st in stores} == {0}
    # each rank restores its own shards of the common step
    for r, st in enumerate(stores):
        fp.replace(1)
        tree, _ = st.restore(_tree(), step=st.common_latest())
        assert float(tree["params"][0, 0]) == 10.0 * r
    # alone, a store keeps the reference's rotation: the newest only
    alone = PORT.ckpt.PoolCheckpointStore(capacity_bytes=1 << 16)
    for step in range(3):
        alone.snapshot(step, _tree(float(step)))
    assert alone.committed() == [1, 2]


def test_shared_store_images_equal_the_reference_and_restore_in_place():
    ref = REF.ckpt.PoolCheckpointStore(capacity_bytes=1 << 16)
    (mine,) = _shared(1)
    tree = {"params": {"w": np.arange(12, dtype=np.float32).reshape(3, 4)},
            "opt": {"step": np.array([4], dtype=np.int64)}}
    assert ref.snapshot(7, tree, meta={"data_step": 7}) == \
        mine.snapshot(7, {"params": {"w": torch.arange(12.).reshape(3, 4)},
                          "opt": {"step": torch.tensor([4])}},
                      meta={"data_step": 7})
    assert _images(PORT, mine, [7]) == _images(REF, ref, [7])
    out = {"params": {"w": torch.zeros(3, 4, requires_grad=True)},
           "opt": {"step": torch.zeros(1, dtype=torch.int64)}}
    w = out["params"]["w"]
    got, meta = mine.restore(out, out=out)
    assert got["params"]["w"] is w and meta == {"data_step": 7}
    assert torch.equal(w.detach(), torch.arange(12.).reshape(3, 4))
    assert int(got["opt"]["step"][0]) == 4


def test_pool_region_layout_and_shared_mapping(tmp_path):
    """Every rank's ``PoolRegion`` maps one file: partitions 2 MiB
    aligned after the heartbeat words; one rank's beat and commit read
    in another's mapping."""
    hb, stride, total = PORT.ckpt.PoolRegion.layout(3, 5 << 20)
    assert hb == stride // 3 == 2 << 20 and total == hb + 3 * stride
    path = str(tmp_path / "region")
    with open(path, "wb") as f:
        f.truncate(total)
    a = PORT.ckpt.PoolRegion(path, 3, 0, 5 << 20, "cpu")
    b = PORT.ckpt.PoolRegion(path, 3, 2, 5 << 20, "cpu")
    a.heartbeats.pulse(0, 4)
    a.store.snapshot(4, _tree(4.0))
    assert b.heartbeats.read(0) == 4 and b.store.committed(0) == [4]
    assert b.store.common_latest() is None
    a.close()
    b.close()


# -- online-tuner recovery knobs ------------------------------------------

def _flat_tuner(p, **kw):
    grid = p.tuner.TuneGrid(primitives=("all_gather",), sizes=(4 << 20,),
                            nranks=(4,), slicing_factors=(4,),
                            allreduce_modes=("two_phase",))
    plan = p.tuner.generate_plan(grid, **(_roof() if p is PORT else {}))
    return p.tuner.OnlineTuner(plan, alpha=0.5, min_samples=2,
                               **(_roof() if p is PORT else {}), **kw)


def _feed(ot, seconds, n=3):
    for _ in range(n):
        ot.observe("all_gather", 4 << 20, 4, "cxl", seconds,
                   slicing_factor=4, allreduce_mode="two_phase")


CELL = ("all_gather", 4 << 20, 4)


@pytest.mark.parametrize("bad", [{"decay": 1.0}, {"decay": -0.1},
                                 {"explore_eps": 1.0},
                                 {"explore_eps": -0.5}])
def test_online_tuner_validates_recovery_knobs(bad):
    def case(p):
        try:
            p.tuner.OnlineTuner(_flat_tuner(p).plan, **bad)
        except ValueError as e:
            return str(e)
    assert _both(case) is not None


def test_online_tuner_defaults_keep_refresh_stable():
    def case(p):
        ot = _flat_tuner(p)
        _feed(ot, 1e-5)
        a, b = ot.refresh(), ot.refresh()
        return (a.lookup(*CELL).backend, b.lookup(*CELL).backend,
                ot.explored, "decay" in a.meta["online"])
    got = _both(case)
    assert got[0] == got[1] and got[2:] == ([], False)


@pytest.mark.parametrize("decay,n", [(0.5, 8), (0.0, 3)])
def test_online_tuner_decay_unlearns_or_never_forgets(decay, n):
    def case(p):
        ot = _flat_tuner(p, decay=decay)
        trail = [ot.plan.lookup(*CELL).backend]
        _feed(ot, 0.5, n=n)
        for _ in range(13):
            ot.plan = ot.refresh()
            trail.append(ot.plan.lookup(*CELL).backend)
        return trail
    trail = _both(case)
    assert trail[0] == "cxl" and trail[1] != "cxl"
    assert (trail[-1] == "cxl") == (decay > 0)


def test_online_tuner_exploration_is_seeded():
    def case(p):
        ot = _flat_tuner(p, explore_eps=0.9, explore_seed=7)
        _feed(ot, 1e-4)
        for _ in range(4):
            ot.plan = ot.refresh()
        return [(rc, tuple(cand)) for rc, _k, cand in ot.explored]
    assert _both(case)


# -- the controller's closed loop -----------------------------------------

def test_controller_death_to_hotswap():
    def case(p):
        mon = p.resil.FailureMonitor(8, heartbeat_timeout=1, patience=2,
                                     publish=False)
        logs = []
        ctl = p.resil.ResilienceController(
            mon, topology=_topo(p, (4, 4)), mix=_mix(p, 8),
            axis_sizes={"node": 8}, log=logs.append)
        rps = {}
        for s in range(10):
            for r in range(8):
                if not (r == 5 and s >= 6):
                    mon.heartbeats.pulse(r, s)
            rp = ctl.step(s, pulse=False)
            if rp is not None:
                rps[s] = _rp(rp)
        return (rps, ctl.replans, _tj(ctl.topology), logs,
                ctl.report()["monitor"]["dead_ranks"],
                _cells(p.runtime.get_active_plan(), ctl.topology))
    rps, replans, _, _, dead, _ = _both(case)
    assert list(rps) == [8] and replans == 1 and dead == [5]


def test_controller_ignores_unactionable_verdicts():
    def case(p):
        mon = p.resil.FailureMonitor(4, pool_error_patience=2,
                                     publish=False)
        logs = []
        ctl = p.resil.ResilienceController(mon, topology=_topo(p, (2, 2)),
                                           log=logs.append)
        out = []
        for s in range(4):
            mon.pulse_all(s)
            mon.record_pool_error(s)
            out.append(ctl.step(s, pulse=False))
        return out, ctl.replans, logs
    out, replans, logs = _both(case)
    assert out == [None] * 4 and replans == 0 and logs


def test_controller_replans_back_on_recovery():
    def case(p):
        mon = p.resil.FailureMonitor(4, publish=False)
        base = _topo(p, (4, 4))
        ctl = p.resil.ResilienceController(mon, topology=base,
                                           log=lambda _m: None)
        F = p.resil.Failure
        failed = ctl._replan(6, [F(kind="link_degraded", step=6,
                                   link="node/cxl")])
        fo = set(ctl.failed_over)
        back = ctl._replan_back(11, [F(kind="link_recovered", step=11,
                                       link="node/cxl")])
        other = ctl._replan_back(12, [F(kind="link_recovered", step=12,
                                        link="pod/ib")])
        return (_rp(failed), fo, _rp(back), back.topology is base,
                ctl.failed_over, ctl.replans, other)
    got = _both(case)
    assert got[1] == {"node/cxl"} and got[3] and got[5] == 2 and \
        got[6] is None


def test_controller_steps_lost_accounting():
    def case(p):
        ctl = p.resil.ResilienceController(
            p.resil.FailureMonitor(2, publish=False),
            topology=_topo(p, (1, 1)), log=lambda _m: None)
        return (ctl.steps_lost(6, 8, 4), ctl.steps_lost(6, 8, None),
                ctl.steps_lost(6, 8, 8))
    assert _both(case) == (7, 3, 3)


# -- the launcher's flags -------------------------------------------------

def _base() -> list:
    return ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu"]


def test_launcher_flags_reach_the_spec():
    from repro_torch.launch import train
    ap = train.build_parser()
    spec = train.spec_from_args(ap.parse_args(_base() + [
        "--resilience", "--fault-plan", "rank_death@2:rank=1",
        "--pool-ckpt-interval", "3"]))
    assert spec.resil == train.ResilSpec(
        resilience=True, fault_plan="rank_death@2:rank=1",
        pool_ckpt_interval=3)
    assert train.spec_from_args(ap.parse_args(_base())).resil is None
    for extra, match in ((["--fault-plan", "exorcism@3:rank=1"],
                          "unknown fault kind"),
                         (["--pool-ckpt-interval", "-1"], ">= 0")):
        with pytest.raises(SystemExit, match=match):
            train.spec_from_args(ap.parse_args(_base() + extra))


@pytest.mark.parametrize("flag", [["--resilience"],
                                  ["--fault-plan", "rank_death@1:rank=0"]])
def test_launcher_refuses_resilience_with_pipeline(flag):
    """As the reference (``src/repro/launch/train.py:209-220``)."""
    from repro_torch.launch import train
    with pytest.raises(SystemExit, match=f"{flag[0]} is not supported with "
                                         f"--pp-stages > 1"):
        train.spec_from_args(train.build_parser().parse_args(
            _base() + ["--pp-stages", "2", "--batch", "8", *flag]))


# -- one spawn: the launcher's recovery loop ------------------------------

FAULTS = ("rank_death@1:rank=1;pool_error@1-3:rate=0.5;"
          "link_degrade@4:link=data@cxl,factor=4")
RESIL_STEPS = 9
RAGGED = "pod:cxl,data:cxl:3+1"


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    from repro_torch.launch import train, tune
    tmp = str(tmp_path_factory.mktemp("torch_resilience"))
    plan = os.path.join(tmp, "plan.json")
    tune.main(["--smoke", "--nranks", "4", "--topology", RAGGED, "--quiet",
               "--out", plan])
    base = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
            "--mesh", "4x1", "--topology", RAGGED, "--batch", "4",
            "--seq", "32"]
    auto = base + ["--backend", "auto", "--plan", plan, "--timing-source",
                   "emulator"]
    death = ["--resilience", "--fault-plan", "rank_death@1:rank=1",
             "--pool-ckpt-interval", "2", "--steps", "5"]
    flags = {"faulted": auto + [
        "--steps", str(RESIL_STEPS), "--resilience", "--fault-plan",
        FAULTS, "--pool-ckpt-interval", "2"],
        "plain": auto + ["--steps", "3"],
        "cxl": base + ["--backend", "cxl", *death],
        "retuned": auto + ["--online-retune", "--retune-interval", "1",
                           *death]}
    specs = [dataclasses.replace(train.spec_from_args(
        train.build_parser().parse_args(f)), timeout_s=120.0)
        for f in flags.values()]
    got = train.run_many(specs)
    return {"plan": plan, **{k: r[0] for k, r in zip(flags, got)}}


def test_launcher_run_finishes_far_inside_its_timeout(launched):
    """A rank death and a pool-error window never reach a collective's
    exchange: no rank waits on the dead one's doorbells, whose deadline
    (the spec's ``timeout_s``, 120 s) a step would then outlast."""
    assert len(launched["faulted"]["steps"]) == RESIL_STEPS
    for run in ("faulted", "cxl", "retuned"):
        assert max(s["step_s"] for s in launched[run]["steps"]) < 30.0


@pytest.mark.parametrize("run", ["cxl", "retuned"])
def test_launcher_recovers_under_cxl_and_online_retuning(launched, run):
    """The same death under ``--backend cxl`` (the collectives keep the
    mesh's topology, no plan) and under ``--online-retune`` (the tuner
    restarts from the recovery plan the registry serves, and every rank
    goes on refreshing to one plan): confirmed at step 3, rolled back to
    step 0, step 4 replays step 1."""
    steps = launched[run]["steps"]
    rb = [(i, s["resilience_per_rank"][0]["rollback"])
          for i, s in enumerate(steps)
          if "rollback" in s["resilience_per_rank"][0]]
    assert [(i, r["reason"], r["snapshot_step"]) for i, r in rb] == \
        [(3, "survivors on data: -[1] -> 2+1", 0)]
    assert [s["data_step"] for s in steps] == [0, 1, 2, 3, 1]
    np.testing.assert_allclose(steps[4]["loss"], steps[1]["loss"],
                               rtol=1e-4)
    if run == "retuned":
        epoch = rb[0][1]["plan_epoch"]
        assert [o["audit_epochs"] for o in steps[4]["obs_per_rank"]] == \
            [[steps[4]["obs_per_rank"][0]["plan_epoch"]]] * 4
        # step 4 ran under the plan the recovery published
        assert steps[4]["obs_per_rank"][0]["plan_epoch"] == epoch
        assert steps[4]["obs_per_rank"][0]["samples_folded"] > 0


def test_launcher_verdicts_equal_the_reference_fed_the_same_stream(
        launched):
    """The reference's monitor and controller (one process), fed the
    port's beats (which landed), its summed pool errors and its samples
    step by step, reach the same verdicts at the same steps and the same
    re-plans; every rank's record agrees."""
    from repro.core.topology import parse_topology as ref_parse
    run = launched["faulted"]
    mon = REF.resil.FailureMonitor(4)
    ctl = REF.resil.ResilienceController(mon, topology=ref_parse(RAGGED),
                                         log=lambda *_: None)
    mine, theirs, replans = [], [], []
    for i, s in enumerate(run["steps"]):
        rs = s["resilience_per_rank"]
        assert all(r["verdicts"] == rs[0]["verdicts"] for r in rs)
        assert all(r.get("recovery") == rs[0].get("recovery") for r in rs)
        for r, landed in enumerate(rs[0]["pulses_landed"]):
            if landed:
                mon.heartbeats.pulse(r, i)
        for _ in range(rs[0]["pool_errors_folded"]):
            mon.record_pool_error(i)
        rp = ctl.step(i, timings=rs[0]["timings"], pulse=False)
        mine.append([tuple(v) for v in rs[0]["verdicts"]])
        theirs.append([(f.kind, f.rank, f.link, f.step)
                       for f in mon.failures if f.step == i])
        if rp is not None:
            replans.append((i, rp.reason, rp.topology.to_json()))
    assert mine == theirs
    got = [(i, s["resilience_per_rank"][0]["rollback"]["reason"],
            s["resilience_per_rank"][0]["rollback"]["topology"])
           for i, s in enumerate(run["steps"])
           if "rollback" in s["resilience_per_rank"][0]]
    assert got == replans
    assert [r for _, r, _ in got] == ["survivors on data: -[1] -> 2+1",
                                      "failover data/cxl -> ib"]
    assert got[0][0] == 3
    assert [k for v in mine for k, *_ in v] == [
        "rank_death", "pool_errors", "link_degraded"]


def test_launcher_rolls_back_to_the_common_step_and_replays(launched):
    run, plain = launched["faulted"], launched["plain"]
    steps = run["steps"]
    rb = steps[3]["resilience_per_rank"][0]["rollback"]
    assert rb["committed_by_rank"] == [[0, 2], [0], [0, 2], [0, 2]]
    assert rb["snapshot_step"] == 0 and rb["dead_ranks"] == [1]
    # the reference's accounting: detection 1..3, rollback 3 -> 0
    ref_ctl = REF.resil.ResilienceController(
        REF.resil.FailureMonitor(1, publish=False), log=lambda *_: None)
    assert rb["steps_lost"] == ref_ctl.steps_lost(1, 3, 0) == 6
    # every rank took the same rollback; the data rolled back with it
    mine = ("plan", "restore_seconds")
    assert all({k: v for k, v in r["rollback"].items() if k not in mine}
               == {k: v for k, v in rb.items() if k not in mine}
               for r in steps[3]["resilience_per_rank"])
    # each rollback rewinds the data to the batch after the snapshot's,
    # and the replayed step's loss is its first run's
    data = [s["data_step"] for s in steps]
    assert data[:5] == [0, 1, 2, 3, 1]
    for c, s in enumerate(steps[:-1]):
        back = s["resilience_per_rank"][0].get("rollback")
        if back is not None:
            assert data[c + 1] == data[back["snapshot_step"]] + 1
    for i, j in ((4, 1), (5, 2)):
        np.testing.assert_allclose(steps[i]["loss"], steps[j]["loss"],
                                   rtol=1e-4)
    assert steps[0]["loss"] == plain["steps"][0]["loss"]
    # the pool-error window: the store's retries absorbed it on the live
    # ranks, the dead rank's write failed
    snaps = steps[2]["resilience_per_rank"]
    assert [("snapshot" in r, r.get("snapshot", {}).get("retries"))
            for r in snaps] == [(True, 3), (False, None), (True, 3),
                                (True, 3)]
    rep = run["resilience"]
    assert rep["replans"] == 2 and rep["dead_ranks"] == [1]
    assert rep["degraded_links"] == ["data/cxl"]
    assert rep["faults_injected"] == [
        [1, "pool_error@1-3:rate=0.5"], [1, "rank_death@1:rank=1"],
        [4, "link_degrade@4:link=data@cxl,x4.0"]]


def test_launcher_serves_the_recovery_plan_on_the_running_mesh(launched):
    """After each recovery every auto call resolves at the recovery
    plan's cell (the recovery plan's own lookup at the survivor level
    of the call's axis), no fallback event is booked, and the ranks run
    under one epoch; after the failover the data level is ib (ring
    only)."""
    from repro_torch.resilience import mesh_topology
    from repro_torch.tuner.plan import Plan
    run = launched["faulted"]
    running = PORT.topology.parse_topology(RAGGED)
    plan = topo = None
    for i, s in enumerate(run["steps"]):
        assert s["fallbacks"] == 0
        if plan is not None:
            for c in s["choices_rank0"]:
                want = plan.lookup(
                    c["primitive"], c["msg_bytes"], c["nranks"],
                    level=topo.level_key(c["level"]))
                assert (c["backend"], c["slicing_factor"],
                        c["allreduce_mode"]) == (
                    want.backend, want.slicing_factor, want.allreduce_mode)
        rb = s["resilience_per_rank"][0].get("rollback")
        if rb is not None:
            topo = PORT.topology.Topology.from_json(rb["topology"])
            running = mesh_topology(topo, running)
            assert running.to_json() == rb["running_topology"]
            plan = Plan.from_json(rb["plan"])
    assert running.level_for("data").fabric == "ib"
    fo = [i for i, s in enumerate(run["steps"])
          if "failover" in s["resilience_per_rank"][0]
          .get("rollback", {}).get("reason", "")]
    assert fo and fo[0] < RESIL_STEPS - 1
    for s in run["steps"][fo[0] + 1:]:
        assert {c["backend"] for c in s["choices_rank0"]
                if c["level"] == "data"} == {"ring"}


# -- a fault that reaches a collective's exchange -------------------------

def _exchange_fault(ctx):
    from repro_torch.core.api import Communicator
    from repro_torch.launch.mesh import make_host_mesh, mesh_shape
    comm = Communicator(backend="cxl", axes=make_host_mesh(
        mesh_shape(ctx.nranks), ctx))
    fp = PORT.resil.FaultPlan.parse("rank_death@0:rank=1")    # every op
    with fp:
        fp.begin_step(0)
        comm.all_reduce(torch.ones(1024), "data")
    return True


def test_fault_reaching_the_exchange_fails_the_run_at_once():
    """Unscoped, the dead rank's publish raises: the spawn fails with its
    error instead of the survivors waiting out the pool's deadline."""
    from repro_torch.launch import ranks
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="PoolAccessError"):
        ranks.spawn(_exchange_fault, 2, device="cpu",
                    partition_bytes=1 << 20, timeout_s=300.0)
    assert time.perf_counter() - t0 < 60.0


# -- the 4 -> 3 survivor reconfiguration ----------------------------------

@pytest.fixture(scope="module")
def survivor(tmp_path_factory):
    """``launch.survivor`` on CPU ranks, then the reference's step from
    the state the survivors restored, in a subprocess."""
    from repro_torch.launch import survivor as sv
    tmp = str(tmp_path_factory.mktemp("torch_survivor"))
    res = sv.run("cpu")
    np.savez(os.path.join(tmp, "inputs.npz"), p=res["second"][0]["p0"],
             resume=np.stack(res["inputs"]["resume"]))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=3"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    got = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--reference", tmp],
        env=env, capture_output=True, text=True, timeout=400)
    assert got.returncode == 0, (got.stdout + got.stderr)[-3000:]
    with np.load(os.path.join(tmp, "reference.npz")) as f:
        reference = {k: f[k] for k in f.files}
    with open(os.path.join(tmp, "reference.json")) as f:
        reference.update(json.load(f))
    return res, reference


def test_survivor_reconfig_passes_the_reference_checks(survivor):
    from repro_torch.launch import survivor as sv
    res, _ = survivor
    summary = sv.check(res)
    assert summary["confirm_step"] == 4
    assert summary["reason"] == "survivors on data: -[3] -> 2+1"
    assert summary["committed"] == [[0, 4], [0, 4], [0, 4], [0]]
    assert summary["restored_step"] == 0 and summary["steps_lost"] == 7


def test_survivor_reconfig_equals_the_reference_arithmetic(survivor):
    """The same numpy state and inputs through the reference's step on 3
    forced host devices, flat ``cxl`` and ragged ``auto`` under its own
    recovery plan: the port's ragged and flat runs equal both at rtol
    1e-4, atol 1e-6, and the restored state is the snapshot's bitwise."""
    from repro_torch.launch import survivor as sv
    res, ref = survivor
    data = sv.inputs()
    p = data["p"]
    for i in range(res["first"][0]["common"] + 1):
        p = (p - 0.1 * 4 * np.sum(
            data["xs"][i].reshape(4, sv.ROWS, 4) * p, 0)).astype(np.float32)
    for r in res["second"]:
        np.testing.assert_array_equal(r["p0"], res["second"][0]["p0"])
        np.testing.assert_allclose(r["p0"], p, rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(r["ragged"], ref["flat"], rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(r["flat"], ref["flat"], rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(r["ragged"], ref["ragged"], rtol=1e-4,
                                   atol=1e-6)
    # the port books each call as it runs, the reference one step's
    # calls at trace time
    lvl = {k: sum(v.values()) / sv.RESUME_STEPS
           for k, v in res["second"][0]["level_wire_bytes"].items()}
    assert lvl == {k: float(v) for k, v in ref["level_bytes"].items()}
    assert {(a["level"], a["nranks"]) for a in res["second"][0]["audit"]} \
        == {tuple(x) for x in ref["audit_cells"]}


def test_survivor_reconfig_verdicts_equal_the_reference_controller(
        survivor):
    """The reference's monitor and controller, fed the first spawn's
    beats and pool errors, confirm at the same step with the same
    re-plan; its recovery plan prices the same cells (both packages at
    the reference's roofline)."""
    from repro_torch.launch import survivor as sv
    res, _ = survivor
    f0 = res["first"][0]
    topo = REF.topology.parse_topology(sv.TOPOLOGY)
    mon = REF.resil.FailureMonitor(4)
    ctl = REF.resil.ResilienceController(mon, topology=topo,
                                         log=lambda *_: None)
    for i in range(len(f0["steps"])):
        for r, rank in enumerate(res["first"]):
            if rank["steps"][i]["pulse"]:
                mon.heartbeats.pulse(r, i)
        for _ in range(sum(f0["steps"][i]["pool_errors"])):
            mon.record_pool_error(i)
        rp = ctl.step(i, pulse=False)
        assert [[f.kind, f.rank, f.step] for f in mon.failures
                if f.step == i] == f0["steps"][i]["verdicts"]
    assert rp is not None and rp.reason == f0["reason"]
    assert rp.topology.to_json() == f0["topology"]
    port_rp = PORT.resil.replan(
        [PORT.resil.Failure(kind="rank_death", step=4, rank=3)],
        PORT.topology.parse_topology(sv.TOPOLOGY))
    assert port_rp.plan.to_json() == rp.plan.to_json()


def test_reference_launcher_recovery_breaks_its_mesh(tmp_path):
    """The reference launcher over a topology that names its mesh axis
    (``pod:cxl,data:cxl:3+1``, 4 forced devices): ``rank_death@1`` is
    confirmed at step 3, the re-plan publishes ``2+1`` and the next step
    fails, its 4-device axis no longer matching the level.  The port's
    launcher keeps its mesh's shapes (``resilience.mesh_topology``)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    got = subprocess.run(
        [sys.executable, "-m", "repro.launch.train", "--arch",
         "llama3.2-1b", "--smoke", "--mesh", "4x1", "--topology", RAGGED,
         "--resilience", "--fault-plan", "rank_death@1:rank=1",
         "--pool-ckpt-interval", "2", "--steps", "6", "--seq", "32",
         "--batch", "4", "--backend", "cxl"], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=400)
    out = got.stdout + got.stderr
    assert got.returncode != 0
    assert "[resilience] step 3: re-plan [survivors on data: -[1] -> 2+1]" \
        in out
    assert "group shape (2, 1) spans 3 ranks but axis 'data' has 4" in out


def _reference_survivor(tmp: str) -> None:
    """Subprocess: the reference's ``check_survivor_reconfig`` step on 3
    forced host devices from the state the port's survivors restored and
    on the same inputs, flat ``cxl`` and ragged ``auto`` under the
    reference's own recovery plan and survivor topology."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro import tuner
    from repro.core import ledger
    from repro.core.api import Communicator
    from repro.core.topology import parse_topology, set_active_topology
    from repro.resilience import Failure, replan
    from repro_torch.launch import survivor as sv

    with np.load(os.path.join(tmp, "inputs.npz")) as f:
        p, resume = f["p"], f["resume"]

    def make_step(mesh, axis, comm):
        def step(q, x):
            g = comm.all_reduce(x * q, axis)
            piece = comm.reduce_scatter(g, axis)
            return q - 0.1 * comm.all_gather(piece, axis)
        return jax.jit(jax.shard_map(step, mesh=mesh,
                                     in_specs=(P(), P(axis)),
                                     out_specs=P(), check_vma=False))

    devs = np.asarray(jax.devices()[:3])
    flat = make_step(jax.sharding.Mesh(devs, ("x",)), "x",
                     Communicator(backend="cxl"))
    q = p
    for x in resume:
        q = flat(q, x)
    rp = replan([Failure(kind="rank_death", step=4, rank=3)],
                parse_topology(sv.TOPOLOGY))
    rp.apply()
    ragged = make_step(jax.sharding.Mesh(devs, ("data",)), "data",
                       Communicator(backend="auto"))
    ledger.reset()
    r = ragged(p, resume[0])
    snap = ledger.snapshot()          # one step's bytes, booked at trace
    for x in resume[1:]:
        r = ragged(r, x)
    set_active_topology(None)
    tuner.clear_active_plan()
    np.savez(os.path.join(tmp, "reference.npz"), flat=np.asarray(q),
             ragged=np.asarray(r))
    with open(os.path.join(tmp, "reference.json"), "w") as f:
        json.dump({"level_bytes": {k: sum(v.values()) for k, v in
                                   snap["level_wire_bytes"].items()},
                   "audit_cells": sorted({(a["level"], a["nranks"])
                                          for a in snap["auto_choices"]})},
                  f)


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    import repro.core  # noqa: F401  (installs the jax compat aliases)
    _reference_survivor(sys.argv[2])
