"""The port's online re-tuning (``repro_torch.tuner.online``, the ledger's
timing capture, the epoch-versioned registry) against the reference's:
the 19 cases of ``tests/test_retune.py``, each feeding the same plan
(the reference's JSON, loaded by both packages) and the same sample
stream to both packages' ``OnlineTuner`` and requiring the same refreshed
plan JSON, ``calibration_export``, ``measured_regret``,
``choices_changed`` and ``fold_measurements`` (the miscalibrated-oracle
flip happens at the same refresh), and one more case of the same kind:
samples of one backend reprice only that backend's candidates; plus
``check_online_retune_hotswap``
of ``tests/_mesh_runner.py`` on 4 gloo CPU ranks: 6 steps under the fixed
plan against 6 steps with two mid-loop swaps (one refresh that confirms
the oracle, one that flips a cell the step never takes) give bitwise-equal
params, and every rank's refreshed plan is byte-identical at every
refresh.

The port's tuner reprices a surviving fused verdict with the H100
roofline by default; these cases pass it the reference's constants
(``TPU_V5E``), so the two packages compute the same numbers.  Every
comparison is exact.
"""
import dataclasses
import json
import types

import numpy as np
import pytest

MiB = 1 << 20


def _pkg(base: str):
    import importlib
    m = types.SimpleNamespace(name=base)
    m.tuner = importlib.import_module(f"{base}.tuner")
    m.online = importlib.import_module(f"{base}.tuner.online")
    m.ledger = importlib.import_module(f"{base}.core.ledger")
    m.api = importlib.import_module(f"{base}.core.api")
    m.topology = importlib.import_module(f"{base}.core.topology")
    hw = importlib.import_module(f"{base}.core.hw")
    m.CXL_POOL = hw.CXL_POOL
    return m


@pytest.fixture(scope="module")
def pkgs():
    return _pkg("repro"), _pkg("repro_torch")


def _roof(p) -> dict:
    """The reference's epilogue roofline, for the port's tuner."""
    if p.name == "repro":
        return {}
    from repro.core.hw import TPU_V5E
    return dict(peak_flops=TPU_V5E.peak_flops_bf16, hbm_bw=TPU_V5E.hbm_bw)


def _tuner(p, plan, **kw):
    return p.tuner.OnlineTuner(plan, **kw, **_roof(p))


def both(pkgs, fn):
    out = []
    for p in pkgs:
        p.tuner.clear_active_plan()
        p.ledger.reset()
        out.append(fn(p))
        p.tuner.clear_active_plan()
        p.ledger.reset()
    return tuple(out)


def _tiny(pkgs):
    rt = pkgs[0].tuner
    return rt.TuneGrid(primitives=("all_gather", "scatter"),
                       sizes=(1 * MiB, 16 * MiB), nranks=(2, 3),
                       slicing_factors=(1, 4),
                       allreduce_modes=("two_phase",))


@pytest.fixture(scope="module")
def plans(pkgs):
    """The reference's tiny plans as JSON: tuned by its oracle, by the
    4x-optimistic pool oracle, and with a constant and a per-cell overlap
    window."""
    rt = pkgs[0].tuner
    miscal = dataclasses.replace(
        pkgs[0].CXL_POOL, device_bw=pkgs[0].CXL_POOL.device_bw * 4,
        server_bw=pkgs[0].CXL_POOL.server_bw * 4)
    grid = _tiny(pkgs)
    return {"tiny": rt.generate_plan(grid).to_json(),
            "miscal": rt.generate_plan(grid, pool=miscal).to_json(),
            "const": rt.generate_plan(grid,
                                      overlap_compute=150e-6).to_json(),
            "percell": rt.generate_plan(
                grid, overlap_compute=lambda p, s, n: 150e-6).to_json()}


def _plan(p, plans, key):
    return p.tuner.Plan.from_json(plans[key])


def _miscal_pool(p):
    return dataclasses.replace(p.CXL_POOL,
                               device_bw=p.CXL_POOL.device_bw * 4,
                               server_bw=p.CXL_POOL.server_bw * 4)


def _entry(**kw):
    base = {"primitive": "all_gather", "bucket": 20, "nranks": 3,
            "backend": "cxl", "slicing_factor": 4,
            "allreduce_mode": "two_phase",
            "predicted_time": 1e-3, "baseline_time": 2e-3}
    base.update(kw)
    return base


# -- plan format v4 -------------------------------------------------------

def test_plan_v1_to_v6_compat_chain(pkgs):
    def run(p):
        out = []
        for version in (1, 2, 3):
            pl = p.tuner.Plan.from_json(
                {"version": version, "fingerprint": "f", "meta": {},
                 "entries": [_entry()]})
            ch = pl.entries[("all_gather", 20, 3)]
            out.append((ch.measured_us, ch.sample_count, ch.fused,
                        ch.effective_time(1)))
        for version, entries in (
                (4, [_entry(level="1:abc", measured_us=1500.0,
                            sample_count=5, ewma_alpha=0.3)]),
                (5, [_entry(fused=True)]),
                (6, [_entry(primitive="p2p"),
                     _entry(primitive="p2p", level="0:ib", backend="ring",
                            slicing_factor=1)])):
            pl = p.tuner.Plan.from_json({"version": version,
                                         "fingerprint": "f", "meta": {},
                                         "entries": entries})
            again = p.tuner.Plan.from_json(pl.to_json())
            assert again.entries == pl.entries
            out.append(pl.to_json())
        return out
    ref, got = both(pkgs, run)
    assert got == ref
    assert got[3]["version"] == 6 and got[3]["entries"][0]["sample_count"] \
        == 5


def test_plan_v7_raises_version_error(pkgs, tmp_path):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"version": 7, "fingerprint": "x",
                                "entries": []}))

    def run(p):
        with pytest.raises(p.tuner.PlanVersionError) as ei:
            p.tuner.load_plan(str(path))
        return str(ei.value)
    ref, got = both(pkgs, run)
    # the message names each package's own tune launcher
    assert got.replace("repro_torch.", "repro.") == ref
    assert "7" in got and "(1, 2, 3, 4, 5, 6)" in got


def test_saved_plan_roundtrips_measured_fields(pkgs, plans, tmp_path):
    def run(p):
        ot = _tuner(p, _plan(p, plans, "tiny"), min_samples=1)
        ot.observe("all_gather", 1 * MiB, 3, "ring", 1e-5)
        refined = ot.refresh()
        path = str(tmp_path / f"plan_{p.name}.json")
        p.tuner.save_plan(refined, path)
        loaded = p.tuner.load_plan(path)
        assert loaded.entries == refined.entries
        ot2 = _tuner(p, loaded, min_samples=1)
        key = p.online.cell_key("all_gather", 1 * MiB, 3)
        st = ot2.stats[(key, ("ring", 4, "two_phase"))]
        with open(path) as f:
            return f.read(), st.samples, st.ewma_seconds
    ref, got = both(pkgs, run)
    assert got == ref
    assert got[1] == 1 and got[2] == pytest.approx(1e-5)


# -- ledger timing capture ------------------------------------------------

def test_ledger_timing_capture_and_cells(pkgs):
    def run(p):
        p.ledger.record_timing("all_gather", 1 * MiB, 3, "cxl", 1e-3,
                               slicing_factor=2, allreduce_mode="two_phase")
        p.ledger.record_timing("all_reduce", 2 * MiB, 4, "ring", 2e-3)
        snap = p.ledger.snapshot()
        return snap["timings"], snap["timing_cells"]
    ref, got = both(pkgs, run)
    assert got == ref
    assert got[1]["all_gather/b20/n3@cxl:2:two_phase"]["samples"] == 1
    assert "all_reduce/b21/n4@ring:?:?" in got[1]


def test_ledger_timing_stamps_ambient_scale(pkgs):
    def run(p):
        with p.ledger.scale(3):
            with p.ledger.scale(2):
                p.ledger.record_timing("all_gather", 1 * MiB, 3, "ring",
                                       1e-3)
            with p.ledger.timed("all_gather", 1 * MiB, 3, "ring"):
                pass
        p.ledger.record_timing("all_gather", 1 * MiB, 3, "ring", 1e-3,
                               calls=7.0)
        return [t["calls"] for t in p.ledger.snapshot()["timings"]]
    ref, got = both(pkgs, run)
    assert got == ref == [6.0, 3.0, 7.0]


# -- EWMA aggregation + convergence under noise ---------------------------

def test_ewma_update_sequence(pkgs, plans):
    def run(p):
        ot = _tuner(p, _plan(p, plans, "tiny"), alpha=0.5, min_samples=2)
        for s in (1.0, 2.0, 3.0):
            ot.observe("all_gather", 1 * MiB, 2, "ring", s)
        key = p.online.cell_key("all_gather", 1 * MiB, 2)
        st = ot.stats[(key, ("ring", 4, "two_phase"))]
        return st.ewma_seconds, st.samples, ot.refresh().to_json()
    ref, got = both(pkgs, run)
    assert got == ref
    assert got[0] == pytest.approx(2.25) and got[1] == 3


def test_ewma_converges_under_noisy_samples(pkgs, plans):
    def run(p):
        rng = np.random.default_rng(0)
        out = []
        for alpha, true_s in ((0.1, 5e-4), (0.3, 2e-3), (0.5, 1e-2)):
            ot = _tuner(p, _plan(p, plans, "tiny"), alpha=alpha,
                        min_samples=3)
            for _ in range(200):
                ot.observe("scatter", 1 * MiB, 3, "ring",
                           true_s * rng.normal(1.0, 0.1))
            key = p.online.cell_key("scatter", 1 * MiB, 3)
            st = ot.stats[(key, ("ring", 4, "two_phase"))]
            out.append((alpha, true_s, st.ewma_seconds))
        return out
    ref, got = both(pkgs, run)
    assert got == ref
    for alpha, true_s, ewma in got:
        tol = 4 * 0.1 * (alpha / (2 - alpha)) ** 0.5
        assert abs(ewma - true_s) <= tol * true_s


def test_refresh_flips_to_measured_winner(pkgs, plans):
    """The 4x-optimistic pool oracle routes scatter (1 MiB, 2 ranks) to
    cxl where ring truly wins; fed the truth, both packages flip the cell
    at the same refresh and walk the same candidates."""
    def run(p):
        plan = _plan(p, plans, "miscal")
        assert plan.lookup("scatter", 1 * MiB, 2).backend == "cxl"
        ot = _tuner(p, plan, min_samples=2, pool=_miscal_pool(p),
                    retune_interval=2)
        walk = []
        for step in range(12):
            ch = plan.lookup("scatter", 1 * MiB, 2)
            truth = p.tuner.predict_time(
                ch.backend, "scatter", 2, 1 * MiB,
                slicing_factor=ch.slicing_factor,
                allreduce_mode=ch.allreduce_mode)
            ot.observe("scatter", 1 * MiB, 2, ch.backend, truth,
                       slicing_factor=ch.slicing_factor,
                       allreduce_mode=ch.allreduce_mode)
            new = ot.maybe_retune(step)
            if new is not None:
                plan = new
                c = plan.lookup("scatter", 1 * MiB, 2)
                walk.append((step, c.backend, c.slicing_factor))
        return walk, plan.to_json(), ot.calibration_export(), \
            ot.measured_regret()
    ref, got = both(pkgs, run)
    assert got == ref
    walk = got[0]
    assert walk[-1][1] == "ring"
    first_ring = next(s for s, b, _ in walk if b == "ring")
    assert first_ring == next(s for s, b, _ in ref[0] if b == "ring")


def test_one_backend_samples_reprice_its_candidates_only(pkgs, plans):
    """Samples of one backend calibrate that backend's candidates and no
    other's: cxl measured at 2x its oracle at one all_gather cell, with
    ring never measured, sends every all_gather cell the oracle gave to
    cxl to ring at the first refresh, the unmeasured cells too, in both
    packages alike.  (The card's step-1 boundary over (data, model) did
    this at full width: cxl-only samples moved the big cells to gloo.)"""
    def run(p):
        plan = _plan(p, plans, "tiny")
        on_cxl = sorted(k for k, c in plan.entries.items()
                        if k[0] == "all_gather" and c.backend == "cxl")
        ch = plan.lookup("all_gather", 16 * MiB, 2)
        oracle = p.tuner.predict_time(
            "cxl", "all_gather", 2, 16 * MiB,
            slicing_factor=ch.slicing_factor,
            allreduce_mode=ch.allreduce_mode)
        ot = _tuner(p, plan, min_samples=2)
        for _ in range(3):
            ot.observe("all_gather", 16 * MiB, 2, "cxl", 2 * oracle,
                       slicing_factor=ch.slicing_factor,
                       allreduce_mode=ch.allreduce_mode)
        new = ot.refresh()
        return (on_cxl, {k: new.entries[k].backend for k in on_cxl},
                new.to_json(), ot.calibration_export())
    ref, got = both(pkgs, run)
    assert got == ref
    on_cxl, moved, _, cal = got
    assert len(on_cxl) == 3 and set(moved.values()) == {"ring"}
    assert [(e["backend"], e["primitive"], e["scale"])
            for e in cal["scales"]] == [("cxl", "all_gather", 2.0)]


def test_refresh_grows_cells_at_measured_buckets(pkgs, plans):
    def run(p):
        base = _plan(p, plans, "tiny")
        ot = _tuner(p, base, min_samples=1)
        ot.observe("all_gather", 1024, 2, "ring", 3e-3)
        refined = ot.refresh()
        assert refined.lookup("all_gather", 1024, 2) is \
            refined.entries[("all_gather", 10, 2)]
        assert set(base.entries) <= set(refined.entries)
        return refined.to_json()
    ref, got = both(pkgs, run)
    assert got == ref


def test_refresh_keeps_overlap_objective(pkgs, plans):
    def run(p):
        const = _plan(p, plans, "const")
        ot = _tuner(p, const)
        refreshed = ot.refresh()
        assert not p.tuner.choices_changed(const, refreshed)
        percell = _plan(p, plans, "percell")
        ot2 = _tuner(p, percell)
        frozen = ot2.refresh()
        assert frozen.entries == percell.entries
        ch = percell.lookup("scatter", 1 * MiB, 2)
        ot2.observe("scatter", 1 * MiB, 2, ch.backend, 10.0,
                    slicing_factor=ch.slicing_factor,
                    allreduce_mode=ch.allreduce_mode)
        ot2.min_samples = 1
        moved = ot2.refresh()
        return (ot.overlap_window, refreshed.to_json(), ot2.window_unknown,
                moved.to_json())
    ref, got = both(pkgs, run)
    assert got == ref
    assert got[0] == pytest.approx(150e-6) and got[2]


def test_flat_plan_under_active_topology_maps_levels(pkgs, plans):
    def run(p):
        topo = p.topology.Topology(levels=(
            p.topology.Level("pod", "ib"), p.topology.Level("data", "cxl")))
        p.topology.set_active_topology(topo)
        try:
            ot = _tuner(p, _plan(p, plans, "tiny"), min_samples=1)
            ot.observe("all_gather", 1 * MiB, 2, "ring", 1e-9, level="data")
            refined = ot.refresh()
        finally:
            p.topology.clear_active_topology()
        ot2 = _tuner(p, _plan(p, plans, "tiny"), min_samples=1)
        ot2.observe("all_gather", 1 * MiB, 2, "ring", 1e-9, level="data")
        ot2.observe("all_gather", 1 * MiB, 2, "ring", 1e-9,
                    level="1:0123456789ab")
        return (sorted(map(repr, ot.stats)), refined.to_json(),
                sorted(map(repr, ot2.stats)))
    ref, got = both(pkgs, run)
    assert got == ref
    lkey = pkgs[1].topology.Topology(levels=(
        pkgs[1].topology.Level("pod", "ib"),
        pkgs[1].topology.Level("data", "cxl"))).level_key("data")
    assert any(lkey in k for k in got[0])


def test_observe_step_apportions_by_predicted_share(pkgs, plans):
    choices = [
        {"primitive": "all_gather", "msg_bytes": 1 * MiB, "nranks": 2,
         "backend": "ring", "slicing_factor": 4,
         "allreduce_mode": "two_phase", "predicted_time": 3e-3,
         "calls": 2.0},
        {"primitive": "scatter", "msg_bytes": 1 * MiB, "nranks": 2,
         "backend": "cxl", "slicing_factor": 4,
         "allreduce_mode": "two_phase", "predicted_time": 1e-3,
         "calls": 4.0},
    ]

    def run(p):
        ot = _tuner(p, _plan(p, plans, "tiny"), min_samples=1)
        n = ot.observe_step(2e-2, choices)
        zero = ot.observe_step(1.0, [{"primitive": "reduce", "msg_bytes": 1,
                                      "nranks": 2, "backend": "ring",
                                      "predicted_time": 0.0}])
        return n, zero, {repr(k): (st.ewma_seconds, st.samples)
                         for k, st in ot.stats.items()}
    ref, got = both(pkgs, run)
    assert got == ref
    assert got[:2] == (2, 0)


# -- epoch-versioned registry + hot-swap plumbing -------------------------

def test_registry_epoch_bumps_and_stamps_audit(pkgs, plans):
    def run(p):
        plan = _plan(p, plans, "tiny")
        e0 = p.tuner.plan_epoch()
        p.tuner.set_active_plan(plan)
        assert p.tuner.plan_epoch() == e0 + 1
        assert p.tuner.get_active_plan_versioned() == (plan, e0 + 1)

        def choose(comm):
            if p.name == "repro":
                comm._choice("all_gather", 1 * MiB, 3)
            else:
                comm._choice("all_gather", 1 * MiB, "x", 3)
            return p.ledger.snapshot()["auto_choices"][-1]
        reg = choose(p.api.Communicator(backend="auto"))
        attached = choose(p.api.Communicator(backend="auto", plan=plan))
        return reg["plan_epoch"] - e0, attached["plan_epoch"], \
            reg["backend"], attached["backend"]
    ref, got = both(pkgs, run)
    assert got == ref
    assert got[:2] == (1, None)


def test_refresh_and_activate_publishes(pkgs, plans):
    def run(p):
        ot = _tuner(p, _plan(p, plans, "miscal"), min_samples=1,
                    pool=_miscal_pool(p))
        e0 = p.tuner.plan_epoch()
        plan = ot.refresh_and_activate()
        assert p.tuner.get_active_plan() is plan and ot.plan is plan
        return p.tuner.plan_epoch() - e0, plan.to_json()
    ref, got = both(pkgs, run)
    assert got == ref
    assert got[0] == 1


def test_choices_changed(pkgs, plans):
    def run(p):
        base = _plan(p, plans, "tiny")
        ot = _tuner(p, base, min_samples=1)
        same = ot.refresh()
        ch = base.lookup("scatter", 1 * MiB, 2)
        ot.observe("scatter", 1 * MiB, 2, ch.backend, 10.0,
                   slicing_factor=ch.slicing_factor,
                   allreduce_mode=ch.allreduce_mode)
        flipped = ot.refresh()
        return (p.tuner.choices_changed(base, same),
                p.tuner.choices_changed(base, flipped), flipped.to_json(),
                ot.measured_regret())
    ref, got = both(pkgs, run)
    assert got == ref
    assert got[:2] == (False, True)


def test_choices_changed_ignores_same_resolution_growth(pkgs, plans):
    def run(p):
        base = _plan(p, plans, "tiny")
        served = base.lookup("all_gather", 1024, 2)
        ot = _tuner(p, base, min_samples=1)
        ot.observe("all_gather", 1024, 2, served.backend, 1e-9,
                   slicing_factor=served.slicing_factor,
                   allreduce_mode=served.allreduce_mode)
        grown = ot.refresh()
        return p.tuner.choices_changed(base, grown), grown.to_json()
    ref, got = both(pkgs, run)
    assert got == ref
    assert got[0] is False


def test_fold_measurements_via_ledger(pkgs, plans):
    def run(p):
        base = _plan(p, plans, "tiny")
        ch = base.lookup("all_gather", 16 * MiB, 3)
        for _ in range(3):
            p.ledger.record_timing("all_gather", 16 * MiB, 3, ch.backend,
                                   0.5, slicing_factor=ch.slicing_factor,
                                   allreduce_mode=ch.allreduce_mode)
        refined = p.tuner.fold_measurements(
            base, p.ledger.snapshot()["timings"], min_samples=3,
            **_roof(p))
        new = refined.lookup("all_gather", 16 * MiB, 3)
        assert (new.backend, new.slicing_factor) != \
            (ch.backend, ch.slicing_factor)
        return refined.to_json()
    ref, got = both(pkgs, run)
    assert got == ref
    assert got["version"] == 6


def test_online_tuner_validates_args(pkgs, plans):
    def run(p):
        base = _plan(p, plans, "tiny")
        for kw in (dict(alpha=0.0), dict(alpha=1.5),
                   dict(retune_interval=0), dict(decay=1.0),
                   dict(explore_eps=-0.1)):
            with pytest.raises(ValueError):
                _tuner(p, base, **kw)
        ot = _tuner(p, base)
        ot.observe("all_gather", 1 * MiB, 1, "ring", 1e-3)
        ot.observe("all_gather", 1 * MiB, 3, "ring", -1.0)
        return dict(ot.stats)
    ref, got = both(pkgs, run)
    assert got == ref == {}


def test_decay_and_exploration_match(pkgs, plans):
    """The two recovery knobs (``decay``, ``explore_eps``), off in every
    case above, give the same plans, explored cells and calibration in
    both packages over a noisy stream."""
    def run(p):
        ot = _tuner(p, _plan(p, plans, "miscal"), min_samples=2,
                    pool=_miscal_pool(p), decay=0.2, explore_eps=0.3,
                    explore_seed=4, retune_interval=3)
        rng = np.random.default_rng(2)
        out = []
        for step in range(15):
            for prim, size, n in (("scatter", 1 * MiB, 2),
                                  ("all_gather", 16 * MiB, 3)):
                ch = ot.plan.lookup(prim, size, n)
                ot.observe(prim, size, n, ch.backend,
                           1e-3 * rng.uniform(0.5, 2.0),
                           slicing_factor=ch.slicing_factor,
                           allreduce_mode=ch.allreduce_mode)
            new = ot.maybe_retune(step)
            if new is not None:
                out.append(new.to_json())
        return out, ot.explored, ot.calibration_export()
    ref, got = both(pkgs, run)
    assert got == ref
    assert got[1]


# -- check_online_retune_hotswap on 4 gloo ranks -----------------------------

def hotswap_rank(ctx, base_json: dict) -> dict:
    """The reference's hot-swap check on this rank of a flat 4-rank axis
    ``x``: 6 steps under the fixed plan, then 6 steps with a swap at step
    3 (measurements that confirm the oracle) and at step 5 (a flip of a
    broadcast cell the step never takes), resolving through the registry
    (``Communicator(plan=None)``).  Returns both runs' params and every
    refreshed plan's hash."""
    import torch

    from repro_torch import tuner
    from repro_torch.core import ledger
    from repro_torch.core.api import Communicator
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import plan_sha256
    mesh = make_host_mesh((("x", 4),), ctx, pools=True)
    base = tuner.Plan.from_json(base_json)

    def step(comm, p, x):
        g = comm.all_reduce(x * p, "x")
        piece = comm.reduce_scatter(g, "x")
        return p - 0.1 * comm.all_gather(piece, "x")

    rng = np.random.default_rng(7)
    p0 = rng.standard_normal((16, 4)).astype(np.float32)
    xs = [rng.standard_normal((16, 4)).astype(np.float32)
          for _ in range(6 * 4)]
    mine = [torch.from_numpy(xs[4 * i + ctx.rank]) for i in range(6)]

    tuner.set_active_plan(base)
    ledger.reset()
    comm = Communicator(backend="auto", axes=mesh)
    p_ref = torch.from_numpy(p0)
    for x in mine:
        p_ref = step(comm, p_ref, x)
    profile = ledger.snapshot()["auto_choices"]
    assert profile, "auto resolution recorded no choices"

    tuner.set_active_plan(base)
    p_hot = torch.from_numpy(p0)
    ot = tuner.OnlineTuner(base, min_samples=2)
    hashes = []
    for i, x in enumerate(mine):
        if i == 3:
            for c in profile:
                key = (c["primitive"], tuner.size_bucket(c["msg_bytes"]),
                       c["nranks"])
                if key not in base.entries:
                    continue
                for _ in range(2):
                    ot.observe(c["primitive"], c["msg_bytes"], c["nranks"],
                               c["backend"], c["predicted_time"],
                               slicing_factor=c["slicing_factor"],
                               allreduce_mode=c["allreduce_mode"])
            refreshed = ot.refresh_and_activate()
            for c in profile:
                want = base.lookup(c["primitive"], c["msg_bytes"],
                                   c["nranks"])
                got = refreshed.lookup(c["primitive"], c["msg_bytes"],
                                       c["nranks"])
                assert (got.backend, got.slicing_factor,
                        got.allreduce_mode) == (want.backend,
                                                want.slicing_factor,
                                                want.allreduce_mode)
            hashes.append((tuner.plan_epoch(), plan_sha256(refreshed)))
        if i == 5:
            bch = base.lookup("broadcast", 4096, 4)
            for _ in range(2):
                ot.observe("broadcast", 4096, 4, bch.backend, 10.0,
                           slicing_factor=bch.slicing_factor,
                           allreduce_mode=bch.allreduce_mode)
            refreshed = ot.refresh_and_activate()
            assert tuner.choices_changed(base, refreshed)
            hashes.append((tuner.plan_epoch(), plan_sha256(refreshed)))
        p_hot = step(comm, p_hot, x)
    tuner.clear_active_plan()
    return {"ref": p_ref.numpy(), "hot": p_hot.numpy(), "hashes": hashes,
            "profile": profile}


@pytest.fixture(scope="module")
def hotswap(pkgs):
    from repro_torch.launch import ranks
    rt = pkgs[0].tuner
    base = rt.generate_plan(rt.TuneGrid(
        primitives=("all_reduce", "reduce_scatter", "all_gather",
                    "broadcast"),
        sizes=(4096, 64 * 1024, 1 * MiB), nranks=(4,),
        slicing_factors=(1, 4)))
    # the port's tuner reprices fused verdicts with its own roofline: the
    # base plan it refreshes is its own sweep of the same grid
    pbase = pkgs[1].tuner.generate_plan(pkgs[1].tuner.TuneGrid(
        **dataclasses.asdict(rt.TuneGrid(
            primitives=("all_reduce", "reduce_scatter", "all_gather",
                        "broadcast"),
            sizes=(4096, 64 * 1024, 1 * MiB), nranks=(4,),
            slicing_factors=(1, 4)))))
    assert not pkgs[1].tuner.choices_changed(
        pkgs[1].tuner.Plan.from_json(base.to_json()), pbase)
    return ranks.spawn(hotswap_rank, 4, (pbase.to_json(),), device="cpu",
                       partition_bytes=1 << 20, timeout_s=120.0)


def test_online_retune_hotswap_bitwise_on_four_ranks(hotswap):
    for r in hotswap:
        assert np.array_equal(r["ref"], r["hot"]), \
            "hot-swap perturbed the numerics"
        np.testing.assert_array_equal(r["ref"], hotswap[0]["ref"])
    # the same plan, byte for byte, at the same epoch on every rank
    assert len(hotswap[0]["hashes"]) == 2
    assert all(r["hashes"] == hotswap[0]["hashes"] for r in hotswap)
    # the swaps resolved every call of the step (its three collectives)
    assert {c["primitive"] for c in hotswap[0]["profile"]} == \
        {"all_reduce", "reduce_scatter", "all_gather"}
