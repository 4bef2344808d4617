"""The port's pool machinery and tuner against the reference, on the CPU.

Framework-free modules ported by copy (``core.schedule``,
``core.pool.run_collective``, ``core.simulator``, ``core.ibmodel``) must
give identical outputs: schedules op for op, collective results byte for
byte, simulated and modelled times exactly.  The cost model and the
sweep price the fused cells' epilogue on the H100 by default; with the
reference's roofline constants (and, for an ``ici`` level, its link
constants) injected, they give the reference's numbers and plan JSON
byte for byte.  Plans cross between the packages in both directions,
and ``Communicator(backend="auto")`` and the serving tier's
``resolve_kv_choice`` take the reference's decisions on the same plan.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.core import hw as rhw
from repro.core import ibmodel as ribm
from repro.core import pool as rpool
from repro.core import schedule as rsched
from repro.core import simulator as rsim
from repro.core import topology as rtopo
from repro import tuner as rtuner
from repro.tuner import costmodel as rcost
from repro_torch import tuner as ptuner
from repro_torch.core import hw as phw
from repro_torch.core import ibmodel as pibm
from repro_torch.core import pool as ppool
from repro_torch.core import schedule as psched
from repro_torch.core import simulator as psim
from repro_torch.core import topology as ptopo
from repro_torch.tuner import costmodel as pcost

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
MiB = 1 << 20
PRIMS = rsched.PRIMITIVES
TPU = dict(peak_flops=rhw.TPU_V5E.peak_flops_bf16, hbm_bw=rhw.TPU_V5E.hbm_bw)
TOPO_SPEC = "pod:ib,node:cxl,gpu:ici"
# (nranks, msg_bytes, slicing factor): odd counts, ragged chunks, clamping
SCHED_CASES = [(2, 4096, 1), (3, 3 * 200_000, 4), (4, 4 * 65536, 8),
               (5, 5 * 1000, 2), (8, 8 * 300_000, 16)]


def _ops(ops) -> list:
    return [(o.kind.value, o.rank, o.device, o.pool_offset, o.buf_offset,
             o.size, o.doorbell, o.data_key, o.producer, o.reduce)
            for o in ops]


@pytest.fixture
def port_ici_as_reference(monkeypatch):
    """An ``ici`` level of the port priced and fingerprinted with the
    reference's link constants."""
    monkeypatch.setattr(ptopo, "ICI", phw.ICIConfig(
        **dataclasses.asdict(rhw.ICI)))


@pytest.fixture
def plan_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "cache"))
    ptuner.clear_active_plan()
    yield tmp_path / "cache"
    ptuner.clear_active_plan()


def _choice_fields(c) -> dict:
    return dataclasses.asdict(c)


def _same_json(a, b) -> bool:
    return json.dumps(a.to_json(), sort_keys=True) == \
        json.dumps(b.to_json(), sort_keys=True)


# -- copies: schedule, pool emulator, simulator, IB model ----------------- #

@pytest.mark.parametrize("prim", PRIMS)
def test_schedule_build_matches_reference(prim):
    for n, size, f in SCHED_CASES:
        for placement in ("interleaved", "naive"):
            kw = dict(slicing_factor=f, root=n - 1, granularity=4,
                      placement=placement)
            a = psched.build(prim, n, size, **kw)
            b = rsched.build(prim, n, size, **kw)
            assert dataclasses.asdict(a.layout) == \
                dataclasses.asdict(b.layout)
            assert a.num_doorbells == b.num_doorbells
            for r in range(n):
                assert _ops(a.writes[r]) == _ops(b.writes[r]), (prim, n, r)
                assert _ops(a.reads[r]) == _ops(b.reads[r]), (prim, n, r)


@pytest.mark.parametrize("prim", PRIMS)
def test_pool_run_collective_byte_for_byte(prim):
    rng = np.random.default_rng(1)
    for n, elems, f, dtype in ((2, 64, 1, np.float32), (3, 96, 4, np.int32),
                               (4, 1000, 8, np.float32),
                               (6, 6 * 50, 2, np.float64)):
        cols = elems * n if prim == "scatter" else elems
        x = rng.standard_normal((n, cols)).astype(dtype) \
            if dtype != np.int32 else rng.integers(-50, 50, (n, cols),
                                                  dtype=np.int32)
        kw = dict(root=1, slicing_factor=f, device_capacity=1 << 20)
        got = ppool.run_collective(prim, x, **kw)
        want = rpool.run_collective(prim, x, **kw)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), (prim, n, f)


def test_pool_emulator_refuses_overlap_and_deadlock():
    s = psched.build("all_gather", 3, 4096, slicing_factor=2,
                     device_capacity=1 << 20)
    send = np.zeros((3, 4096), np.uint8)
    bad = dataclasses.replace(s, reads={0: list(s.reads[0]), 1: [], 2: []},
                              writes={0: [], 1: [], 2: []})
    with pytest.raises(RuntimeError, match="deadlock"):
        ppool.execute(bad, send)
    emu = ppool.PoolEmulator(s.layout, s.num_doorbells)
    emu.write_log += [(0, 0, 10), (1, 5, 10)]
    with pytest.raises(AssertionError, match="overlapping"):
        emu.audit_writes()


@pytest.mark.parametrize("variant", ["all", "aggregate", "naive"])
def test_simulator_matches_reference(variant):
    for prim in PRIMS:
        for n, size, f in ((2, 1 * MiB, 1), (3, 4 * MiB + 7, 4),
                           (4, 16 * MiB, 8)):
            a = psim.run_variant(variant, prim, n, size, slicing_factor=f)
            b = rsim.run_variant(variant, prim, n, size, slicing_factor=f)
            assert (a.total_time, a.rank_finish, a.bytes_moved,
                    a.num_ops) == (b.total_time, b.rank_finish,
                                   b.bytes_moved, b.num_ops), (prim, n)


def test_simulate_timeline_and_phase_barrier_match_reference():
    s_p = psched.build("reduce_scatter", 4, 4 * MiB, slicing_factor=4)
    s_r = rsched.build("reduce_scatter", 4, 4 * MiB, slicing_factor=4)
    for barrier in (False, True):
        a = psim.simulate(s_p, psim.SimOptions(phase_barrier=barrier,
                                               track_timeline=True))
        b = rsim.simulate(s_r, rsim.SimOptions(phase_barrier=barrier,
                                               track_timeline=True))
        assert a.total_time == b.total_time and a.timeline == b.timeline


def test_ibmodel_matches_reference():
    for prim in PRIMS:
        for n in (1, 2, 3, 4, 8, 12):
            for size in (1, 4096, 3 * MiB + 1, 1 << 30):
                assert pibm.estimate(prim, n, size).time == \
                    ribm.estimate(prim, n, size).time


# -- cost model ----------------------------------------------------------- #

def test_costmodel_oracles_match_reference(port_ici_as_reference):
    pcost.cache_clear()
    for prim in PRIMS:
        for n in (1, 2, 3, 4, 6):
            for size in (1000, 1 * MiB, 64 * MiB + 3):
                for mode in ("two_phase", "faithful"):
                    for be in ("ring", "cxl"):
                        kw = dict(slicing_factor=4, allreduce_mode=mode)
                        assert pcost.predict_time(be, prim, n, size, **kw) \
                            == rcost.predict_time(be, prim, n, size, **kw)
                        assert pcost.predict_exposed_time(
                            be, prim, n, size, overlappable_compute=1e-4,
                            **kw) == rcost.predict_exposed_time(
                            be, prim, n, size, overlappable_compute=1e-4,
                            **kw)
                assert pcost.ici_time(prim, n, size, ptopo.ICI) == \
                    rcost.ici_time(prim, n, size, rhw.ICI)
                assert pcost.epilogue_flops(prim, size) == \
                    rcost.epilogue_flops(prim, size)
                assert pcost.fused_window(prim, size, 1e-5, **TPU) == \
                    rcost.fused_window(prim, size, 1e-5)
    for lp, lr in zip(ptopo.parse_topology(TOPO_SPEC).levels,
                      rtopo.parse_topology(TOPO_SPEC).levels):
        for be in ("ring", "cxl"):
            for size in (1, 1 * MiB, 256 * MiB):
                assert pcost.predict_level_time(
                    lp, "all_gather", 4, size, backend=be) == \
                    rcost.predict_level_time(lr, "all_gather", 4, size,
                                             backend=be)
                for f in (1, 4):
                    assert pcost.predict_level_p2p_time(
                        lp, size, backend=be, slicing_factor=f) == \
                        rcost.predict_level_p2p_time(
                            lr, size, backend=be, slicing_factor=f)
                    assert pcost.predict_p2p_time(be, size,
                                                  slicing_factor=f) == \
                        rcost.predict_p2p_time(be, size, slicing_factor=f)
    assert pcost.roofline_compute_time(1e12, 1e9, **TPU) == \
        rcost.roofline_compute_time(1e12, 1e9)


def test_costmodel_defaults_are_the_h100():
    """Without injected constants the roofline is the H100 SXM's, and
    the ici level rides NVLink 4 (450 GB/s a direction)."""
    assert pcost.roofline_compute_time(989e12) == pytest.approx(1.0)
    assert pcost.roofline_compute_time(0.0, 3.35e12) == pytest.approx(1.0)
    assert phw.ICI.link_bw == 450e9
    assert pcost.ici_time("all_gather", 4, 64 * MiB, phw.ICI) < \
        rcost.ici_time("all_gather", 4, 64 * MiB, rhw.ICI)


# -- sweep and plans ------------------------------------------------------ #

def test_flat_plan_json_identical_with_reference_constants():
    got = ptuner.generate_plan(ptuner.SMOKE_GRID, **TPU)
    want = rtuner.generate_plan(rtuner.SMOKE_GRID)
    assert _same_json(got, want)


def test_topology_plan_json_identical_with_reference_constants(
        port_ici_as_reference):
    got = ptuner.generate_plan(ptuner.SMOKE_GRID,
                               topology=ptopo.parse_topology(TOPO_SPEC),
                               **TPU)
    want = rtuner.generate_plan(rtuner.SMOKE_GRID,
                                topology=rtopo.parse_topology(TOPO_SPEC))
    assert _same_json(got, want)


def test_h100_plan_makes_the_reference_choices():
    """With the port's defaults the flat plan has the reference's
    fingerprint and choices; only fused cells' predicted and hidden times
    move (the epilogue roofline), and every fused cell's does."""
    got = ptuner.generate_plan(ptuner.SMOKE_GRID)
    want = rtuner.generate_plan(rtuner.SMOKE_GRID)
    assert got.fingerprint == want.fingerprint
    assert sorted(got.entries) == sorted(want.entries)
    moved = 0
    for k, c in want.entries.items():
        a, b = _choice_fields(got.entries[k]), _choice_fields(c)
        timed = ("predicted_time", "hidden_time")
        assert {f: a[f] for f in a if f not in timed} == \
            {f: b[f] for f in b if f not in timed}, k
        if c.fused:
            assert a["predicted_time"] != b["predicted_time"], k
            moved += 1
        else:
            assert a == b, k
    assert moved > 0


def test_h100_topology_plan_makes_the_reference_choices():
    got = ptuner.generate_plan(ptuner.SMOKE_GRID,
                               topology=ptopo.parse_topology(TOPO_SPEC))
    want = rtuner.generate_plan(rtuner.SMOKE_GRID,
                                topology=rtopo.parse_topology(TOPO_SPEC))
    # NVLink constants give the ici level another fingerprint
    assert got.fingerprint != want.fingerprint
    knobs = ("backend", "slicing_factor", "allreduce_mode", "fused",
             "overlap")
    pick = [(k[:3], *(getattr(c, f) for f in knobs))
            for k, c in sorted(got.entries.items())]
    ref = [(k[:3], *(getattr(c, f) for f in knobs))
           for k, c in sorted(want.entries.items())]
    assert sorted(pick) == sorted(ref)


def test_overlap_windows_and_per_cell_window_match_reference():
    grid = ptuner.TuneGrid(primitives=("all_gather", "reduce_scatter"),
                           sizes=(MiB, 16 * MiB), nranks=(4,),
                           slicing_factors=(1, 4))
    rgrid = rtuner.TuneGrid(primitives=("all_gather", "reduce_scatter"),
                            sizes=(MiB, 16 * MiB), nranks=(4,),
                            slicing_factors=(1, 4))
    got = ptuner.generate_plan(grid, overlap_compute=3e-4, **TPU)
    want = rtuner.generate_plan(rgrid, overlap_compute=3e-4)
    assert _same_json(got, want)
    rec = [{"status": "ok", "cost": {"flops": 5e12, "bytes accessed": 2e9},
            "ledger": {"wire_bytes": {"all_gather": 3e8,
                                      "reduce_scatter": 1e8},
                       "collective_calls": {"all_gather": 48,
                                            "reduce_scatter": 16}}}]
    pw = ptuner.overlap_windows_from_dryrun(rec, **TPU)
    rw = rtuner.overlap_windows_from_dryrun(rec)
    assert pw.per_primitive == rw.per_primitive


def _strip(doc: dict, version: int) -> dict:
    """A v6 plan document rewritten in an older format's fields."""
    drop = {1: ("overlap", "hidden_time", "measured_us", "sample_count",
                "ewma_alpha", "fused", "level"),
            2: ("measured_us", "sample_count", "ewma_alpha", "fused",
                "level"),
            3: ("measured_us", "sample_count", "ewma_alpha", "fused"),
            4: ("fused",), 5: ()}[version]
    entries = [{k: v for k, v in e.items() if k not in drop}
               for e in doc["entries"] if e["primitive"] != "p2p"]
    return dict(doc, version=version, entries=entries)


@pytest.mark.parametrize("version", [1, 2, 3, 4, 5])
def test_old_plan_formats_load_as_in_reference(version):
    doc = _strip(ptuner.generate_plan(ptuner.SMOKE_GRID).to_json(), version)
    got = ptuner.Plan.from_json(doc)
    want = rtuner.Plan.from_json(doc)
    assert {k: _choice_fields(c) for k, c in got.entries.items()} == \
        {k: _choice_fields(c) for k, c in want.entries.items()}
    assert got.fingerprint == want.fingerprint


def test_unknown_plan_format_raises():
    doc = dict(ptuner.generate_plan(ptuner.SMOKE_GRID).to_json(),
               version=7)
    with pytest.raises(ptuner.PlanVersionError, match="version 7"):
        ptuner.Plan.from_json(doc)
    assert ptuner.PLAN_VERSION == rtuner.plan.PLAN_VERSION == 6


def _reference_tune(tmp_path, monkeypatch, *extra) -> str:
    from repro.launch import tune as rtune
    path = str(tmp_path / "ref_plan.json")
    monkeypatch.setattr(sys, "argv", ["tune", "--nranks", "4",
                                      "--sizes-mib", "1", "4", "16", "64",
                                      "256", "--quiet", "--out", path,
                                      *extra])
    rtune.main()
    return path


def test_reference_plan_resolves_the_same_in_the_port(tmp_path,
                                                      monkeypatch):
    """A plan written by ``repro.launch.tune`` loads in the port with its
    hardware check and resolves the reference's choices at every size;
    a plan the port writes loads in the reference."""
    path = _reference_tune(tmp_path, monkeypatch, "--kv-block-bytes",
                           "65536", "16777216", "--kv-arch", "llama3.2-1b",
                           "--smoke")
    mine = ptuner.load_plan(path, pool=phw.CXL_POOL, ib=phw.INFINIBAND)
    ref = rtuner.load_plan(path, pool=rhw.CXL_POOL, ib=rhw.INFINIBAND)
    rng = np.random.default_rng(0)
    sizes = [int(s) for s in rng.integers(1, 1 << 31, 40)] + [1, MiB]
    for prim in PRIMS + ("p2p", "kv_block"):
        for n in (1, 2, 3, 4, 5, 8):
            for s in sizes:
                a, b = mine.lookup(prim, s, n), ref.lookup(prim, s, n)
                assert (a is None) == (b is None)
                if a is not None:
                    assert _choice_fields(a) == _choice_fields(b)
    back = str(tmp_path / "port_plan.json")
    ptuner.save_plan(mine, back)
    again = rtuner.load_plan(back, pool=rhw.CXL_POOL, ib=rhw.INFINIBAND)
    assert _same_json(again, ref)
    with open(back) as f, open(path) as g:
        assert f.read() == g.read()


def test_port_tune_cli_matches_the_sweep(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import tune
    out = str(tmp_path / "plan.json")
    plan = tune.main(["--smoke", "--nranks", "4", "--quiet", "--out", out])
    assert _same_json(ptuner.load_plan(out), plan)
    grid = dataclasses.replace(ptuner.SMOKE_GRID, nranks=(4,))
    assert _same_json(plan, ptuner.generate_plan(grid))
    assert "tuned" in capsys.readouterr().out
    with pytest.raises(SystemExit):        # two sources of windows
        tune.main(["--smoke", "--overlap-from-dryrun", "x",
                   "--overlap-compute-us", "5", "--out", out])
    # --overlap-from-dryrun is ported: a path with no record gives no
    # window, so the sweep's cells (tests/test_torch_dryrun.py feeds it
    # records)
    none = tune.main(["--smoke", "--nranks", "4", "--quiet",
                      "--overlap-from-dryrun", str(tmp_path / "none"),
                      "--out", out])
    assert "overlap windows from 0 dry-run records" in \
        capsys.readouterr().out
    assert none.entries == plan.entries
    assert none.meta["overlap_compute_s"] == "per-cell"
    # --measurements is ported: records it cannot read fold no sample, and
    # the refreshed plan makes the sweep's choices
    again = tune.main(["--smoke", "--nranks", "4", "--quiet", "--out", out,
                       "--measurements", str(tmp_path / "none.json")])
    assert not ptuner.choices_changed(plan, again)
    assert again.meta["online"]["measured_candidates"] == 0
    # --placement-report is ported: it needs a topology and parses
    with pytest.raises(SystemExit):
        tune.main(["--smoke", "--placement-report", "llama3.2-1b",
                   "--out", out])
    args = tune.build_parser().parse_args(
        ["--placement-report", "llama3.2-1b", "--placement-axes",
         "data=4,model=1"])
    assert (args.placement_report, args.placement_axes) == \
        ("llama3.2-1b", "data=4,model=1")
    with pytest.raises(SystemExit):
        tune.main(["--smoke", "--kv-block-bytes", "4096", "--out", out])


def test_port_tune_kv_cells_price_like_the_port_oracle(tmp_path):
    from repro_torch.launch import tune
    from repro_torch.serving import kvcache
    out = str(tmp_path / "plan.json")
    plan = tune.main(["--smoke", "--nranks", "2", "--quiet", "--out", out,
                      "--kv-block-bytes", "65536", "--kv-arch",
                      "llama3.2-1b"])
    cell = plan.lookup("kv_block", 65536, 1)
    assert cell.backend in ("pool", "recompute")
    assert cell.allreduce_mode == "kv_tier"
    assert cell == plan.lookup("kv_block", 65536, 1)
    assert isinstance(kvcache.price_kv_block(65536, 1e9),
                      type(cell))


def test_plan_lookup_memo_follows_adds():
    plan = ptuner.Plan(fingerprint="x")
    assert plan.lookup("all_gather", MiB, 4) is None
    c = ptuner.Choice(backend="cxl")
    plan.add("all_gather", MiB, 4, c)
    assert plan.lookup("all_gather", MiB + 1, 4) is c
    d = ptuner.Choice(backend="ring")
    plan.add("all_gather", MiB, 4, d)
    assert plan.lookup("all_gather", MiB, 4) is d


def test_plan_with_placement_names_the_roadmap():
    """ROADMAP queue 1 item 6 ported ``tuner/placement.py``: a plan's
    embedded placement table reads back through ``Plan.placement()``
    after a JSON round trip, as the reference's."""
    from repro.tuner import placement as rpl
    from repro_torch.tuner import placement as ppl
    rtopo_ = rtopo.parse_topology("pod:cxl,node:cxl:3+1")
    pplan = ppl.plan_placement(ppl.CollectiveMix(axes=(ppl.AxisTraffic(
        "data", 4, (ppl.CollectiveCall("all_gather", 1 << 20),)),)),
        ptopo.parse_topology("pod:cxl,node:cxl:3+1"))
    plan = ptuner.Plan(fingerprint="x", meta={"placement": pplan.to_json()})
    again = ptuner.Plan.from_json(plan.to_json()).placement()
    assert again.to_json() == pplan.to_json()
    assert again.best.assignment == (("data", ("node",)),)
    assert rtuner.Plan.from_json(plan.to_json()).placement().to_json() == \
        rpl.PlacementPlan.from_json(pplan.to_json()).to_json()
    assert rtopo_.fingerprint() == again.topology.fingerprint()
    assert ptuner.Plan(fingerprint="x").placement() is None


def test_topology_copy_matches_reference(port_ici_as_reference):
    for spec in ("data:cxl", "pod:ib,node:cxl:4+2", TOPO_SPEC,
                 "pod:ib,node:cxl,gpu:ici:8"):
        a, b = ptopo.parse_topology(spec), rtopo.parse_topology(spec)
        assert a.fingerprint() == b.fingerprint()
        assert a.to_json() == b.to_json()
        assert [a.level_key(x) for x in a.axes] == \
            [b.level_key(x) for x in b.axes]
    d = ptopo.default_topology(("pod", "data", "model"))
    assert [lv.fabric for lv in d.levels] == ["ib", "cxl", "ici"]
    with pytest.warns(UserWarning, match="not covered"):
        assert ptopo.warn_uncovered(ptopo.parse_topology("node:cxl"),
                                    {"data": 4, "model": 1}) == ("data",)


def test_save_plan_from_four_processes_at_once(plan_cache):
    """Four processes save the same default plan at once, as four ranks
    do under --backend auto without --plan: every save is atomic, the
    cache holds one whole plan, and no temporary file is left."""
    path = ptuner.default_plan_path()
    assert path.startswith(str(plan_cache / "repro_torch"))
    os.makedirs(os.path.dirname(path))
    code = ("import sys, time\n"
            "from repro_torch import tuner\n"
            "plan = tuner.generate_plan(tuner.SMOKE_GRID)\n"
            "t0 = float(sys.argv[1])\n"
            "while time.time() < t0: pass\n"
            "for _ in range(30):\n"
            "    tuner.save_plan(plan, tuner.default_plan_path())\n"
            "tuner.ensure_default_plan()\n")
    import time
    start = str(time.time() + 3.0)
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen([sys.executable, "-c", code, start], env=env,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    assert os.listdir(os.path.dirname(path)) == [os.path.basename(path)]
    loaded = ptuner.load_plan(path, pool=phw.CXL_POOL, ib=phw.INFINIBAND)
    assert _same_json(loaded, ptuner.generate_plan(ptuner.SMOKE_GRID))


def test_ensure_default_plan_uses_a_cache_of_its_own(plan_cache):
    plan = ptuner.ensure_default_plan()
    assert ptuner.get_active_plan() is plan
    path = ptuner.default_plan_path()
    assert os.path.dirname(path) == str(plan_cache / "repro_torch")
    assert rtuner.runtime.plan_cache_dir() == str(plan_cache)
    assert os.path.exists(path)
    e0 = ptuner.plan_epoch()
    ptuner.clear_active_plan()
    again = ptuner.ensure_default_plan()       # loads the cached file
    assert _same_json(again, plan) and ptuner.plan_epoch() == e0 + 2


# -- Communicator(backend="auto") and the serving tier -------------------- #

def _axis(name: str, n: int):
    from repro_torch.core.mesh_collectives import AxisGroup
    return AxisGroup(name, 0, n)


def test_auto_choice_matches_reference(tmp_path, monkeypatch):
    from repro.core import ledger as rledger
    from repro.core.api import Communicator as RComm
    from repro_torch.core import ledger as pledger
    from repro_torch.core.api import Communicator as PComm
    path = _reference_tune(tmp_path, monkeypatch)
    rplan = rtuner.load_plan(path)
    pplan = ptuner.load_plan(path)
    rc = RComm(backend="auto", plan=rplan)
    pc = PComm(backend="auto", plan=pplan)
    rng = np.random.default_rng(1)
    sizes = [int(s) for s in rng.integers(1, 1 << 30, 25)] + [4, 267264]
    rledger.reset()
    pledger.reset()
    for prim in PRIMS + ("p2p",):
        for n in (2, 3, 4, 6):
            for s in sizes:
                assert pc._choice(prim, s, _axis("data", n)) == \
                    rc._choice(prim, s, n)
    assert pledger.snapshot()["auto_choices"] == \
        rledger.snapshot()["auto_choices"]


def test_auto_choice_on_topology_levels_matches_reference(
        port_ici_as_reference):
    from repro.core.api import Communicator as RComm
    from repro_torch.core.api import Communicator as PComm
    rt, pt = (rtopo.parse_topology(TOPO_SPEC),
              ptopo.parse_topology(TOPO_SPEC))
    rc = RComm(backend="auto", plan=rtuner.generate_plan(
        rtuner.SMOKE_GRID, topology=rt))
    pc = PComm(backend="auto", plan=ptuner.generate_plan(
        ptuner.SMOKE_GRID, topology=pt, **TPU))
    for ax in ("pod", "node", "gpu", "data"):
        for prim in ("all_gather", "all_reduce", "reduce_scatter", "p2p"):
            for s in (1000, 8 * MiB, 300 * MiB):
                assert pc._choice(prim, s, _axis(ax, 3)) == \
                    rc._choice(prim, s, 3, rt, ax)
    assert pc._choice("all_gather", 300 * MiB, _axis("gpu", 3))[0] == \
        "ring"                          # no pool schedule on ici


def test_auto_refuses_grouped_levels_and_tuple_axes():
    """A grouped (ragged) level (ROADMAP queue 1 item 6, ported) resolves
    under ``auto`` as the reference's does: the within-group phase at its
    largest group on the level, the sub-root phase at the group count on
    the parent, each cell the reference's.  An axis the mesh built
    without the level's groups is refused, naming the fix."""
    import torch

    from repro.core.api import Communicator as RComm
    from repro_torch.core.api import Communicator
    spec = "pod:ib,node:cxl:4+2"
    rt = rtopo.parse_topology(spec)
    rplan = rtuner.generate_plan(rtuner.SMOKE_GRID, topology=rt)
    comm = Communicator(backend="auto",
                        plan=ptuner.Plan.from_json(rplan.to_json()),
                        axes={"node": _axis("node", 6)})
    rc = RComm(backend="auto", plan=rplan)
    for s in (1000, 8 * MiB):
        assert comm._choice("all_gather", s, "node", 4) == \
            rc._choice("all_gather", s, 4, rt, "node")
        assert comm._choice("all_gather", 4 * s, "pod", 2) == \
            rc._choice("all_gather", 4 * s, 2, rt, "pod")
    with pytest.raises(ValueError, match="topology"):
        comm.all_gather(torch.zeros(4), "node")


def test_auto_resolves_a_cell_per_level_of_a_tuple_axis(
        port_ici_as_reference):
    """``("pod", "node")`` under ``auto``: each level resolves its own
    plan cell, as the reference's per-level ``_choice`` does."""
    from repro.core.api import Communicator as RComm
    from repro_torch.core import ledger
    from repro_torch.core.api import Communicator as PComm
    rt, pt = (rtopo.parse_topology(TOPO_SPEC),
              ptopo.parse_topology(TOPO_SPEC))
    rc = RComm(backend="auto", plan=rtuner.generate_plan(
        rtuner.SMOKE_GRID, topology=rt))
    pc = PComm(backend="auto", plan=ptuner.generate_plan(
        ptuner.SMOKE_GRID, topology=pt, **TPU),
        axes={"pod": _axis("pod", 2), "node": _axis("node", 3)})
    assert pc.axis_size(("pod", "node")) == 6
    for s in (1000, 8 * MiB, 300 * MiB):
        ledger.reset()
        for ax in pc.levels(("pod", "node")):
            assert pc._choice("all_reduce", s, ax) == \
                rc._choice("all_reduce", s, ax.size, rt, ax.name)
        audit = ledger.snapshot()["auto_choices"]
        assert [(a["level"], a["fabric"], a["nranks"]) for a in audit] == \
            [("pod", "ib", 2), ("node", "cxl", 3)]


def test_auto_books_fused_and_hidden_like_reference():
    """A fused cell tags the ledger's fused split and an overlap-tuned
    one books hidden bytes, as the reference's ``_rec`` does; the
    fixed backends book neither."""
    from repro_torch.core import ledger
    from repro_torch.core.api import Communicator
    plan = ptuner.Plan(fingerprint="x")
    plan.add("all_gather", MiB, 4, ptuner.Choice(
        backend="ring", fused=True, overlap=True))
    ax = _axis("data", 4)
    ledger.reset()
    Communicator(backend="auto", plan=plan)._rec(
        "all_gather", 3.0, ax, *Communicator(
            backend="auto", plan=plan)._choice("all_gather", MiB, ax)[3:])
    snap = ledger.snapshot()
    assert snap["fused_bytes"] == {"all_gather": 3.0}
    assert snap["hidden_bytes"] == {"all_gather": 3.0}
    assert snap["auto_choices"][0]["fused"] is True
    ledger.reset()
    comm = Communicator(backend="cxl")
    comm._rec("all_gather", 3.0, ax, *comm._choice("all_gather", MiB,
                                                   ax)[3:])
    assert ledger.snapshot()["fused_bytes"] == {}
    assert ledger.snapshot()["auto_choices"] == []


def test_auto_without_plan_falls_back_to_the_cached_default(plan_cache):
    from repro_torch.core import ledger
    from repro_torch.core.api import Communicator
    ledger.reset()
    got = Communicator(backend="auto")._choice("all_reduce", 5 * MiB,
                                               _axis("data", 3))
    want = ptuner.generate_plan(ptuner.SMOKE_GRID).lookup("all_reduce",
                                                          5 * MiB, 3)
    assert got[:3] == (want.backend, want.slicing_factor,
                       want.allreduce_mode)
    assert ledger.snapshot()["auto_choices"][0]["plan_epoch"] == \
        ptuner.plan_epoch()


def test_resolve_kv_choice_with_plan_matches_reference(tmp_path,
                                                       monkeypatch):
    from repro.core import ledger as rledger
    from repro.serving import kvcache as rkv
    from repro_torch.core import ledger as pledger
    from repro_torch.serving import kvcache as pkv
    path = _reference_tune(tmp_path, monkeypatch, "--kv-block-bytes",
                           "65536", "1048576", "67108864", "--kv-arch",
                           "llama3.2-1b", "--smoke")
    rplan, pplan = rtuner.load_plan(path), ptuner.load_plan(path)
    rledger.reset()
    pledger.reset()
    for nbytes in (1, 4096, 65536, 300_000, 1 << 26, 1 << 30):
        for flops in (0.0, 1e9, 1e15):
            a = pkv.resolve_kv_choice("kv_block", nbytes, flops,
                                      plan=pplan)
            b = rkv.resolve_kv_choice("kv_block", nbytes, flops,
                                      plan=rplan)
            assert _choice_fields(a) == _choice_fields(b)
    assert pledger.snapshot()["auto_choices"] == \
        rledger.snapshot()["auto_choices"]


@pytest.mark.parametrize("backend,counter,absent", [
    ("recompute", "replays", "restores"), ("pool", "restores", "replays")])
def test_engine_plan_path_prices_eviction_from_its_cells(tmp_path, backend,
                                                         counter, absent):
    """``ServeConfig.plan_path`` (``launch/serve.py --plan``): the
    engine's eviction takes the plan's kv_block cell, whichever arm it
    names, before the live oracle."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model
    from repro_torch.serving import ServeConfig, ServeEngine
    plan = ptuner.Plan(fingerprint=ptuner.hardware_fingerprint())
    plan.add("kv_block", 4096, 1, ptuner.Choice(
        backend=backend, slicing_factor=1, allreduce_mode="kv_tier"))
    path = str(tmp_path / "kv.json")
    ptuner.save_plan(plan, path)
    cfg = get_config("llama3.2-1b", smoke=True)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(cfg, params, ServeConfig(
        max_seq=64, decode_slots=2, kv_block_tokens=4, hbm_budget_blocks=6,
        plan_path=path), device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 8))
    eng.generate({"tokens": toks}, 6)
    assert eng.counters["evictions"] > 0
    assert eng.counters[counter] > 0 and eng.counters[absent] == 0
    args = serve.build_parser().parse_args(
        ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--plan",
         path, "--prompt-len", "8", "--new-tokens", "2"])
    assert serve.engine_from_args(args)[1]._kv_plan is not None


def test_tuner_imports_no_torch():
    """Tuning (``launch/tune.py``) is pure Python and numpy: a CPU run
    of the smoke grid takes well under a second after start-up."""
    code = ("import sys\n"
            "from repro_torch.launch import tune\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    from repro_torch.core import mesh_collectives as mc
    from repro_torch.tuner import sweep
    assert sweep.DEFAULT_CHUNKS == mc.DEFAULT_CHUNKS


def test_auto_collectives_on_four_cpu_ranks_match_the_oracle():
    """Every flat primitive under ``auto`` on 4 gloo ranks sharing a host
    pool, at sizes whose plan cells pick ``cxl`` and ``ring`` with
    several slicing factors: each rank's result is the numpy oracle's
    and the wire bytes are the fixed backends' convention."""
    from repro_torch.launch import collectives as co
    from repro_torch.launch import ranks
    plan = ptuner.generate_plan(ptuner.TuneGrid(
        nranks=(4,), sizes=(1 * MiB, 16 * MiB)))
    cases = []
    for rows in (16, 2048):                # 64 KiB and 8 MiB per rank
        xs = np.stack([co.bench_input_numpy(r, rows) for r in range(4)])
        cases += [dict(name=name, backend="auto", plan=plan, x=xs)
                  for name in co.PRIMITIVES]
    res = ranks.spawn(co.rank_cases, 4, (cases,), device="cpu",
                      partition_bytes=1 << 20, timeout_s=120)
    picked = set()
    for i, c in enumerate(cases):
        prim = co.PRIMITIVES[c["name"]][0].replace("send", "p2p")
        cell = plan.lookup(prim, c["x"][0].nbytes, 4)
        picked.add((cell.backend, cell.slicing_factor))
        for r in range(4):
            y, wire = res[r][i]
            want = co.oracle(c["name"], list(c["x"]), r)
            assert np.array_equal(y, want), (c["name"], r)
            assert sum(wire.values()) > 0
    assert {b for b, _ in picked} == {"ring", "cxl"}
    assert len({f for b, f in picked if b == "cxl"}) > 1
