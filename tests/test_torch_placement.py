"""The port's copy of ``tuner.placement``, the axis aliases of
``models.sharding`` and the launchers' ``--placement`` against the
reference.

Mirrors the 17 tests of ``tests/test_placement.py``: each runs the port
and the reference on the same inputs (topologies built by the reference
and read by the port from their JSON, so every fabric config and
fingerprint agrees; the analytic mix priced with the reference's
roofline constants) and asserts the reference's own property of both,
plus identical ``PlacementPlan`` JSON, ``mesh_spec``, placed topology,
aliases and report text.  Then the port's own surfaces: ``launch.tune
--placement-report``, ``Plan.placement()``, ``launch.mesh.
make_placed_mesh`` / ``dp_axes`` and ``launch.train --placement``.
"""
import json

import pytest

from repro import tuner as rtuner
from repro.core import topology as rtopology
from repro.core.hw import (TPU_V5E, CXLPoolConfig, ICIConfig,
                           InfiniBandConfig, MiB)
from repro.core.topology import Level as RLevel
from repro.core.topology import Topology as RTopology
from repro.models import sharding as rsharding
from repro.tuner import placement as rpl
from repro_torch import tuner as ptuner
from repro_torch.core import topology as ptopo
from repro_torch.models import sharding as psharding
from repro_torch.tuner import placement as ppl

SLOW_IB = InfiniBandConfig(link_bw=2.5e9)
POOL = CXLPoolConfig(device_bw=18e9)
FAST_ICI = ICIConfig(link_bw=45e9)

R_TOPO = RTopology(levels=(
    RLevel("pod", "ib", ib=SLOW_IB, shape=(2,)),
    RLevel("node", "cxl", pool=POOL, shape=(2,)),
    RLevel("gpu", "ici", ici=FAST_ICI, shape=(4,)),
))
R_RAGGED = RTopology(levels=(
    RLevel("pod", "ib", ib=SLOW_IB),
    RLevel("node", "cxl", pool=POOL, shape=(4, 2)),
    RLevel("gpu", "ici", ici=FAST_ICI, shape=(6,)),
))
# the reference's roofline, so the analytic mixes' windows agree
ROOF = dict(peak_flops=TPU_V5E.peak_flops_bf16, hbm_bw=TPU_V5E.hbm_bw)


def port(topo: RTopology):
    """The port's copy of a reference topology (same JSON)."""
    return ptopo.Topology.from_json(topo.to_json())


TOPO, RAGGED = port(R_TOPO), port(R_RAGGED)


def heavy_tp_mix(pl, tp=4, dp=4):
    """A mix whose TP axis dominates (either package's ``pl``)."""
    return pl.CollectiveMix(axes=(
        pl.AxisTraffic("model", tp, (
            pl.CollectiveCall("all_reduce", 64 * MiB, calls=100.0),)),
        pl.AxisTraffic("data", dp, (
            pl.CollectiveCall("all_gather", 4 * MiB, calls=4.0),)),
    ))


def both_plans(mix_fn, rtopo, **kw) -> tuple:
    """(port plan, reference plan) of ``mix_fn(pl)`` on ``rtopo``, with
    identical JSON."""
    rplan = rpl.plan_placement(mix_fn(rpl), rtopo, **kw)
    pplan = ppl.plan_placement(mix_fn(ppl), port(rtopo), **kw)
    assert json.dumps(pplan.to_json(), sort_keys=True) == \
        json.dumps(rplan.to_json(), sort_keys=True)
    return pplan, rplan


def _configs(arch: str) -> tuple:
    from repro.configs import get_config as rget
    from repro_torch.configs import get_config as pget
    return pget(arch), rget(arch)


# -- shape-vector levels ---------------------------------------------------

def test_level_shape_validation_and_props():
    for mod in (ptopo, rtopology):
        lv = mod.Level("node", "cxl", shape=(4, 2))
        assert lv.size == 6 and lv.grouped and lv.irregular
        assert mod.Level("gpu", "ici", shape=(8,)).size == 8
        assert not mod.Level("gpu", "ici", shape=(8,)).grouped
        assert mod.Level("n", "cxl", shape=(3, 3)).grouped
        assert not mod.Level("n", "cxl", shape=(3, 3)).irregular
        assert mod.Level("n", "cxl").size is None
        with pytest.raises(ValueError):
            mod.Level("n", "cxl", shape=())
        with pytest.raises(ValueError):
            mod.Level("n", "cxl", shape=(4, 0))


def test_shape_in_fingerprint_and_parse():
    base = ptopo.Level("n", "cxl")
    assert base.fingerprint() != ptopo.Level(
        "n", "cxl", shape=(4, 2)).fingerprint()
    assert ptopo.Level("n", "cxl", shape=(4, 2)).fingerprint() != \
        ptopo.Level("n", "cxl", shape=(3, 3)).fingerprint()
    spec = "pod:ib,node:cxl:4+2"
    t, r = ptopo.parse_topology(spec), rtopology.parse_topology(spec)
    assert t.level_for("node").shape == (4, 2)
    assert t.level_for("pod").shape is None
    assert t.parent_of("node").axis == "pod" and t.parent_of("pod") is None
    # no ici level: both packages fingerprint the spec alike
    assert t.fingerprint() == r.fingerprint()
    assert t.level_key("node") == r.level_key("node")


def test_topology_fingerprint_ignores_axis_names():
    a = ptopo.Topology(levels=(ptopo.Level("pod", "ib"),
                               ptopo.Level("node", "cxl")))
    b = ptopo.Topology(levels=(ptopo.Level("data", "ib"),
                               ptopo.Level("model", "cxl")))
    assert a.fingerprint() == b.fingerprint()
    c = ptopo.Topology(levels=(ptopo.Level("x", "cxl"),
                               ptopo.Level("y", "ib")))
    assert a.fingerprint() != c.fingerprint()
    assert TOPO.fingerprint() == R_TOPO.fingerprint()
    assert RAGGED.fingerprint() == R_RAGGED.fingerprint()


def test_irregular_level_roundtrip_through_plan_save_load(tmp_path):
    """A ragged topology embedded in the port's tuned plan survives save
    -> load (in either package) with its shape vector and fingerprint,
    tuned at the group sizes and, on the parent, the group count."""
    grid = dict(primitives=("all_reduce",), sizes=(1 * MiB,), nranks=(3,),
                slicing_factors=(4,))
    plan = ptuner.generate_plan(ptuner.TuneGrid(**grid), topology=RAGGED)
    path = str(tmp_path / "ragged.json")
    ptuner.save_plan(plan, path)
    loaded = ptuner.load_plan(path, topology=RAGGED)
    topo = loaded.topology()
    assert topo.level_for("node").shape == (4, 2)
    assert topo.level_for("node").irregular
    assert topo.fingerprint() == RAGGED.fingerprint()
    node_n = {k[2] for k in loaded.entries
              if k[3] == RAGGED.level_key("node")}
    pod_n = {k[2] for k in loaded.entries
             if k[3] == RAGGED.level_key("pod")}
    assert {2, 4} <= node_n and 2 in pod_n
    ref = rtuner.generate_plan(rtuner.TuneGrid(**grid), topology=R_RAGGED)
    assert sorted(loaded.entries) == sorted(ref.entries)
    assert rtuner.load_plan(path, topology=R_RAGGED).topology() \
        .fingerprint() == R_RAGGED.fingerprint()


# -- the planner -----------------------------------------------------------

def test_planner_picks_known_best_under_skewed_oracle():
    plan, _ = both_plans(heavy_tp_mix, R_TOPO)
    best = plan.best
    assert best.levels_for("model") == ("gpu",)
    assert best.levels_for("data") == ("pod", "node")
    naive = plan.find({"model": ("pod", "node"), "data": "gpu"})
    assert naive is not None
    assert naive.predicted_exposed_s > best.predicted_exposed_s
    assert best is plan.best_with_unsplit(("model",))
    assert "data" in best.split_axes and "model" not in best.split_axes


def test_planner_infeasible_and_size_checks():
    def mix(pl):
        return pl.CollectiveMix(axes=(pl.AxisTraffic("model", 5, (
            pl.CollectiveCall("all_reduce", MiB),)),))
    with pytest.raises(ValueError, match="no feasible"):
        ppl.plan_placement(mix(ppl), TOPO)
    with pytest.raises(ValueError, match="no feasible"):
        rpl.plan_placement(mix(rpl), R_TOPO)
    rtopo = RTopology(levels=(RLevel("a", "ib"), RLevel("b", "ici",
                                                        ici=FAST_ICI)))
    plan, _ = both_plans(mix, rtopo)
    assert plan.best.levels_for("model") in (("a",), ("b",))


def test_planner_ragged_pricing_prefers_pool_over_flat_ib():
    node, pod = RAGGED.level_for("node"), RAGGED.level_for("pod")
    ragged = ppl._ragged_call_time(node, pod, "all_reduce", 64 * MiB)
    flat = ppl._best_level_time(pod, "all_reduce", 6, 64 * MiB)
    assert 0 < ragged < flat
    assert ragged == rpl._ragged_call_time(
        R_RAGGED.level_for("node"), R_RAGGED.level_for("pod"),
        "all_reduce", 64 * MiB)
    plan, _ = both_plans(lambda pl: heavy_tp_mix(pl, tp=6, dp=6), R_RAGGED)
    assert plan.best.levels_for("model") == ("gpu",)
    for p in plan.ranked:
        for _, levels in p.assignment:
            assert "pod" not in levels


def test_best_with_unsplit_raises_when_only_splits_fit():
    rtopo = RTopology(levels=(RLevel("pod", "ib", shape=(2,)),
                              RLevel("node", "cxl", shape=(2,))))

    def mix(pl):
        return pl.CollectiveMix(axes=(pl.AxisTraffic("model", 4, (
            pl.CollectiveCall("all_reduce", MiB),)),))
    plan, rplan = both_plans(mix, rtopo)
    assert plan.best.levels_for("model") == ("pod", "node")
    with pytest.raises(ValueError, match="splits"):
        plan.best_with_unsplit(("model",))
    rep = ppl.format_report(plan, chosen=plan.best)
    assert "chosen" in rep
    assert rep == rpl.format_report(rplan, chosen=rplan.best)


def test_overlap_window_reduces_exposed_time():
    def mix(pl):
        return pl.CollectiveMix(axes=(
            pl.AxisTraffic("data", 4, (pl.CollectiveCall(
                "all_gather", 16 * MiB, calls=2.0, overlap_s=1e9),)),
            pl.AxisTraffic("model", 4, (
                pl.CollectiveCall("all_reduce", MiB),)),))
    plan, _ = both_plans(mix, R_TOPO)
    assert dict(plan.best.per_axis_s)["data"] == 0.0


def test_placement_plan_json_roundtrip(tmp_path):
    plan, _ = both_plans(heavy_tp_mix, R_TOPO)
    path = str(tmp_path / "placement.json")
    ppl.save_placement(plan, path)
    again = ppl.load_placement(path)
    assert again.best.assignment == plan.best.assignment
    assert again.best.predicted_exposed_s == pytest.approx(
        plan.best.predicted_exposed_s)
    assert again.topology.fingerprint() == TOPO.fingerprint()
    # the file crosses to the reference
    ref = rpl.load_placement(path)
    assert ref.best.assignment == plan.best.assignment
    assert json.dumps(ref.to_json(), sort_keys=True) == \
        json.dumps(again.to_json(), sort_keys=True)


def test_placement_embeds_in_plan_meta():
    """``Plan.placement()`` reads back the ranked table a plan's
    metadata embeds, in the port as in the reference."""
    grid = ptuner.TuneGrid(primitives=("all_reduce",), sizes=(1 * MiB,),
                           nranks=(2,), slicing_factors=(4,))
    plan = ptuner.generate_plan(grid, topology=TOPO)
    assert plan.placement() is None
    pplan, _ = both_plans(heavy_tp_mix, R_TOPO)
    plan.meta["placement"] = pplan.to_json()
    again = ptuner.Plan.from_json(plan.to_json())
    assert again.placement().best.assignment == pplan.best.assignment
    ref = rtuner.Plan.from_json(plan.to_json())
    assert ref.placement().best.assignment == pplan.best.assignment


def test_mix_for_model_shapes():
    pcfg, rcfg = _configs("llama3-8b")
    mix = ppl.CollectiveMix.for_model(pcfg, {"data": 4, "model": 8}, **ROOF)
    want = rpl.CollectiveMix.for_model(rcfg, {"data": 4, "model": 8})
    assert [(a.axis, a.size, [c.to_json() for c in a.calls])
            for a in mix.axes] == [(a.axis, a.size, [c.to_json()
                                                     for c in a.calls])
                                   for a in want.axes]
    data, model = mix.axis("data"), mix.axis("model")
    assert {c.primitive for c in model.calls} == {"all_reduce"}
    assert {c.primitive for c in data.calls} == {"all_gather",
                                                 "reduce_scatter"}
    ag = next(c for c in data.calls if c.primitive == "all_gather")
    rs = next(c for c in data.calls if c.primitive == "reduce_scatter")
    assert ag.overlap_s > 0.0 and rs.overlap_s == 0.0
    # the port's default roofline is the H100's: a shorter window
    h100 = ppl.CollectiveMix.for_model(pcfg, {"data": 4, "model": 8})
    h100_ag = next(c for c in h100.axis("data").calls
                   if c.primitive == "all_gather")
    assert 0.0 < h100_ag.overlap_s < ag.overlap_s
    mix1 = ppl.CollectiveMix.for_model(pcfg, {"data": 4, "model": 1})
    assert mix1.axis("model").calls == ()
    with pytest.raises(ValueError):
        ppl.CollectiveMix.for_model(pcfg, {"data": 1, "model": 1})


def test_mix_from_dryrun_record():
    rec = {"ledger": {"auto_choices": [
        {"primitive": "all_reduce", "msg_bytes": 1024, "nranks": 4,
         "calls": 32.0, "level": "model"},
        {"primitive": "all_gather", "msg_bytes": 2048, "nranks": 2,
         "calls": 8.0, "level": None},
    ]}}
    sizes = {"data": 2, "model": 4}
    mix = ppl.CollectiveMix.from_dryrun(rec, axis_sizes=sizes)
    ref = rpl.CollectiveMix.from_dryrun(rec, axis_sizes=sizes)
    assert mix.axis("model").calls[0].calls == 32.0
    assert mix.axis("data").calls[0].primitive == "all_gather"
    assert [(a.axis, a.size, [c.to_json() for c in a.calls])
            for a in mix.axes] == [(a.axis, a.size, [c.to_json()
                                                     for c in a.calls])
                                   for a in ref.axes]
    with pytest.raises(ValueError):
        ppl.CollectiveMix.from_dryrun({"ledger": {}})


# -- applying a placement --------------------------------------------------

def test_placed_topology_and_mesh_spec():
    plan, rplan = both_plans(heavy_tp_mix, R_TOPO)
    best = plan.best            # data->pod+node, model->gpu
    placed = ppl.placed_topology(best, TOPO)
    assert placed.axes == ("pod", "node", "model")
    assert placed.fingerprint() == TOPO.fingerprint()
    assert placed.to_json() == rpl.placed_topology(rplan.best,
                                                   R_TOPO).to_json()
    spec = ppl.mesh_spec(best, heavy_tp_mix(ppl), TOPO)
    assert spec == ((2, 2, 4), ("pod", "node", "model"),
                    {"data": ("pod", "node")})
    assert spec == rpl.mesh_spec(rplan.best, heavy_tp_mix(rpl), R_TOPO)


def test_mesh_spec_appends_size1_axes():
    pcfg, rcfg = _configs("llama3-8b")
    rtopo = RTopology(levels=(RLevel("pod", "ib", shape=(2,)),
                              RLevel("node", "cxl", shape=(2,))))
    plan, rplan = both_plans(
        lambda pl: pl.CollectiveMix.for_model(
            pcfg if pl is ppl else rcfg, {"data": 4, "model": 1},
            **(ROOF if pl is ppl else {})), rtopo)
    mix = ppl.CollectiveMix.for_model(pcfg, {"data": 4, "model": 1}, **ROOF)
    shape, names, aliases = ppl.mesh_spec(plan.best, mix, port(rtopo))
    assert names[-1] == "model" and shape[-1] == 1
    assert set(names) == {"pod", "node", "model"}
    assert (shape, names, aliases) == rpl.mesh_spec(
        rplan.best, rpl.CollectiveMix.for_model(rcfg, {"data": 4,
                                                       "model": 1}), rtopo)


def test_sharding_axis_aliases():
    """The alias registry resolves as the reference's, and param_specs
    built with the logical ``data`` land on the aliased mesh axes, in
    both packages."""
    import jax.numpy as jnp
    import torch

    class _Cfg:
        @staticmethod
        def kv_sharded(tp):
            return True
    try:
        for sh in (psharding, rsharding):
            sh.set_axis_aliases({"data": ("pod", "node")})
            assert sh.resolve_axis("data") == ("pod", "node")
            assert sh.resolve_axis("model") == "model"
            assert sh.resolve_axis(("pod", "data")) == \
                ("pod", "pod", "node")
            assert sh.resolve_axis(None) is None
            sh.set_mesh_sizes({"pod": 2, "node": 2, "model": 4})
        specs = psharding.param_specs({"big": torch.zeros(256, 512)}, _Cfg,
                                      dp_axis="data", fsdp=True)
        rspecs = rsharding.param_specs({"big": jnp.zeros((256, 512))}, _Cfg,
                                       dp_axis="data", fsdp=True)
        assert specs["big"] == (("pod", "node"), None)
        assert tuple(rspecs["big"]) == specs["big"]
    finally:
        for sh in (psharding, rsharding):
            sh.clear_axis_aliases()
        assert psharding.resolve_axis("data") == "data"


def test_format_report_names_the_winner():
    plan, rplan = both_plans(heavy_tp_mix, R_TOPO)
    rep = ppl.format_report(plan)
    assert "chosen" in rep and plan.best.describe() in rep
    assert rep == rpl.format_report(rplan)


# -- the port's launchers --------------------------------------------------

def test_tune_placement_report_embeds_the_ranked_table(tmp_path, capsys):
    """``launch.tune --placement-report llama3.2-1b --placement-axes
    data=4,model=1`` on ``pod:cxl,node:cxl:3+1`` embeds the planner's
    table (the port's H100 roofline); ``Plan.placement()`` reads it back
    and the reference ranks the same assignments."""
    from repro_torch.configs import get_config
    from repro_torch.launch import tune
    spec = "pod:cxl,node:cxl:3+1"
    out = str(tmp_path / "plan.json")
    plan = tune.main(["--smoke", "--nranks", "4", "--quiet", "--topology",
                      spec, "--placement-report", "llama3.2-1b",
                      "--placement-axes", "data=4,model=1", "--out", out])
    assert "data->node" in capsys.readouterr().out
    got = ptuner.load_plan(out).placement()
    topo = ptopo.parse_topology(spec)
    want = ppl.plan_placement(ppl.CollectiveMix.for_model(
        get_config("llama3.2-1b"), {"data": 4, "model": 1}), topo)
    assert got.to_json() == want.to_json() == plan.placement().to_json()
    assert got.best.assignment == (("data", ("node",)),)
    from repro.configs import get_config as rget
    ref = rpl.plan_placement(rpl.CollectiveMix.for_model(
        rget("llama3.2-1b"), {"data": 4, "model": 1}),
        rtopology.parse_topology(spec))
    assert [p.assignment for p in ref.ranked] == \
        [p.assignment for p in got.ranked]
    # the default degrees: the placeable levels' declared sizes
    assert tune.placement_axes(topo) == {"data": 1, "model": 4}
    assert tune.placement_axes(ptopo.parse_topology("a:cxl,b:cxl")) is None
    with pytest.raises(SystemExit):
        tune.main(["--smoke", "--quiet", "--placement-report",
                   "llama3.2-1b", "--out", out])


def test_placed_mesh_and_dp_axes():
    """``make_placed_mesh`` installs the aliases and the placed topology
    and returns the rank-major mesh shape; ``dp_axes`` resolves the
    ``data`` alias.  On ``pod:cxl,node:cxl:3+1`` with llama3.2-1b at
    (data 4, model 1) the placement is ``data -> node``: the flat
    (data, model) = (4, 1) mesh on the placed ``pod:cxl,data:cxl:3+1``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh
    try:
        pplan, _ = both_plans(heavy_tp_mix, R_TOPO)
        shape = mesh.make_placed_mesh(pplan.best, heavy_tp_mix(ppl), TOPO)
        assert shape == (("pod", 2), ("node", 2), ("model", 4))
        assert psharding.resolve_axis("data") == ("pod", "node")
        assert ptopo.get_active_topology().axes == ("pod", "node", "model")
        assert mesh.dp_axes(dict(shape)) == ("pod", "node")
        topo = ptopo.parse_topology("pod:cxl,node:cxl:3+1")
        mix = ppl.CollectiveMix.for_model(get_config("llama3.2-1b"),
                                          {"data": 4, "model": 1})
        chosen = ppl.plan_placement(mix, topo).best_with_unsplit(("model",))
        shape = mesh.make_placed_mesh(chosen, mix, topo)
        assert shape == (("data", 4), ("model", 1)) == mesh.mesh_shape(4)
        placed = ptopo.get_active_topology()
        assert placed.level_for("data").shape == (3, 1)
        assert placed.parent_of("data").axis == "pod"
        assert placed.fingerprint() == topo.fingerprint()
        assert mesh.dp_axes(dict(shape)) == ("data",)
    finally:
        psharding.clear_axis_aliases()
        ptopo.clear_active_topology()


def test_train_placement_reaches_the_spec(capsys):
    """``train --placement auto`` on ``pod:cxl,node:cxl:3+1`` gives the
    spec of the explicit ``--topology pod:cxl,data:cxl:3+1`` run (the
    same mesh, a topology of the same levels and fingerprint), prints
    the report, and refuses what the reference refuses."""
    from repro_torch.launch import train
    ap = train.build_parser()
    base = ["--arch", "llama3.2-1b", "--mesh", "4x1", "--batch", "4",
            "--device", "cpu"]
    placed = train.spec_from_args(ap.parse_args(
        base + ["--topology", "pod:cxl,node:cxl:3+1", "--placement",
                "auto"]))
    assert "data->node" in capsys.readouterr().out
    plain = train.spec_from_args(ap.parse_args(
        base + ["--topology", "pod:cxl,data:cxl:3+1"]))
    assert placed.mesh() == plain.mesh() == (("data", 4), ("model", 1))
    assert placed.topology.to_json() == plain.topology.to_json()
    assert placed.aliases == {}
    with pytest.raises(SystemExit):
        train.spec_from_args(ap.parse_args(base + ["--placement", "auto"]))
    with pytest.raises(SystemExit, match="add --placement auto"):
        train.spec_from_args(ap.parse_args(
            base + ["--topology", "pod:cxl,node:cxl:3+1",
                    "--placement-from-dryrun", "rec.json"]))


def test_serve_placement_installs_aliases_and_topology(capsys):
    """``serve --placement auto`` ranks the topology's placements for
    the model's mix at ``--placement-axes``, prints the report and
    installs the chosen placement's aliases and placed topology, as the
    reference launcher does; without a topology it refuses."""
    from repro_torch.launch import serve
    try:
        serve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                    "--batch", "1", "--prompt-len", "4", "--new-tokens",
                    "1", "--topology", "pod:ib:2,node:cxl:2,gpu:ici:4",
                    "--placement", "auto", "--placement-axes",
                    "data=4,model=4"])
        out = capsys.readouterr().out
        assert "chosen" in out and "llama3.2-smoke" in out
        assert psharding.resolve_axis("data") == ("pod", "node")
        assert ptopo.get_active_topology().axes == ("pod", "node", "model")
    finally:
        psharding.clear_axis_aliases()
        ptopo.clear_active_topology()
    with pytest.raises(SystemExit):
        serve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                    "--placement", "auto"])
