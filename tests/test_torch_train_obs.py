"""The training launcher's observability and online re-tuning on 4 gloo
CPU ranks, against the reference's tuner.

One spawn of the ranks (``train.run_many``) runs three launcher flag
sets of ``llama3.2-smoke`` over ``--mesh 2x2 --topology data:cxl,model:cxl``
under ``--backend auto`` on ``tune --smoke --nranks 2``'s plan:

* ``emulator``: ``--online-retune --retune-interval 1 --timing-source
  emulator --emu-degrade model@cxl=EMU_F --metrics-out --trace-out
  --plan-out`` over 4 steps.  ``EMU_F`` is the smallest factor of 4, 8,
  16 at which the reference's emulator and tuner, fed the run's audit,
  flip a model-level cell off cxl.  The reference's ``OnlineTuner``, fed
  the port's sample stream boundary by boundary, refreshes to the same
  plans: the same cells flip at the same refresh, with every cell's knobs,
  measured EWMA and sample count, and the plan's calibration, equal (the
  port reprices a surviving fused verdict with the H100 roofline, so a
  fused cell's ``predicted_time`` is the one field left out).  Every rank
  runs under the same epoch and refreshes to a byte-identical plan.  The
  metrics stream, its Prometheus rendering and the trace (every rank's
  steps) are checked against the ledger, and ``launch.report`` reads them.
* ``profiler``: ``--online-retune --timing-source profiler``: every step
  books exactly one sample per audited call on every rank;
* ``plain``: the same auto run without a flag of this slice, whose step-0
  loss both observed runs equal bitwise.

Then, without ranks: the launcher's refusals, ``serve --metrics-out
--online-retune`` at tp 1 (the diag event) and ``tune --measurements``
against the reference's ``fold_measurements`` of the same records.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

MESH = ["--mesh", "2x2", "--topology", "data:cxl,model:cxl"]
EMU_F = 4
EMU_STEPS = 4
PROF_STEPS = 3
KNOBS = ("backend", "slicing_factor", "allreduce_mode", "fused",
         "measured_us", "sample_count", "ewma_alpha", "overlap")


def _args(tmp: str, plan: str, extra: list, steps: int) -> list:
    return ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
            "--steps", str(steps), "--batch", "4", "--seq", "32",
            "--backend", "auto", "--plan", plan, *MESH, *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch import train, tune
    tmp = str(tmp_path_factory.mktemp("torch_train_obs"))
    plan = os.path.join(tmp, "plan.json")
    tune.main(["--smoke", "--nranks", "2", "--topology",
               "data:cxl,model:cxl", "--quiet", "--out", plan])
    out = {"tmp": tmp, "plan": plan}
    emu = os.path.join(tmp, "emu")
    prof = os.path.join(tmp, "prof")
    flags = {
        "emulator": _args(tmp, plan, [
            "--online-retune", "--retune-interval", "1",
            "--timing-source", "emulator", "--emu-degrade",
            f"model@cxl={EMU_F}", "--metrics-out", emu + ".jsonl",
            "--trace-out", emu + ".trace.json", "--plan-out",
            emu + ".plan.json"], EMU_STEPS),
        "profiler": _args(tmp, plan, [
            "--online-retune", "--retune-interval", "1",
            "--timing-source", "profiler", "--metrics-out",
            prof + ".jsonl", "--plan-out", prof + ".plan.json"],
            PROF_STEPS),
        "plain": _args(tmp, plan, [], PROF_STEPS)}
    specs = [dataclasses.replace(train.spec_from_args(
        train.build_parser().parse_args(f)), timeout_s=120.0)
        for f in flags.values()]
    for name, res in zip(flags, train.run_many(specs)):
        out[name] = res[0]
    out["paths"] = {"emulator": emu, "profiler": prof}
    return out


def _cells(plan_json: dict) -> dict:
    return {(e["primitive"], e["bucket"], e["nranks"], e.get("level")):
            tuple(e.get(k) for k in KNOBS) for e in plan_json["entries"]}


def _reference_stream(runs, name: str):
    """The reference's tuner fed the port's folded samples, boundary by
    boundary (``retune_interval`` 1): its refreshed plan at each step."""
    from repro import tuner as rtuner
    run = runs[name]
    with open(runs["paths"][name] + ".plan.timings.json") as f:
        samples = json.load(f)["timings"]
    with open(runs["plan"]) as f:
        base = rtuner.Plan.from_json(json.load(f))
    ot = rtuner.OnlineTuner(base, retune_interval=1)
    plans, at = [], 0
    for i, s in enumerate(run["steps"]):
        n = s["obs_per_rank"][0]["samples_folded"]
        ot.observe_timings(samples[at:at + n])
        at += n
        # no refresh after the last step (nothing runs under it)
        plans.append(ot.maybe_retune(i) if i < len(run["steps"]) - 1
                     else None)
    rtuner.clear_active_plan()
    assert at == len(samples)
    return plans, ot


def test_emulator_degrade_factor_is_the_smallest_that_flips(runs):
    """``EMU_F``: fed the run's step-1 audit, the reference's emulator at
    model@cxl=F and its tuner flip a model-level cell off cxl at F =
    EMU_F and at no smaller factor of (4, 8, 16)."""
    from repro import tuner as rtuner
    from repro.core.topology import parse_topology
    from repro.obs import StepEmulator
    with open(runs["plan"]) as f:
        base_json = json.load(f)
    audit = []
    for c in runs["emulator"]["steps"][1]["choices_rank0"]:
        audit += [dict(c, calls=1.0)] * c["calls"]
    topo = parse_topology("data:cxl,model:cxl")
    lkey = topo.level_key("model")

    def flips(factor: float) -> bool:
        base = rtuner.Plan.from_json(base_json)
        ot = rtuner.OnlineTuner(base)
        emu = StepEmulator(topology=topo, noise_std=0.02, seed=0,
                           degrade={"model@cxl": factor})
        for _ in range(2):
            ot.observe_timings(emu.step_timings(audit, book=False))
        new = ot.refresh()
        return any(len(k) == 4 and k[3] == lkey and c.backend != "cxl"
                   and base.lookup(k[0], 1 << k[1], k[2],
                                   level=lkey).backend == "cxl"
                   for k, c in new.entries.items())
    got = [f for f in (4, 8, 16) if flips(float(f))]
    assert got and got[0] == EMU_F


def test_emulator_retune_matches_the_reference_tuner(runs):
    run = runs["emulator"]
    ref_plans, ref_ot = _reference_stream(runs, "emulator")
    flipped_at = []
    for i, (s, want) in enumerate(zip(run["steps"][:-1], ref_plans)):
        got = s["retune_rank0"]
        assert got is not None and want is not None      # interval 1
        w = want.to_json()
        assert _cells(got["plan"]) == _cells(w), f"refresh {i}"
        assert got["plan"]["meta"].get("calibration") == \
            w["meta"].get("calibration")
        assert got["plan"]["meta"]["online"] == w["meta"]["online"]
        if got["swapped"]:
            flipped_at.append(i)
    # a flip happens, at the reference's refresh, and the tuner's readouts
    # are the reference's
    assert flipped_at and flipped_at[0] >= 1
    assert run["obs"]["calibration"] == ref_ot.calibration_export()
    assert run["obs"]["regret_s"] == ref_ot.measured_regret()
    assert run["steps"][-1]["retune_rank0"] is None
    # a model-level cell left cxl
    model_off = [e for e in run["steps"][-2]["retune_rank0"]["plan"]
                 ["entries"] if (e.get("level") or "").startswith("1:")
                 and e["sample_count"] and e["backend"] != "cxl"]
    assert model_off


@pytest.mark.parametrize("name", ["emulator", "profiler"])
def test_ranks_agree_on_epoch_and_plan(runs, name):
    run = runs[name]
    epochs = []
    for s in run["steps"]:
        ob = s["obs_per_rank"]
        assert len({o["plan_epoch"] for o in ob}) == 1
        # every call of the step resolved at the epoch it ran under
        assert all(o["audit_epochs"] == [o["plan_epoch"]] for o in ob)
        rts = s["retune_per_rank"]
        assert len({json.dumps(r, sort_keys=True) for r in rts}) == 1
        epochs.append(ob[0]["plan_epoch"])
    # one refresh a boundary between steps, each one epoch later
    assert epochs == list(range(epochs[0], epochs[0] + len(epochs)))
    keys = ("calibration", "regret_s", "swaps", "final_epoch",
            "plan_out_sha256", "samples_folded")
    assert len({json.dumps({k: o[k] for k in keys}, sort_keys=True)
                for o in run["obs_per_rank"]}) == 1


def test_profiler_books_one_sample_per_call(runs):
    run = runs["profiler"]
    for i, s in enumerate(run["steps"]):
        for o in s["obs_per_rank"]:
            assert o["audit_calls"] > 0
            assert o["timing_samples"] == o["audit_calls"], (i, o)
            # step 0's samples reach the flight recorder, not the tuner
            assert o["samples_folded"] == (0 if i == 0 else
                                           4 * o["audit_calls"])
    plans, _ = _reference_stream(runs, "profiler")
    for s, want in zip(run["steps"][:-1], plans):
        assert _cells(s["retune_rank0"]["plan"]) == _cells(want.to_json())
    from repro_torch import tuner
    refined = tuner.load_plan(runs["paths"]["profiler"] + ".plan.json")
    assert any(c.sample_count > 0 for c in refined.entries.values())


def test_losses_fall_and_match_without_timing(runs):
    """Timing does not touch the numbers: step 0 of both observed runs
    equals the plain auto run's bitwise (same plan, same choices); the
    profiler run's later steps, under refreshed plans whose other
    backends sum in other orders, within rtol 1e-4; every loss falls."""
    a = [s["loss"] for s in runs["emulator"]["steps"]]
    b = [s["loss"] for s in runs["profiler"]["steps"]]
    c = [s["loss"] for s in runs["plain"]["steps"]]
    assert a[0] == b[0] == c[0]
    np.testing.assert_allclose(b, c, rtol=1e-4)
    assert a[-1] < a[0] and b[-1] < b[0]


def test_metrics_and_trace_files(runs):
    from repro_torch.launch import report
    from repro_torch.obs import MetricsRegistry, from_ledger
    run, base = runs["emulator"], runs["paths"]["emulator"]
    events = report.load_events(base + ".jsonl")
    kinds = [e["kind"] for e in events]
    assert kinds.count("step") == EMU_STEPS
    assert kinds.count("retune") == EMU_STEPS - 1
    steps = [e for e in events if e["kind"] == "step"]
    assert [e["loss"] for e in steps] == [s["loss"] for s in run["steps"]]
    assert steps[0]["timing_samples"] == 0
    assert all(e["timing_samples"] == 4 * e["rank_samples"] > 0
               for e in steps[1:])
    # the gauges are from_ledger of rank 0's last ledger snapshot
    reg = MetricsRegistry()
    from_ledger(reg, run["obs"]["ledger"])
    want = {(m["name"], json.dumps(m["labels"], sort_keys=True)): m["value"]
            for m in map(json.loads, reg.to_jsonl().splitlines())}
    got = {(e["name"], json.dumps(e["labels"], sort_keys=True)): e["value"]
           for e in events if e["kind"] == "metric" and (
               e["name"], json.dumps(e["labels"], sort_keys=True)) in want}
    assert got == want and want
    for kind, b in run["steps"][-1]["wire_bytes_rank0"].items():
        assert want[("repro_wire_bytes", json.dumps({"kind": kind}))] == b
    with open(base + ".prom") as f:
        prom = f.read()
    assert f"repro_steps_total {EMU_STEPS}" in prom
    with open(base + ".trace.json") as f:
        doc = json.load(f)
    meta = doc["metadata"]
    assert meta["ranks"] == 4
    assert meta["steps_retained_by_rank"] == [list(range(EMU_STEPS))] * 4
    coll = [e for e in doc["traceEvents"] if e.get("cat") == "collective"]
    per_rank = [sum(o["timing_samples"] for o in
                    (s["obs_per_rank"][r] for s in run["steps"]))
                for r in range(4)]
    assert [sum(e["pid"] == r for e in coll) for r in range(4)] == per_rank
    text = report.summarize(events) + "\n" + report.summarize_trace(
        base + ".trace.json")
    assert f"retunes: {EMU_STEPS - 1} boundaries" in text
    assert f"steps retained {list(range(EMU_STEPS))}" in text


def test_launcher_refusals():
    from repro_torch.launch import train
    ap = train.build_parser()
    base = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu"]
    for extra, match in (
            (["--online-retune"], "requires --backend auto"),
            (["--backend", "auto", "--ewma-decay", "0.1"], "--online-retune"),
            (["--timing-source", "profiler"], "--backend auto"),
            (["--backend", "auto", "--online-retune", "--pp-stages", "2",
              "--batch", "8"], "--online-retune"),
            (["--backend", "auto", "--timing-source", "emulator",
              "--pp-stages", "2", "--batch", "8"], "--timing-source"),
            (["--backend", "auto", "--timing-source", "profiler",
              "--topology", "pod:cxl,data:cxl:3+1"], "grouped"),
            (["--resilience", "--pp-stages", "2", "--batch", "8"],
             "--resilience"),
            (["--fault-plan", "rank_death@1:rank=0", "--pp-stages", "2",
              "--batch", "8"], "--fault-plan"),
            (["--pool-ckpt-interval", "-3"], "--pool-ckpt-interval")):
        with pytest.raises(SystemExit, match=match):
            train.spec_from_args(ap.parse_args(base + extra))
    spec = train.spec_from_args(ap.parse_args(base + [
        "--backend", "auto", "--online-retune", "--emu-degrade",
        "model@cxl=4,*=0.5", "--timing-source", "emulator"]))
    assert spec.obs.emu_degrade == (("model@cxl", 4.0), ("*", 0.5))
    assert train.spec_from_args(ap.parse_args(base)).obs is None


def test_serve_metrics_diag_at_tp1(runs, capsys):
    from repro_torch.launch import report, serve
    out = os.path.join(runs["tmp"], "serve.jsonl")
    res = serve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--new-tokens",
                      "3", "--metrics-out", out, "--online-retune",
                      "--plan", runs["plan"], "--retune-interval", "1"])
    events = report.load_events(out)
    diags = [e["msg"] for e in events if e["kind"] == "diag"]
    assert any("issued no auto collectives" in m for m in diags)
    assert any("engine is unsharded" in m for m in diags)
    assert [e["kind"] for e in events].count("step") == 2
    assert [e for e in events if e["kind"] == "retune"][-1]["swapped"] \
        is False
    # the serving gauges are the engine's counters
    metric = {e["name"]: e["value"] for e in events if e["kind"] == "metric"}
    eng = res["engine"]
    for k in ("finished", "evictions", "restores", "replays", "prefix_hits",
              "prefix_publishes"):
        assert metric[f"repro_serve_{k}_total"] == eng.counters[k]
    assert "diagnostics: 2" in report.summarize(events)


def test_tune_measurements_fold_matches_reference(runs):
    """``tune --measurements`` of the run's samples against the
    reference's ``fold_measurements`` of the same records over the same
    grid and topology: the same measured cells, each with the same knobs,
    EWMA and sample count; and the run's own ``--plan-out`` measured the
    same cells."""
    from repro import tuner as rtuner
    from repro.core.topology import parse_topology as rparse
    from repro_torch.launch import tune
    timings = runs["paths"]["emulator"] + ".plan.timings.json"
    out = os.path.join(runs["tmp"], "folded.json")
    mine = tune.main(["--smoke", "--nranks", "2", "--topology",
                      "data:cxl,model:cxl", "--quiet", "--out", out,
                      "--measurements", timings])
    with open(timings) as f:
        recs = json.load(f)["timings"]
    grid = dataclasses.replace(rtuner.SMOKE_GRID, nranks=(2,))
    ref = rtuner.fold_measurements(rtuner.generate_plan(
        grid, topology=rparse("data:cxl,model:cxl")), recs)

    def measured(plan_json):
        return {k: v for k, v in _cells(plan_json).items() if v[5]}
    got = measured(mine.to_json())
    assert got and got == measured(ref.to_json())
    with open(runs["paths"]["emulator"] + ".plan.json") as f:
        assert measured(json.load(f)) == got
    assert mine.meta["calibration"] == ref.meta["calibration"]
    assert np.isfinite([v[4] for v in got.values()]).all()
