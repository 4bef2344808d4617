"""The port's pipeline-parallel training against the JAX reference:
``repro_torch.launch.train.run_many`` on gloo CPU ranks over the
rank-major mesh ``(("stage", S), ("data", D))`` against
``repro.training.pipeline.make_sharded_pipeline_step`` on the same
``("stage", "data")`` mesh of forced host devices (in subprocesses),
from the same numpy params (made by the reference) and the same
synthetic batches.

Runs (each variant its own spec; the specs of one spawn's rank groups
share one spawn of the ranks):

* ``tiny22``: ``tiny-pp`` (4 rows, as ``_mesh_runner.check_pipeline_train``'s)
  at (2, 2), B = 8, L = 16, M = 2: ring and cxl with remat and without,
  the interleaved schedule, and auto on ``repro.launch.tune --smoke
  --nranks 2 --topology stage:ib,data:cxl``'s plan with that topology
  active (the others under ``stage:cxl,data:cxl``); ``adamw1``: one
  step at lr 1e-3, ring, no remat, against the port's own flat FSDP
  step on 4 ranks (``flat1``), as ``check_pipeline_train`` holds them;
* ``tiny41``: ``tiny-pp`` at (4, 1), ring and cxl; ``tiny21`` at (2, 1),
  ring;
* ``llama22``: ``llama3.2-smoke`` (tied embedding) at (2, 2), ring,
  cxl and auto;
* ``granite22``: ``granite-moe-smoke`` at (2, 2), ring, cxl and auto:
  the only path of the routers' loss through the stage-axis share.

Per variant: the loss of each of 3 steps against the reference's
pipelined step (``REF_VARIANTS``: its ring, and auto where it has one;
rtol 1e-4), the step-0 synced grads
against the reference's (read back from its first AdamW moment, ``mu /
(1 - b1)``) and, for the dense runs, against ``jax.grad`` of the
reference's UNSHARDED loss on the same batch (rtol 1e-4, atol 1e-5;
``test_reference_pipeline_grads_against_unsharded`` pins that the
reference's own pipelined grads are those).  Granite's grads are held to
the reference's pipelined ones only: its router loss and expert capacity
are per microbatch and per data rank, as in the reference, so they are
not the unsharded batch's.  The ledger: ``p2p`` bytes at the stage level
only, all-reduce at data, every auto ``p2p`` choice at the stage level,
and each level's bytes by both packages' trip counts.

Also runnable as a script: ``python tests/test_torch_train_pipeline.py
--reference OUT.npz TMPDIR GROUP`` (GROUP an index of ``REF_GROUPS``).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
B1 = 0.9
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
ADAMW_PARAM_ATOL = 5e-4
TOPO_CXL = "stage:cxl,data:cxl"
TOPO_IB = "stage:ib,data:cxl"

# run -> model, (stages, data), steps, batch, seq, microbatches, variants
# (each: backend, remat, schedule, topology; the reference variant it is
# held to)
RUNS = {
    "tiny22": dict(arch="tiny-pp", stages=2, data=2, steps=3, batch=8,
                   seq=16, mb=2, variants={
                       "ring": dict(backend="ring", remat=False),
                       "ring_remat": dict(backend="ring", remat=True),
                       "ring_interleaved": dict(backend="ring", remat=False,
                                                schedule="interleaved"),
                       "cxl": dict(backend="cxl", remat=True),
                       "cxl_noremat": dict(backend="cxl", remat=False),
                       "auto": dict(backend="auto", remat=False,
                                    topology=TOPO_IB)}),
    "tiny41": dict(arch="tiny-pp", stages=4, data=1, steps=3, batch=8,
                   seq=16, mb=2, variants={
                       "ring": dict(backend="ring", remat=False),
                       "cxl": dict(backend="cxl", remat=True)}),
    "tiny21": dict(arch="tiny-pp", stages=2, data=1, steps=3, batch=8,
                   seq=16, mb=2, variants={
                       "ring": dict(backend="ring", remat=False)}),
    "llama22": dict(arch="llama3.2-1b", stages=2, data=2, steps=3, batch=8,
                    seq=16, mb=2, variants={
                        "ring": dict(backend="ring", remat=True),
                        "cxl": dict(backend="cxl", remat=False),
                        "auto": dict(backend="auto", remat=True,
                                     topology=TOPO_IB)}),
    "granite22": dict(arch="granite-moe-3b-a800m", stages=2, data=2, steps=3,
                      batch=8, seq=16, mb=2, variants={
                          "ring": dict(backend="ring", remat=True),
                          "cxl": dict(backend="cxl", remat=True),
                          "auto": dict(backend="auto", remat=True,
                                       topology=TOPO_IB)}),
}
# the reference's variants (each a compile of its step: the time of this
# module): its backends do the same arithmetic and move the same bytes,
# its schedules take the same arithmetic, remat changes only rounding and
# the ledger's trip counts, so each port variant is held to one of these
REF_VARIANTS = {
    "tiny22": {"ring": dict(backend="ring", remat=False),
               "auto": dict(backend="auto", remat=True, topology=TOPO_IB)},
    "tiny41": {"ring": dict(backend="ring", remat=False)},
    "tiny21": {"ring": dict(backend="ring", remat=False)},
    "llama22": {"ring": dict(backend="ring", remat=True)},
    "granite22": {"ring": dict(backend="ring", remat=True)},
}
CASES = [(run, v) for run, r in RUNS.items() for v in r["variants"]]
DENSE = ("tiny22", "tiny41", "tiny21", "llama22")
REF_GROUPS = (("tiny22", "tiny41", "tiny21"), ("llama22", "granite22"))


def _held_to(run: str, variant: str) -> str:
    """The reference variant a port variant is held to: its auto, else
    its ring."""
    return variant if variant in REF_VARIANTS[run] else "ring"


def model_config(arch: str, torch_side: bool = True):
    """``arch``'s smoke config in either package, or ``tiny-pp``."""
    if arch == "tiny-pp":
        if torch_side:
            from repro_torch.models.config import ModelConfig, dense_pattern
        else:
            from repro.models.config import ModelConfig, dense_pattern
        return ModelConfig(name="tiny-pp", family="dense", n_layers=4,
                           d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                           vocab_size=96, layer_pattern=dense_pattern(4))
    if torch_side:
        from repro_torch.configs import get_config
    else:
        from repro.configs import get_config
    return get_config(arch, smoke=True)


def _tcfg_kwargs(run: str, fields: dict, plan_path: str) -> dict:
    r = RUNS[run]
    return dict(lr=3e-4, warmup=min(20, r["steps"] // 5),
                total_steps=r["steps"], clip_norm=None,
                backend=fields["backend"], remat=fields["remat"],
                plan_path=plan_path if fields["backend"] == "auto" else None)


def topology_json(spec: str) -> dict:
    from repro.core.topology import parse_topology
    return parse_topology(spec).to_json()


def _load_tree(path: str) -> dict:
    import jax.numpy as jnp
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    out: dict = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return out


def _grads_from_mu(opt) -> dict:
    import jax
    return {"/".join(p.key for p in path): np.asarray(mu) / np.float32(1 - B1)
            for path, mu in jax.tree_util.tree_leaves_with_path(opt.mu)}


def reference_main(out_path: str, tmp: str, group: str) -> None:
    """The reference side of the runs of ``REF_GROUPS[group]``, in a
    process with 8 forced host devices."""
    import jax
    import jax.numpy as jnp

    from repro.core import ledger
    from repro.core.topology import (clear_active_topology, parse_topology,
                                     set_active_topology)
    from repro.data.pipeline import SyntheticTokens
    from repro.optim import adamw_init
    from repro.training.pipeline import make_sharded_pipeline_step
    from repro.training.train_loop import TrainConfig, make_train_step

    out = {}
    plan_path = os.path.join(tmp, "plan.json")
    unsharded: dict = {}
    for run in REF_GROUPS[int(group)]:
        r = RUNS[run]
        cfg = model_config(r["arch"], torch_side=False)
        params0 = _load_tree(os.path.join(tmp, f"{run}.npz"))
        batches = [{k: jnp.asarray(v) for k, v in b.items()} for _, b in zip(
            range(r["steps"]), SyntheticTokens(cfg, batch=r["batch"],
                                               seq=r["seq"]))]
        mesh = jax.make_mesh((r["stages"], r["data"]), ("stage", "data"),
                             devices=jax.devices()[:r["stages"] * r["data"]])
        for name, fields in REF_VARIANTS[run].items():
            set_active_topology(parse_topology(os.path.join(
                tmp, "ib.json" if fields.get("topology") == TOPO_IB
                else "cxl.json")))
            tcfg = TrainConfig(**_tcfg_kwargs(run, fields, plan_path))
            step, _, _, _ = make_sharded_pipeline_step(
                cfg, tcfg, mesh, n_microbatches=r["mb"])
            params, opt = params0, adamw_init(params0)
            losses = []
            for i, b in enumerate(batches):
                ledger.reset()
                params, opt, m = step(params, opt, b)
                losses.append(float(m["loss"]))
                if i == 0:      # the first call traced: the step's ledger
                    snap = ledger.snapshot()
                    key = f"{run}|{name}"
                    out[f"{key}|levels"] = np.asarray(json.dumps(
                        snap["level_wire_bytes"]))
                    out[f"{key}|choices"] = np.asarray(json.dumps(sorted(
                        {(c["primitive"], c["level"], c["fabric"],
                          c["backend"]) for c in snap["auto_choices"]})))
                    out[f"{key}|bubble"] = np.float64(m["bubble_fraction"])
                    for k, g in _grads_from_mu(opt).items():
                        out[f"{key}|grad|{k}"] = g
            out[f"{run}|{name}|loss"] = np.asarray(losses)
        clear_active_topology()
        if run not in DENSE:
            continue
        # jax.grad of the unsharded loss on the same params and batch
        # (the same for the runs of one model, batch and sequence)
        key = (r["arch"], r["batch"], r["seq"])
        if key not in unsharded:
            ustep = jax.jit(make_train_step(cfg, TrainConfig(
                lr=3e-4, warmup=0, total_steps=1, clip_norm=None,
                remat=False)))
            _, uopt, _ = ustep(params0, adamw_init(params0), batches[0])
            unsharded[key] = _grads_from_mu(uopt)
        for k, g in unsharded[key].items():
            out[f"{run}|unsharded|grad|{k}"] = g
    np.savez(out_path, **out)


def _spec(train, run: str, fields: dict, tmp: str, plan_path: str,
          **over):
    from repro_torch.core.topology import parse_topology
    from repro_torch.training.train_loop import TrainConfig
    r = RUNS[run]
    kw = dict(arch=r["arch"] if r["arch"] != "tiny-pp" else "llama3.2-1b",
              smoke=True, config=model_config(r["arch"]),
              variants=(TrainConfig(microbatches=r["mb"], **_tcfg_kwargs(
                  run, fields, plan_path)),),
              steps=r["steps"], batch=r["batch"], seq=r["seq"],
              dp=r["stages"] * r["data"], tp=1, device="cpu",
              topology=parse_topology(fields.get("topology", TOPO_CXL)),
              params_path=os.path.join(tmp, f"{run}.npz"),
              capture_grads=True, timeout_s=120.0,
              pp_stages=r["stages"],
              pp_schedule=fields.get("schedule", "1f1b"))
    kw.update(over)
    return train.RunSpec(**kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from repro.launch import tune as jax_tune
    from repro.models import model as jax_model
    from repro_torch.launch import train
    from repro_torch.training.train_loop import TrainConfig

    tmp = str(tmp_path_factory.mktemp("torch_train_pipeline"))
    ref_path = os.path.join(tmp, "reference.npz")
    plan_path = os.path.join(tmp, "plan.json")
    for name, spec in (("cxl", TOPO_CXL), ("ib", TOPO_IB)):
        with open(os.path.join(tmp, f"{name}.json"), "w") as f:
            json.dump(topology_json(spec), f)
    argv = sys.argv
    try:
        sys.argv = ["tune", "--smoke", "--nranks", "2", "--quiet",
                    "--topology", os.path.join(tmp, "ib.json"),
                    "--out", plan_path]
        jax_tune.main()
    finally:
        sys.argv = argv
    for run, r in RUNS.items():
        jparams = jax_model.init_params(
            jax.random.key(7), model_config(r["arch"], torch_side=False),
            tp=1, dtype=jnp.float32)
        train.save_params_npz(jax.tree.map(np.asarray, jparams),
                              os.path.join(tmp, f"{run}.npz"))

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    refs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--reference",
         f"{ref_path}.{g}.npz", tmp, str(g)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for g in range(len(REF_GROUPS))]
    try:
        # one spawn a mesh's rank groups: (2, 2), (4, 1) beside the flat
        # 4-rank FSDP step (the same groups: none but the world), (2, 1)
        by_spawn = {22: [], 41: [], 21: []}
        for run, r in RUNS.items():
            for name, fields in r["variants"].items():
                by_spawn[10 * r["stages"] + r["data"]].append(
                    ((run, name), _spec(train, run, fields, tmp, plan_path)))
        one = dict(variants=(TrainConfig(lr=1e-3, warmup=0, total_steps=1,
                                         clip_norm=None, remat=False,
                                         backend="ring", microbatches=2),),
                   steps=1, capture_params=True)
        ring = dict(backend="ring", remat=False)
        by_spawn[22].append((("tiny22", "adamw1"), _spec(
            train, "tiny22", ring, tmp, plan_path, **one)))
        one["variants"] = (TrainConfig(lr=1e-3, warmup=0, total_steps=1,
                                       clip_norm=None, remat=False,
                                       backend="ring"),)
        by_spawn[41].append((("tiny22", "flat1"), _spec(
            train, "tiny22", ring, tmp, plan_path, pp_stages=1, topology=None,
            **one)))
        mine = {}
        for items in by_spawn.values():
            got = train.run_many([sp for _, sp in items])
            for (key, _), res in zip(items, got):
                mine[key] = res[0]
        logs = [ref.communicate(timeout=400)[0] for ref in refs]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    reference = {}
    for g, (ref, log) in enumerate(zip(refs, logs)):
        assert ref.returncode == 0, log[-3000:]
        with np.load(f"{ref_path}.{g}.npz") as f:
            reference.update({k: f[k] for k in f.files})
    return mine, reference


def _full(run: str, per_rank: list) -> dict:
    """Every rank's leaves (rank r at stage r // D, data r % D) -> the
    GLOBAL arrays: a ``g*`` leaf concatenates its stage slabs along its
    row dim; every other leaf, and every leaf across the data ranks of a
    stage, must agree bitwise."""
    S, D = RUNS[run]["stages"], RUNS[run]["data"]
    out = {}
    for k in per_rank[0]:
        slabs = []
        for s in range(S):
            for d in range(1, D):
                np.testing.assert_array_equal(per_rank[s * D + d][k],
                                              per_rank[s * D][k])
            slabs.append(per_rank[s * D][k])
        if k.startswith("g"):
            out[k] = np.concatenate(slabs, 0)
        else:
            for x in slabs[1:]:
                np.testing.assert_array_equal(x, slabs[0])
            out[k] = slabs[0]
    return out


def _ref_tree(reference: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in reference.items()
            if k.startswith(prefix)}


def _assert_grads(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("run,variant", CASES)
def test_losses_match_reference(runs, run, variant):
    mine, reference = runs
    got = np.asarray([s["loss"] for s in mine[run, variant]["steps"]])
    np.testing.assert_allclose(
        got, reference[f"{run}|{_held_to(run, variant)}|loss"],
        rtol=LOSS_RTOL)
    assert got[-1] < got[0]          # the loss falls over the steps


@pytest.mark.parametrize("run,variant", CASES)
def test_synced_grads_match_reference(runs, run, variant):
    mine, reference = runs
    got = _full(run, mine[run, variant]["grads"])
    _assert_grads(got, _ref_tree(
        reference, f"{run}|{_held_to(run, variant)}|grad|"))
    if run in DENSE:
        _assert_grads(got, _ref_tree(reference, f"{run}|unsharded|grad|"))


@pytest.mark.parametrize("run", DENSE)
def test_reference_pipeline_grads_against_unsharded(runs, run):
    """The reference's pipelined step-0 grads (stage sync and data mean
    taken) are ``jax.grad`` of its unsharded loss on the same batch, with
    no uniform factor (ratio of norms 1 within 1e-5)."""
    _, reference = runs
    want = _ref_tree(reference, f"{run}|unsharded|grad|")
    for variant in REF_VARIANTS[run]:
        got = _ref_tree(reference, f"{run}|{variant}|grad|")
        _assert_grads(got, want)
        for k in want:
            ratio = np.linalg.norm(got[k]) / np.linalg.norm(want[k])
            assert abs(ratio - 1) < 1e-5, (variant, k, ratio)


def test_schedules_and_remat_take_the_same_arithmetic(runs):
    """The schedule steers only the bubble accounting, remat only what is
    recomputed: the losses of 1F1B and interleaved are bitwise equal, and
    with and without remat within f32 rounding; every step reports its
    schedule's bubble fraction, as the reference's does."""
    mine, reference = runs
    from repro_torch.training.pipeline import bubble_fraction
    losses = {v: [s["loss"] for s in mine["tiny22", v]["steps"]]
              for v in RUNS["tiny22"]["variants"]}
    assert losses["ring"] == losses["ring_interleaved"]
    np.testing.assert_allclose(losses["ring_remat"], losses["ring"],
                               rtol=1e-6)
    for run, r in RUNS.items():
        for v, fields in r["variants"].items():
            sched = fields.get("schedule", "1f1b")
            want = bubble_fraction(r["stages"], r["mb"], sched)
            for s in mine[run, v]["steps"]:
                assert s["bubble_fraction"] == want
    assert bubble_fraction(2, 2) == pytest.approx(1 / 3)
    for run in REF_VARIANTS:
        for v in REF_VARIANTS[run]:
            r = RUNS[run]
            assert float(reference[f"{run}|{v}|bubble"]) == pytest.approx(
                bubble_fraction(r["stages"], r["mb"]))


def test_one_adamw_step_matches_the_flat_fsdp_step(runs):
    """``check_pipeline_train``'s comparison on the port: one AdamW step
    (lr 1e-3, ring, no remat) of the (2, 2) pipeline and of the flat
    4-rank FSDP step on the same global batch, the losses within 1e-5
    and the params within 5e-4 (AdamW's first step is about lr x sign
    of the grad)."""
    from repro_torch.core import tree
    from repro_torch.launch import train
    from repro_torch.models import model, sharding
    mine, _ = runs
    pp, flat = mine["tiny22", "adamw1"], mine["tiny22", "flat1"]
    assert abs(pp["steps"][0]["loss"] - flat["steps"][0]["loss"]) < 1e-5
    got = _full("tiny22", pp["params"])
    cfg = model_config("tiny-pp")
    sharding.set_mesh_sizes({"data": 4, "model": 1})
    specs = sharding.param_specs(model.abstract_params(cfg), cfg,
                                 dp_axis="data")
    layouts = [{"specs": {"/".join(p): s
                          for p, s in tree.leaves_with_paths(specs)},
                "dp_axis": "data", "tp_axis": "model", "dp_index": r,
                "n_dp": 4, "tp_index": 0, "tp": 1} for r in range(4)]
    want = {"/".join(p): x for p, x in tree.leaves_with_paths(
        train.assemble_params(flat["params"], layouts))}
    assert sorted(got) == sorted(want)
    worst = max(float(np.max(np.abs(got[k] - want[k]))) for k in want)
    assert worst < ADAMW_PARAM_ATOL, worst


def _level_terms(run: str) -> dict:
    """The ledger's bytes of one step's calls (all-reduce 2 s (n - 1) /
    n, p2p s): an activation hop of (B / (D M), L, d_model) f32 over the
    stage axis, a scalar AllReduce over each axis, the stage sync of the
    embedding and final norm leaves, the data mean of every local leaf."""
    from repro_torch.core import tree
    from repro_torch.models import model
    r = RUNS[run]
    S, D = r["stages"], r["data"]
    cfg = model_config(r["arch"])
    ar = lambda s, n: 2 * s * (n - 1) / n    # noqa: E731
    leaves = tree.leaves_with_paths(model.abstract_params(cfg))
    nbytes = {p: x.numel() * 4 // (S if p[0].startswith("g") else 1)
              for p, x in leaves}
    return {"ticks": r["mb"] + S - 1,
            "hop": r["batch"] // (D * r["mb"]) * r["seq"] * cfg.d_model * 4,
            "scalar_stage": ar(4, S), "scalar_data": ar(4, D),
            "sync_stage": sum(ar(b, S) for p, b in nbytes.items()
                              if not p[0].startswith("g")),
            "sync_data": sum(ar(b, D) for b in nbytes.values())}


def _flat(levels: dict) -> dict:
    return {(lv, prim): b for lv, c in levels.items() for prim, b in c.items()}


@pytest.mark.parametrize("run,variant", CASES)
def test_level_bytes_follow_the_trip_counts(runs, run, variant):
    """Every byte on its level: ``p2p`` at the stage level only, none at
    data, all-reduce at data.  The reference books at trace time:
    everything inside ``value_and_grad`` k times (2, or 3 with remat: the
    handoff under ``ledger.scale(ticks)``, the loss's two stage shares
    and its data mean), the grad syncs once.  The port books each call
    as it runs: the 2 x ticks hops (a send every forward tick, a recv
    every reverse tick), the two shares and the data mean once (the
    value only: the reverse pipeline is seeded with their cotangent),
    the syncs once."""
    mine, reference = runs
    r = RUNS[run]
    got = mine[run, variant]["steps"][0]["level_wire_bytes_rank0"]
    c = _level_terms(run)
    fields = r["variants"][variant]
    stage = "stage/" + ("ib" if fields.get("topology") == TOPO_IB else "cxl")
    want_port = {stage: {"p2p": 2 * c["ticks"] * c["hop"],
                         "all_reduce": 2 * c["scalar_stage"]
                         + c["sync_stage"]}}
    if r["data"] > 1:
        want_port["data/cxl"] = {"all_reduce": c["scalar_data"]
                                 + c["sync_data"]}
    assert _flat(got) == pytest.approx(_flat(want_port))
    ref_name = _held_to(run, variant)
    ref = json.loads(str(reference[f"{run}|{ref_name}|levels"]))
    ref_fields = REF_VARIANTS[run][ref_name]
    k = 3 if ref_fields["remat"] else 2
    stage = "stage/" + ("ib" if ref_fields.get("topology") == TOPO_IB
                        else "cxl")
    want_ref = {stage: {"p2p": k * c["ticks"] * c["hop"],
                        "all_reduce": k * 2 * c["scalar_stage"]
                        + c["sync_stage"]}}
    if r["data"] > 1:
        want_ref["data/cxl"] = {"all_reduce": k * c["scalar_data"]
                                + c["sync_data"]}
    assert _flat(ref) == pytest.approx(_flat(want_ref))


@pytest.mark.parametrize("run", [run for run in RUNS
                                 if "auto" in RUNS[run]["variants"]])
def test_auto_resolves_the_stage_handoff_at_the_stage_level(runs, run):
    """Under auto with ``stage:ib,data:cxl`` every p2p call resolved at
    the stage level (the ib fabric: ring, no pool), every all-reduce at
    its own level, as the reference's audit; the stage level's pool moved
    nothing, the data level's moved the grads."""
    mine, reference = runs
    for i, s in enumerate(mine[run, "auto"]["steps"]):
        p2p = [c for c in s["choices_rank0"] if c["primitive"] == "p2p"]
        assert p2p and all(c["level"] == "stage" and c["fabric"] == "ib"
                           and c["backend"] == "ring" for c in p2p), i
        assert all(c["level"] in ("stage", "data")
                   for c in s["choices_rank0"])
        assert s["pool_by_level"].get("stage", {}).get("retrieved", 0) == 0
        assert s["pool_by_level"]["data"]["retrieved"] > 0
    if "auto" in REF_VARIANTS[run]:
        want = {tuple(c) for c in json.loads(
            str(reference[f"{run}|auto|choices"]))}
        got = {(c["primitive"], c["level"], c["fabric"], c["backend"])
               for c in mine[run, "auto"]["steps"][0]["choices_rank0"]}
        assert got == want


@pytest.mark.parametrize("run", [run for run in RUNS
                                 if "cxl" in RUNS[run]["variants"]])
def test_cxl_moves_the_handoff_through_the_stage_pool(runs, run):
    """Under cxl both levels' pools move bytes: the stage pool the hops
    (and the embedding's stage sync), the data pool the grads."""
    mine, _ = runs
    for s in mine[run, "cxl"]["steps"]:
        assert s["pool_by_level"]["stage"]["retrieved"] > 0
        if RUNS[run]["data"] > 1:
            assert s["pool_by_level"]["data"]["retrieved"] > 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--reference":
        reference_main(sys.argv[2], sys.argv[3], sys.argv[4])
    else:
        raise SystemExit(__doc__)
