"""The port's FSDP training over a hierarchical data axis against the JAX
reference: the smoke Llama on 4 gloo CPU ranks through
``repro_torch.launch.train.run_ranks`` with ``--multi-pod`` (the data
axis is ``("pod", "data")`` = (2, 2)) and the topology ``pod:cxl,
data:ici``, against ``repro.training.train_loop.make_sharded_train_step``
on a (2, 2, 1) ``("pod", "data", "model")`` mesh with ``dp_axis=("pod",
"data")`` and the same topology active (4 forced host devices, in a
subprocess).  The topology is a JSON file that gives the ``ici`` level
the reference's link constants, so both packages fingerprint its level
alike and the ``auto`` variant resolves the same plan cells (a plan
written by ``repro.launch.tune --smoke --nranks 2 --topology FILE``).

Per variant (ring, cxl, cxl with fused kernels, auto): the loss of each
of 3 steps (rtol 1e-4) and the step-0 synced grads (rtol 1e-4, atol
1e-5; the reference's read back from its first AdamW moment), the
losses against the reference's flat 4x1 cxl run (rtol 1e-4), the
ledger's bytes of each level against the reference's trip counts, and
the pool bytes of each level.

Also runnable as a script: ``python tests/test_torch_train_hierarchical.py
--reference OUT.npz PARAMS.npz PLAN.json TOPOLOGY.json``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ARCH, STEPS, BATCH, SEQ, DP = "llama3.2-1b", 3, 8, 32, 4
B1 = 0.9
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
DP_AXES = ("pod", "data")

TUNED = "<the tuned plan>"     # stands for the fixture's plan path
VARIANTS = {
    "ring": dict(backend="ring"),
    "cxl": dict(backend="cxl"),
    "cxl-fused": dict(backend="cxl", fuse_kernels=True),
    "auto": dict(backend="auto", plan_path=TUNED),
}
# the loss mean's AllReduce of one f32 scalar over (pod, data) = (2, 2),
# decomposed: padded to 8 bytes, reduce-scattered over data (4 wire
# bytes), all-reduced over pod on 4 bytes (4, either mode at n = 2) and
# all-gathered over data (4)
LOSS_AR = {"data": {"reduce_scatter": 4.0, "all_gather": 4.0},
           "pod": {"all_reduce": 4.0}}


def _tcfg_kwargs(fields: dict, plan_path: str) -> dict:
    return dict(lr=3e-4, warmup=min(20, STEPS // 5), total_steps=STEPS,
                clip_norm=None, **{k: plan_path if v == TUNED else v
                                   for k, v in fields.items()})


def reference_topology_json() -> dict:
    """``pod:cxl,data:ici`` with the reference's ICI constants written
    out, so the port's copy of the topology fingerprints alike."""
    import dataclasses

    from repro.core.hw import ICI
    from repro.core.topology import Level, Topology
    return Topology(levels=(Level("pod", "cxl"), Level(
        "data", "ici", ici=dataclasses.replace(ICI)))).to_json()


def reference_main(out_path: str, params_path: str, plan_path: str,
                   topo_path: str) -> None:
    """The reference side, in a process with 4 forced host devices."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.core import ledger
    from repro.core.topology import (clear_active_topology, parse_topology,
                                     set_active_topology)
    from repro.data.pipeline import SyntheticTokens
    from repro.launch.mesh import dp_axes
    from repro.optim import adamw_init
    from repro.training.train_loop import (TrainConfig,
                                           make_sharded_train_step)

    cfg = get_config(ARCH, smoke=True)
    with np.load(params_path) as f:
        flat = {k: f[k] for k in f.files}
    params0 = {}
    for k, v in flat.items():
        node = params0
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    runs = [(name, fields, True) for name, fields in VARIANTS.items()]
    runs.append(("flat-cxl", dict(backend="cxl"), False))
    out = {}
    for name, fields, hier in runs:
        if hier:
            mesh = jax.make_mesh((2, DP // 2, 1), ("pod", "data", "model"))
            set_active_topology(parse_topology(topo_path))
        else:
            mesh = jax.make_mesh((DP, 1), ("data", "model"))
            clear_active_topology()
        assert dp_axes(mesh) == (DP_AXES if hier else ("data",))
        tcfg = TrainConfig(**_tcfg_kwargs(fields, plan_path))
        step, _, _, _ = make_sharded_train_step(cfg, tcfg, mesh,
                                                dp_axis=dp_axes(mesh))
        params, opt = params0, adamw_init(params0)
        data = iter(SyntheticTokens(cfg, batch=BATCH, seq=SEQ))
        losses = []
        for i, b in zip(range(STEPS), data):
            b = {k: jnp.asarray(v) for k, v in b.items()}
            ledger.reset()
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            if i == 0:          # the first call traced: the step's ledger
                snap = ledger.snapshot()
                out[f"{name}|levels"] = np.asarray(json.dumps(
                    snap["level_wire_bytes"]))
                out[f"{name}|fused"] = np.float64(snap["total_fused_bytes"])
                out[f"{name}|choices"] = np.asarray(json.dumps(sorted(
                    {(c["primitive"], c["level"], c["fabric"], c["backend"])
                     for c in snap["auto_choices"]})))
                for path, mu in jax.tree_util.tree_leaves_with_path(opt.mu):
                    key = "/".join(p.key for p in path)
                    out[f"{name}|grad|{key}"] = np.asarray(mu) / np.float32(
                        1 - B1)
        out[f"{name}|loss"] = np.asarray(losses)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.launch import tune as jax_tune
    from repro.models import model as jax_model
    from repro_torch.core.topology import parse_topology
    from repro_torch.launch import train
    from repro_torch.training.train_loop import TrainConfig

    tmp = tmp_path_factory.mktemp("torch_train_hierarchical")
    params_path = str(tmp / "params.npz")
    ref_path = str(tmp / "reference.npz")
    plan_path = str(tmp / "plan.json")
    topo_path = str(tmp / "topology.json")
    with open(topo_path, "w") as f:
        json.dump(reference_topology_json(), f)
    argv = sys.argv
    try:
        sys.argv = ["tune", "--smoke", "--nranks", "2", "--quiet",
                    "--topology", topo_path, "--out", plan_path]
        jax_tune.main()
    finally:
        sys.argv = argv
    jparams = jax_model.init_params(jax.random.key(0),
                                    jax_get_config(ARCH, smoke=True), tp=1,
                                    dtype=jnp.float32)
    train.save_params_npz(jax.tree.map(np.asarray, jparams), params_path)

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    ref = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                            "--reference", ref_path, params_path,
                            plan_path, topo_path], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        spec = train.RunSpec(
            arch=ARCH, smoke=True,
            variants=tuple(TrainConfig(**_tcfg_kwargs(f, plan_path))
                           for f in VARIANTS.values()),
            steps=STEPS, batch=BATCH, seq=SEQ, dp=DP, device="cpu",
            multi_pod=True, topology=parse_topology(topo_path),
            params_path=params_path, capture_grads=True, timeout_s=120.0)
        mine = dict(zip(VARIANTS, train.run_ranks(spec)))
        log, _ = ref.communicate(timeout=400)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log[-3000:]
    with np.load(ref_path) as f:
        reference = {k: f[k] for k in f.files}
    return mine, reference


def _full_grads(run: dict) -> dict:
    """Every rank's step-0 grad shards -> full arrays: a leaf sharded
    over the tuple axis concatenates its shards in rank-major order."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models import model, sharding

    cfg = get_config(ARCH, smoke=True)
    sharding.set_mesh_sizes({"pod": 2, "data": DP // 2, "model": 1})
    specs = sharding.param_specs(model.abstract_params(cfg), cfg,
                                 dp_axis=DP_AXES)
    shards = [tree.from_paths([(tuple(k.split("/")), v)
                               for k, v in g.items()]) for g in run["grads"]]
    out = {}
    for path, spec in tree.leaves_with_paths(specs):
        parts = [tree.get(s, path) for s in shards]
        if DP_AXES in spec:
            out["/".join(path)] = np.concatenate(
                parts, axis=spec.index(DP_AXES))
        else:
            assert "data" not in spec and "pod" not in spec
            for p in parts[1:]:        # replicated: every rank agrees
                np.testing.assert_array_equal(p, parts[0])
            out["/".join(path)] = parts[0]
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_losses_match_reference_and_the_flat_run(runs, variant):
    mine, reference = runs
    got = np.asarray([s["loss"] for s in mine[variant]["steps"]])
    np.testing.assert_allclose(got, reference[f"{variant}|loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got, reference["flat-cxl|loss"],
                               rtol=LOSS_RTOL)
    assert got[-1] < got[0]          # the loss falls over the steps


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_synced_grads_match_reference(runs, variant):
    mine, reference = runs
    got = _full_grads(mine[variant])
    prefix = f"{variant}|grad|"
    want = {k[len(prefix):]: v for k, v in reference.items()
            if k.startswith(prefix)}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_level_bytes_follow_the_reference_trip_counts(runs, variant):
    """The reference books the loss's collectives once at trace time,
    scaled by 3 (forward, remat replay, AD transpose), and the grad sync
    once; the port books each call as it runs, the gathers' transposes
    as reduce-scatters and the loss mean's AllReduce forward and
    backward.  Per level, with G the port's forward gathers, S the grad
    sync and l the loss mean's bytes (``LOSS_AR``):

    * pod: reference all_gather = 3 x port all_gather, the port's
      reduce_scatter equals its all_gather, and reference all_reduce =
      port all_reduce + l;
    * data: the port's all_gather (G + 2l + S) equals its reduce_scatter
      (transposes + 2l + S), and reference all_gather (3G + 3l + S) +
      2 x reference reduce_scatter (3l + S) = 3 x port all_gather + 3l.

    Every byte lands on its level's fabric.  Under the fixed backends the
    fused split is 3 x the port's fused gathers, as in the flat test;
    under ``auto`` the plan's cells also tag the all-reduces' inner
    reduce-scatters and all-gathers, which the reference's split does
    not count by level."""
    mine, reference = runs
    step = mine[variant]["steps"][0]
    got = step["level_wire_bytes_rank0"]
    want = json.loads(str(reference[f"{variant}|levels"]))
    assert set(got) == set(want) == {"pod/cxl", "data/ici"}
    p, d = got["pod/cxl"], got["data/ici"]
    rp, rd = want["pod/cxl"], want["data/ici"]
    assert p["reduce_scatter"] == p["all_gather"] > 0
    assert rp["all_gather"] == 3 * p["all_gather"]
    assert rp["all_reduce"] == p["all_reduce"] + LOSS_AR["pod"]["all_reduce"]
    assert d["all_gather"] == d["reduce_scatter"] > 0
    assert rd["all_gather"] + 2 * rd["reduce_scatter"] == \
        3 * d["all_gather"] + 3 * LOSS_AR["data"]["all_gather"]
    if VARIANTS[variant]["backend"] != "auto":
        assert 3 * step["fused_bytes_rank0"].get("all_gather", 0.0) == \
            float(reference[f"{variant}|fused"])


def test_pool_bytes_by_level(runs):
    """Every level's pool moves the same bytes each step (both levels
    under cxl); ring touches no pool."""
    mine, _ = runs
    for name, run in mine.items():
        levels = [s["pool_by_level"] for s in run["steps"]]
        if VARIANTS[name]["backend"] == "ring":
            assert levels[0] == {} and all(s["pool_bytes"] == 0
                                           for s in run["steps"])
            continue
        assert set(levels[0]) == {"pod", "data"}
        assert all(lv == levels[0] for lv in levels), name
        if VARIANTS[name]["backend"] == "cxl":
            assert all(c["retrieved"] > 0 for c in levels[0].values())


def test_auto_resolves_each_level_like_reference(runs):
    """Under ``auto`` every decision the reference takes, at every level,
    is one the port takes; the ici level only ever rides ring."""
    mine, reference = runs
    got = {(c["primitive"], c["level"], c["fabric"], c["backend"])
           for s in mine["auto"]["steps"] for c in s["choices_rank0"]}
    want = {tuple(c) for c in json.loads(str(reference["auto|choices"]))}
    assert want and want <= got
    assert {c[1] for c in got} == set(DP_AXES)
    assert all(c[3] == "ring" for c in got if c[2] == "ici")
    for prim, level, fabric, backend in got - want:
        assert prim == "reduce_scatter" and level == "pod", (prim, level)


if __name__ == "__main__":
    if len(sys.argv) == 6 and sys.argv[1] == "--reference":
        reference_main(*sys.argv[2:6])
    else:
        print(json.dumps({"usage": "--reference OUT.npz PARAMS.npz "
                                   "PLAN.json TOPOLOGY.json"}))
        sys.exit(2)
