"""The port's FSDP training over a grouped (ragged) data axis against the
JAX reference.

Two configurations, each through ``repro_torch.launch.train.run_ranks``
on gloo CPU ranks against ``repro.training.train_loop.
make_sharded_train_step`` on forced host devices (a subprocess each, run
beside the port's ranks), the same numpy params and batches:

* ``tiny6``: the runner's ``tiny-fsdp6`` config (2 layers, d_model 384)
  on 6 ranks with the data level grouped (4, 2) under a slow IB parent
  (``check_fused_train(ragged=True)``'s topology), batch 6, seq 16;
* ``llama31``: the Llama-3.2-1B smoke config on 4 ranks grouped (3, 1),
  ``pod:cxl,data:cxl:3+1`` (the full-width path's shape), batch 8, seq
  32.

Per variant (ring, cxl, cxl with fused kernels, auto on a plan the
reference's tuner writes for the topology): the losses of 3 steps (rtol
1e-4), the step-0 synced grads (rtol 1e-4, atol 1e-5; the reference's
read back from its first AdamW moment), no fallback event in either
package, the ledger's bytes by level against the reference's trip counts,
the pool bytes of both levels, and the fused run against the unfused
one.  ``train --placement auto --topology pod:cxl,node:cxl:3+1`` gives
the run of the plain ``--topology pod:cxl,data:cxl:3+1``.

The reference lowers a grouped level to the same ppermute program under
every backend (its ``Communicator``'s docstring: on ragged levels the
backend steers the slicing factor and the audit, not the lowering), and
the model axis has one rank, so its ring run is its cxl run: the port's
ring run is held to the reference's cxl run.

The reference's own ``check_fused_train(ragged=True)`` fails its 5e-4
bound on the fused-vs-unfused parameter delta (1.39e-3); its inputs are
re-run here to pin the cause (``test_reference_ragged_fused_delta_is_
adamw_amplification``).

Also runnable as a script: ``python tests/test_torch_train_ragged.py
--reference CONFIG OUT.npz PARAMS.npz PLAN.json TOPOLOGY.json``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
STEPS, B1 = 3, 0.9
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
TUNED = "<the tuned plan>"     # stands for the fixture's plan path
VARIANTS = {
    "ring": dict(backend="ring"),
    "cxl": dict(backend="cxl"),
    "cxl-fused": dict(backend="cxl", fuse_kernels=True),
    "auto": dict(backend="auto", plan_path=TUNED),
}
# name -> (ranks, batch, seq, group shape)
CONFIGS = {"tiny6": (6, 6, 16, (4, 2)), "llama31": (4, 8, 32, (3, 1))}
# the reference's runs: its ring run is its cxl run (module docstring)
REF_VARIANTS = ("cxl", "cxl-fused", "auto")
# the fused-vs-unfused check of the reference's runner
FUSED_LR, FUSED_BOUND = 1e-3, 5e-4


def _ref_variant(variant: str) -> str:
    return "cxl" if variant == "ring" else variant


def _tcfg_kwargs(fields: dict, plan_path: str) -> dict:
    return dict(lr=3e-4, warmup=min(20, STEPS // 5), total_steps=STEPS,
                clip_norm=None, **{k: plan_path if v == TUNED else v
                                   for k, v in fields.items()})


def reference_topology_json(name: str) -> dict:
    from repro.core.hw import CXLPoolConfig, InfiniBandConfig
    from repro.core.topology import Level, Topology, parse_topology
    if name == "tiny6":
        return Topology(levels=(
            Level("pod", "ib", ib=InfiniBandConfig(link_bw=2.5e9)),
            Level("data", "cxl", pool=CXLPoolConfig(device_bw=18e9),
                  shape=(4, 2)))).to_json()
    return parse_topology("pod:cxl,data:cxl:3+1").to_json()


def reference_config(name: str):
    """The reference's model config of ``name``."""
    from repro.configs import get_config
    from repro.models.config import ModelConfig, dense_pattern
    if name == "tiny6":
        # _mesh_runner.check_fused_train's: d_model divides dp = 6 and
        # 384 x 384 passes FSDP_MIN_SIZE, so the weights shard
        return ModelConfig(name="tiny-fsdp6", family="dense", n_layers=2,
                           d_model=384, n_heads=6, n_kv_heads=2, d_ff=768,
                           vocab_size=512, layer_pattern=dense_pattern(2))
    return get_config("llama3.2-1b", smoke=True)


def port_config(name: str):
    from repro_torch.configs import get_config
    from repro_torch.models.config import ModelConfig, dense_pattern
    if name == "tiny6":
        return ModelConfig(name="tiny-fsdp6", family="dense", n_layers=2,
                           d_model=384, n_heads=6, n_kv_heads=2, d_ff=768,
                           vocab_size=512, layer_pattern=dense_pattern(2))
    return get_config("llama3.2-1b", smoke=True)


def _tree(flat: dict) -> dict:
    import jax.numpy as jnp
    out: dict = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return out


def _moments(opt, prefix: str, out: dict) -> None:
    import jax
    for path, mu in jax.tree_util.tree_leaves_with_path(opt.mu):
        key = "/".join(p.key for p in path)
        out[f"{prefix}|grad|{key}"] = np.asarray(mu) / np.float32(1 - B1)


def reference_fused_check(out: dict) -> None:
    """``_mesh_runner.check_fused_train(ragged=True)`` as the runner runs
    it (the same rng, params, batch, topology and one AdamW step of
    lr 1e-3), keeping the grads and moments it discards."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core.api import Communicator
    from repro.core.topology import Topology
    from repro.models import model, sharding
    from repro.models.pcontext import ParallelContext
    from repro.optim import AdamWState, adamw_init
    from repro.training.train_loop import (TrainConfig, make_gather_fn,
                                           make_train_step)

    rng = np.random.default_rng(77)
    topo = Topology.from_json(reference_topology_json("tiny6"))
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:6]).reshape(6, 1),
                             ("data", "model"))
    cfg = reference_config("tiny6")
    comm = Communicator(backend="cxl", topology=topo)
    params = model.init_params(jax.random.key(7), cfg, tp=1,
                               dtype=jnp.float32)
    batch = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab_size, (6, 16))),
             "labels": jnp.asarray(rng.integers(0, cfg.vocab_size,
                                                (6, 16)))}
    bspecs = {"tokens": P("data"), "labels": P("data")}
    sharding.set_mesh_sizes({"model": 1, "data": 6})
    pc = ParallelContext(tp_axis="model", dp_axis="data", tp=1, comm=comm)
    pspecs = sharding.param_specs(params, cfg, dp_axis="data", fsdp=True)
    rspecs = sharding.row_specs(pspecs)
    ospecs = AdamWState(step=P(), mu=pspecs, nu=pspecs)
    mspecs = {"loss": P(), "lr": P(), "grad_norm": P(), "xent": P(),
              "aux": P()}
    for k, v in jax.tree_util.tree_leaves_with_path(params):
        out["fused_check|p0|" + "/".join(p.key for p in k)] = np.asarray(v)
    for fuse in (False, True):
        tcfg = TrainConfig(lr=FUSED_LR, warmup=0, clip_norm=None,
                           remat=False, fuse_kernels=fuse)
        gather = make_gather_fn(tcfg, rspecs, pc, "data")
        inner = make_train_step(cfg, tcfg, pc, gather_fn=gather,
                                param_spec_tree=pspecs, dp_axis="data")
        step = jax.jit(jax.shard_map(
            inner, mesh=mesh, in_specs=(pspecs, ospecs, bspecs),
            out_specs=(pspecs, ospecs, mspecs), check_vma=False))
        p2, opt, m = step(params, adamw_init(params), batch)
        tag = f"fused_check|{'fused' if fuse else 'unfused'}"
        out[f"{tag}|loss"] = np.float64(m["loss"])
        for (k, v), nu in zip(jax.tree_util.tree_leaves_with_path(p2),
                              jax.tree.leaves(opt.nu)):
            key = "/".join(p.key for p in k)
            out[f"{tag}|p1|{key}"] = np.asarray(v)
            out[f"{tag}|nu|{key}"] = np.asarray(nu)
        _moments(opt, tag, out)


def reference_main(name: str, out_path: str, params_path: str,
                   plan_path: str, topo_path: str) -> None:
    """The reference side of configuration ``name`` (or of the runner's
    fused check, ``fused_check``)."""
    import jax
    import jax.numpy as jnp

    from repro.core import ledger
    from repro.core.topology import parse_topology, set_active_topology
    from repro.data.pipeline import SyntheticTokens
    from repro.launch.mesh import dp_axes
    from repro.optim import adamw_init
    from repro.training.train_loop import (TrainConfig,
                                           make_sharded_train_step)

    out = {}
    if name == "fused_check":
        reference_fused_check(out)
        np.savez(out_path, **out)
        return
    n, batch, seq, _ = CONFIGS[name]
    cfg = reference_config(name)
    with np.load(params_path) as f:
        params0 = _tree({k: f[k] for k in f.files})
    set_active_topology(parse_topology(topo_path))
    mesh = jax.make_mesh((n, 1), ("data", "model"))
    for label in REF_VARIANTS:
        fields = VARIANTS[label]
        tcfg = TrainConfig(**_tcfg_kwargs(fields, plan_path))
        step, _, _, _ = make_sharded_train_step(cfg, tcfg, mesh,
                                                dp_axis=dp_axes(mesh))
        params, opt = params0, adamw_init(params0)
        data = iter(SyntheticTokens(cfg, batch=batch, seq=seq))
        losses = []
        for i, b in zip(range(STEPS), data):
            b = {k: jnp.asarray(v) for k, v in b.items()}
            ledger.reset()
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            if i == 0:          # the first call traced: the step's ledger
                snap = ledger.snapshot()
                out[f"{label}|levels"] = np.asarray(json.dumps(
                    snap["level_wire_bytes"]))
                out[f"{label}|fallbacks"] = np.int64(len(snap["fallbacks"]))
                out[f"{label}|choices"] = np.asarray(json.dumps(sorted(
                    {(c["primitive"], c["level"], c["fabric"], c["nranks"],
                      c["backend"]) for c in snap["auto_choices"]})))
                _moments(opt, label, out)
        out[f"{label}|loss"] = np.asarray(losses)
    np.savez(out_path, **out)


def _reference_process(name: str, tmp, plan_path: str, params_path: str):
    topo_path = str(tmp / f"topology-{name}.json")
    with open(topo_path, "w") as f:
        json.dump(reference_topology_json(name), f)
    env = dict(os.environ)
    devices = CONFIGS[name][0] if name in CONFIGS else 6
    env["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={devices}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    out = str(tmp / f"reference-{name}.npz")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--reference", name,
         out, params_path, plan_path, topo_path], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro import tuner as rtuner
    from repro.core.topology import Topology as RTopology
    from repro.models import model as jax_model
    from repro_torch.core.topology import Topology
    from repro_torch.launch import train
    from repro_torch.training.train_loop import TrainConfig

    tmp = tmp_path_factory.mktemp("torch_train_ragged")
    procs, paths = {}, {}
    try:
        procs["fused_check"], out = _reference_process(
            "fused_check", tmp, "-", "-")
        paths["fused_check"] = (out,)
        for name in CONFIGS:
            rtopo = RTopology.from_json(reference_topology_json(name))
            plan_path = str(tmp / f"plan-{name}.json")
            rtuner.save_plan(rtuner.generate_plan(rtuner.SMOKE_GRID,
                                                  topology=rtopo), plan_path)
            params_path = str(tmp / f"params-{name}.npz")
            jparams = jax_model.init_params(jax.random.key(0),
                                            reference_config(name), tp=1,
                                            dtype=jnp.float32)
            train.save_params_npz(jax.tree.map(np.asarray, jparams),
                                  params_path)
            procs[name], out = _reference_process(name, tmp, plan_path,
                                                  params_path)
            paths[name] = (out, plan_path, params_path)
        mine = {}
        for name, (n, batch, seq, _) in CONFIGS.items():
            _, plan_path, params_path = paths[name]
            spec = train.RunSpec(
                arch="llama3.2-1b", smoke=True,
                variants=tuple(TrainConfig(**_tcfg_kwargs(f, plan_path))
                               for f in VARIANTS.values()),
                steps=STEPS, batch=batch, seq=seq, dp=n, device="cpu",
                topology=Topology.from_json(reference_topology_json(name)),
                config=port_config(name), params_path=params_path,
                capture_grads=True, timeout_s=120.0)
            mine[name] = dict(zip(VARIANTS, train.run_ranks(spec)))
        # --placement auto on the physical topology, beside the plain run
        _, plan_path, params_path = paths["llama31"]
        args = train.build_parser().parse_args(
            ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
             "--mesh", "4x1", "--backend", "cxl", "--steps", str(STEPS),
             "--batch", "8", "--seq", "32", "--lr", "3e-4", "--topology",
             "pod:cxl,node:cxl:3+1", "--placement", "auto"])
        spec = train.spec_from_args(args)
        mine["placed"] = train.run_ranks(dataclasses.replace(
            spec, params_path=params_path, timeout_s=120.0))[0]
        reference = {}
        for name, proc in procs.items():
            log, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, log[-3000:]
            with np.load(paths[name][0]) as f:
                reference[name] = {k: f[k] for k in f.files}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return mine, reference


def _full_grads(name: str, run: dict) -> dict:
    """Every rank's step-0 grad shards -> full arrays (rank-major along
    the leaf's dp dim; replicated leaves agree on every rank)."""
    from repro_torch.core import tree
    from repro_torch.models import model, sharding

    n = CONFIGS[name][0]
    cfg = port_config(name)
    sharding.set_mesh_sizes({"data": n, "model": 1})
    specs = sharding.param_specs(model.abstract_params(cfg), cfg,
                                 dp_axis="data")
    shards = [tree.from_paths([(tuple(k.split("/")), v)
                               for k, v in g.items()]) for g in run["grads"]]
    out = {}
    for path, spec in tree.leaves_with_paths(specs):
        parts = [tree.get(s, path) for s in shards]
        if "data" in spec:
            out["/".join(path)] = np.concatenate(parts,
                                                 axis=spec.index("data"))
        else:
            for p in parts[1:]:
                np.testing.assert_array_equal(p, parts[0])
            out["/".join(path)] = parts[0]
    return out


def _ref_grads(reference: dict, prefix: str) -> dict:
    prefix += "|grad|"
    return {k[len(prefix):]: v for k, v in reference.items()
            if k.startswith(prefix)}


CASES = [(c, v) for c in CONFIGS for v in VARIANTS]


@pytest.mark.parametrize("name,variant", CASES)
def test_losses_match_reference(runs, name, variant):
    mine, reference = runs
    got = np.asarray([s["loss"] for s in mine[name][variant]["steps"]])
    np.testing.assert_allclose(got, reference[name][f"{_ref_variant(variant)}|loss"],
                               rtol=LOSS_RTOL)
    assert got[-1] < got[0]          # the loss falls over the steps


@pytest.mark.parametrize("name,variant", CASES)
def test_synced_grads_match_reference(runs, name, variant):
    mine, reference = runs
    got = _full_grads(name, mine[name][variant])
    want = _ref_grads(reference[name], _ref_variant(variant))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("name,variant", CASES)
def test_no_fallback_and_pools_at_both_levels(runs, name, variant):
    """No flat-on-ragged event in either package (FSDP's gathers, their
    reduce-scatter transposes and the all-reduces are all grouped); under
    cxl the groups' pools and the sub-roots' pool move the same bytes
    every step, ring touches no pool."""
    mine, reference = runs
    run = mine[name][variant]
    assert int(reference[name][f"{_ref_variant(variant)}|fallbacks"]) == 0
    assert all(s["fallbacks"] == 0 for s in run["steps"])
    levels = [s["pool_by_level"] for s in run["steps"]]
    if variant == "ring":
        assert all(s["pool_bytes"] == 0 for s in run["steps"])
        return
    assert all(lv == levels[0] for lv in levels), name
    if variant.startswith("cxl"):
        assert set(levels[0]) == {"pod", "data"}
        assert all(c["retrieved"] > 0 for c in levels[0].values())


@pytest.mark.parametrize("name,variant", CASES)
def test_level_bytes_follow_the_reference_trip_counts(runs, name, variant):
    """Ledger bytes by level against the reference's trip counts.  Both
    packages book a grouped call by the same formulas: a gather of s
    bytes a rank books s(g-1) on data, s n (n_g-1) on pod and a fan-out
    broadcast of s n on data; a reduce-scatter or all-reduce of s books
    s(g-1) on data, s(n_g-1) on pod and a broadcast of s on data (g the
    largest group, n_g the group count, n the ranks).  The reference
    books at trace time: each forward gather three times (forward, remat
    replay, AD transpose, all as gathers), the loss mean's AllReduce of
    l = 4 bytes three times and the grad sync once.  The port books each
    call as it runs: the gathers, each gather's transpose as a
    reduce-scatter of the n-fold buffer, the loss mean forward and
    backward, the grad sync.  So, exactly, at both levels: reference
    all_gather = 3 x port all_gather; port reduce_scatter = n x port
    all_gather on data and = port all_gather on pod, the reference none;
    reference all_reduce = port all_reduce + l (g-1) on data, + l (n_g-1)
    on pod; and each package's data broadcast is its fan-outs."""
    mine, reference = runs
    got = mine[name][variant]["steps"][0]["level_wire_bytes_rank0"]
    want = json.loads(str(reference[name][f"{_ref_variant(variant)}|"
                                          f"levels"]))
    parent = "pod/ib" if name == "tiny6" else "pod/cxl"
    assert set(got) == set(want) == {"data/cxl", parent}
    n, _, _, shape = CONFIGS[name]
    g, n_g = max(shape), len(shape)
    loss = 4.0
    p, r = got[parent], want[parent]
    d, rd = got["data/cxl"], want["data/cxl"]
    assert set(d) == {"all_gather", "reduce_scatter", "all_reduce",
                      "broadcast"} and set(p) == {"all_gather",
                                                  "reduce_scatter",
                                                  "all_reduce"}
    assert set(rd) == set(d) - {"reduce_scatter"}
    assert set(r) == set(p) - {"reduce_scatter"}
    assert rd["all_gather"] == 3 * d["all_gather"] > 0
    assert r["all_gather"] == 3 * p["all_gather"]
    assert d["reduce_scatter"] == n * d["all_gather"]
    assert p["reduce_scatter"] == p["all_gather"]
    assert rd["all_reduce"] == d["all_reduce"] + loss * (g - 1)
    assert r["all_reduce"] == p["all_reduce"] + loss * (n_g - 1)
    assert d["broadcast"] == (n * d["all_gather"] + d["reduce_scatter"]
                              + d["all_reduce"]) / (g - 1)
    assert rd["broadcast"] == (n * rd["all_gather"]
                               + rd["all_reduce"]) / (g - 1)


def test_auto_resolves_each_phase_like_reference(runs):
    """Under ``auto`` every decision the reference takes (primitive,
    level, fabric, rank count, backend) is one the port takes: the
    within-group phase at the largest group on data, the sub-root phase
    at the group count on pod."""
    mine, reference = runs
    for name in CONFIGS:
        got = {(c["primitive"], c["level"], c["fabric"], c["nranks"],
                c["backend"])
               for s in mine[name]["auto"]["steps"]
               for c in s["choices_rank0"]}
        want = {tuple(c) for c in json.loads(str(
            reference[name]["auto|choices"]))}
        assert want and want <= got, (name, want - got)
        shape = CONFIGS[name][3]
        assert {(c[1], c[3]) for c in got} == {
            ("data", max(shape)), ("pod", len(shape))}, name


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fused_matches_unfused_in_the_port(runs, name):
    """The port's fused run against its unfused one on the grouped axis:
    step-0 grads at the parity tolerance and the losses at rtol 1e-4."""
    mine, _ = runs
    fused = _full_grads(name, mine[name]["cxl-fused"])
    plain = _full_grads(name, mine[name]["cxl"])
    worst = max(float(np.max(np.abs(fused[k] - plain[k]))) for k in plain)
    print(f"{name}: port fused-vs-unfused step-0 grad max delta {worst:.2e}")
    for k in plain:
        np.testing.assert_allclose(fused[k], plain[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    np.testing.assert_allclose(
        [s["loss"] for s in mine[name]["cxl-fused"]["steps"]],
        [s["loss"] for s in mine[name]["cxl"]["steps"]], rtol=LOSS_RTOL)


def test_placement_auto_gives_the_plain_run(runs):
    """``--placement auto`` on ``pod:cxl,node:cxl:3+1`` places data on
    the grouped node level: the same losses and the same ledger bytes by
    level as the plain ``pod:cxl,data:cxl:3+1`` run."""
    mine, _ = runs
    placed, plain = mine["placed"], mine["llama31"]["cxl"]
    assert [s["loss"] for s in placed["steps"]] == \
        [s["loss"] for s in plain["steps"]]
    for a, b in zip(placed["steps"], plain["steps"]):
        assert a["level_wire_bytes_rank0"] == b["level_wire_bytes_rank0"]
        assert a["pool_by_level"] == b["pool_by_level"]


def test_reference_ragged_fused_delta_is_adamw_amplification(runs):
    """The reference's ``check_fused_train(ragged=True)`` fails its bound
    (worst fused-vs-unfused param delta above 5e-4) without a fault in
    the fused ragged gather or its transpose: the two step-0 gradients
    agree to f32 summation-order noise, and the whole parameter delta is
    AdamW's first step, lr * g / (|g| + eps), evaluated on the two
    packages' own moments - near-zero gradient elements whose noise
    moves that ratio by up to 2 (the runner's own comment).  The port's
    fused and unfused gradients agree likewise
    (``test_fused_matches_unfused_in_the_port``)."""
    _, reference = runs
    ref = reference["fused_check"]
    fused = _ref_grads(ref, "fused_check|fused")
    plain = _ref_grads(ref, "fused_check|unfused")
    worst_p, worst_key = 0.0, None
    for k in plain:
        scale = float(np.max(np.abs(plain[k])))
        np.testing.assert_allclose(fused[k], plain[k], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)
        p_f = ref[f"fused_check|fused|p1|{k}"]
        p_u = ref[f"fused_check|unfused|p1|{k}"]
        delta = np.abs(p_f - p_u)
        if float(delta.max()) > worst_p:
            worst_p, worst_key = float(delta.max()), k
        # AdamW's first step on each run's own moments (bc1 = 1 - b1,
        # bc2 = 1 - b2, eps 1e-8): the update direction m / (sqrt(v) + eps)
        steps = {}
        for tag, g in (("fused", fused[k]), ("unfused", plain[k])):
            nu = ref[f"fused_check|{tag}|nu|{k}"]
            vhat = nu / np.float32(1 - 0.95)
            steps[tag] = g / (np.sqrt(vhat) + np.float32(1e-8))
        predicted = FUSED_LR * np.abs(steps["fused"] - steps["unfused"])
        np.testing.assert_allclose(delta, predicted, rtol=0, atol=2e-6,
                                   err_msg=k)
    # the runner's failure, reproduced: above its bound, below 2 lr
    assert FUSED_BOUND < worst_p < 2 * FUSED_LR, worst_p
    # and it sits where the gradient is all but zero
    k = worst_key
    p_f = ref[f"fused_check|fused|p1|{k}"]
    p_u = ref[f"fused_check|unfused|p1|{k}"]
    at = np.unravel_index(np.argmax(np.abs(p_f - p_u)), p_f.shape)
    scale = float(np.max(np.abs(plain[k])))
    assert abs(float(plain[k][at])) < 1e-4 * scale, (k, plain[k][at], scale)
    print(f"reference ragged fused check: worst param delta {worst_p:.3e} "
          f"at {k}{list(at)}, grads there {float(plain[k][at]):.3e} "
          f"(unfused) / {float(fused[k][at]):.3e} (fused), leaf scale "
          f"{scale:.3e}")


if __name__ == "__main__":
    if len(sys.argv) == 7 and sys.argv[1] == "--reference":
        reference_main(*sys.argv[2:7])
    else:
        print(json.dumps({"usage": "--reference CONFIG OUT.npz PARAMS.npz "
                                   "PLAN.json TOPOLOGY.json"}))
        sys.exit(2)
