"""The port's FSDP training path against the JAX reference: the same
numpy params and the same synthetic batches through
``repro_torch.launch.train.run_ranks`` (4 gloo CPU ranks, mesh 4x1) and
``repro.training.train_loop.make_sharded_train_step`` (shard_map over 4
forced host devices, run in a subprocess so the device count never leaks
into the test process).

Compared per variant (ring / cxl, with and without fused kernels, plus
microbatch accumulation, the per-leaf faithful-AllReduce path,
``auto`` on a plan written by ``repro.launch.tune --smoke --nranks 4``,
and ``auto`` without a plan, each rank tuning the default plan into the
plan cache):
the loss of each of 3 steps (rtol 1e-4: two f32 stacks summing in different
orders, after two AdamW updates) and the synced grads of the first step
(rtol 1e-4, atol 1e-5).  The reference's synced grads are read back from
its first AdamW moment, mu = (1 - b1) * g from zero; comparing grads, not
post-AdamW params, keeps AdamW's sign-like first step from amplifying f32
ordering noise.  Under ``auto`` the decisions and the ledger's bytes are
compared too (``test_auto_resolves_like_reference``,
``test_ledger_bytes_follow_the_reference_trip_counts``).

Also runnable as a script: ``python tests/test_torch_train.py
--reference OUT.npz PARAMS.npz PLAN.json`` writes the reference's numbers
(what the fixture does in its subprocess).
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

TUNED = "<the tuned plan>"     # stands for the fixture's plan path
# name -> TrainConfig fields shared by both sides
VARIANTS = {
    "ring": dict(backend="ring"),
    "ring-fused": dict(backend="ring", fuse_kernels=True),
    "cxl": dict(backend="cxl"),
    "cxl-fused": dict(backend="cxl", fuse_kernels=True),
    "cxl-microbatches": dict(backend="cxl", microbatches=2),
    "cxl-per-leaf-faithful": dict(backend="cxl", bucket_mb=0.0, prefetch=0,
                                  allreduce_mode="faithful",
                                  slicing_factor=2),
    "auto": dict(backend="auto", plan_path=TUNED),
    "auto-default-plan": dict(backend="auto"),
}
CHOICE_KEYS = ("primitive", "msg_bytes", "nranks", "backend",
               "slicing_factor", "allreduce_mode", "overlap", "fused")


def _tcfg_kwargs(fields: dict, plan_path: str) -> dict:
    return dict(lr=3e-4, warmup=min(20, STEPS // 5), total_steps=STEPS,
                clip_norm=None, **{k: plan_path if v == TUNED else v
                                   for k, v in fields.items()})


def _distinct(audit: list) -> list:
    return sorted({tuple(c[k] for k in CHOICE_KEYS) for c in audit})


def reference_main(out_path: str, params_path: str, plan_path: str) -> None:
    """The reference side, in a process with 4 forced host devices."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.core import ledger
    from repro.data.pipeline import SyntheticTokens
    from repro.launch.mesh import dp_axes
    from repro.optim import adamw_init
    from repro.training.train_loop import (TrainConfig,
                                           make_sharded_train_step)

    cfg = get_config(ARCH, smoke=True)
    mesh = jax.make_mesh((DP, 1), ("data", "model"))
    with np.load(params_path) as f:
        flat = {k: f[k] for k in f.files}
    params0 = {}
    for k, v in flat.items():
        node = params0
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    out = {}
    for name, fields in VARIANTS.items():
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
                out[f"{name}|wire"] = np.float64(snap["total_wire_bytes"])
                out[f"{name}|fused"] = np.float64(snap["total_fused_bytes"])
                out[f"{name}|choices"] = np.asarray(json.dumps(
                    _distinct(snap["auto_choices"])))
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
    from repro_torch.launch import train
    from repro_torch.training.train_loop import TrainConfig

    tmp = tmp_path_factory.mktemp("torch_train")
    params_path = str(tmp / "params.npz")
    ref_path = str(tmp / "reference.npz")
    plan_path = str(tmp / "plan.json")
    cache = str(tmp / "plan_cache")     # both sides' default plans
    argv = sys.argv
    try:
        sys.argv = ["tune", "--smoke", "--nranks", "4", "--quiet", "--out",
                    plan_path]
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
    env["REPRO_PLAN_CACHE"] = cache
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    ref = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                            "--reference", ref_path, params_path,
                            plan_path], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    saved_cache = os.environ.get("REPRO_PLAN_CACHE")
    os.environ["REPRO_PLAN_CACHE"] = cache     # the spawned ranks read it
    try:
        spec = train.RunSpec(
            arch=ARCH, smoke=True,
            variants=tuple(TrainConfig(**_tcfg_kwargs(f, plan_path))
                           for f in VARIANTS.values()),
            steps=STEPS, batch=BATCH, seq=SEQ, dp=DP, device="cpu",
            params_path=params_path, capture_grads=True, timeout_s=120.0)
        mine = dict(zip(VARIANTS, train.run_ranks(spec)))
        log, _ = ref.communicate(timeout=400)
    finally:
        if saved_cache is None:
            os.environ.pop("REPRO_PLAN_CACHE")
        else:
            os.environ["REPRO_PLAN_CACHE"] = saved_cache
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log[-3000:]
    with np.load(ref_path) as f:
        reference = {k: f[k] for k in f.files}
    return mine, reference, {"plan": plan_path, "cache": cache}


def _full_grads(run: dict) -> dict:
    """Every rank's step-0 grad shards -> full arrays via the specs."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models import model, sharding

    cfg = get_config(ARCH, smoke=True)
    sharding.set_mesh_sizes({"data": DP, "model": 1})
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
            for p in parts[1:]:        # replicated: every rank agrees
                np.testing.assert_array_equal(p, parts[0])
            out["/".join(path)] = parts[0]
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_losses_match_reference(runs, variant):
    mine, reference, _paths = runs
    got = np.asarray([s["loss"] for s in mine[variant]["steps"]])
    want = reference[f"{variant}|loss"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]          # the loss falls over the steps


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_synced_grads_match_reference(runs, variant):
    mine, reference, _paths = runs
    got = _full_grads(mine[variant])
    prefix = f"{variant}|grad|"
    want = {k[len(prefix):]: v for k, v in reference.items()
            if k.startswith(prefix)}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


def test_cxl_moves_bytes_through_the_pool_and_ring_does_not(runs):
    mine, _reference, _paths = runs
    for name, run in mine.items():
        pool = [s["pool_bytes"] for s in run["steps"]]
        if VARIANTS[name]["backend"] != "ring":
            assert all(b > 0 for b in pool) and len(set(pool)) == 1, name
        else:
            assert pool == [0] * STEPS, name


def test_fused_variants_book_fused_gather_bytes(runs):
    """With fused kernels the matmul weights' gathers book into the
    ledger's fused split (as ``_mesh_runner.py`` checks for the
    reference); without, nothing does."""
    mine, _reference, _paths = runs
    for name, run in mine.items():
        step = run["steps"][0]
        wire, fused = step["wire_bytes_rank0"], step["fused_bytes_rank0"]
        assert wire.get("all_gather", 0) > 0 and \
            wire.get("reduce_scatter", 0) > 0, name
        if VARIANTS[name].get("fuse_kernels"):
            assert 0 < fused.get("all_gather", 0) < wire["all_gather"], name
        elif VARIANTS[name]["backend"] != "auto":    # auto: the plan's
            assert not fused, name


@pytest.mark.parametrize("variant", [v for v, f in VARIANTS.items()
                                     if f.get("bucket_mb", 25.0) > 0])
def test_ledger_bytes_follow_the_reference_trip_counts(runs, variant):
    """The reference books each collective of the loss once at trace
    time and scales it by 3 (forward, remat replay, AD transpose) and by
    the microbatch count; the grad sync once.  The port books each call
    as it runs: the bucketed FSDP gathers once (they are prefetched
    outside the rematerialised rows), their transposes as reduce-
    scatters, the loss mean's all-reduce and its transpose, and the grad
    sync.  So the reference's total is 3 x the port's gathers + the
    port's all-reduces + one loss all-reduce per microbatch, and its
    fused split is 3 x the port's fused gathers."""
    mine, reference, _paths = runs
    step = mine[variant]["steps"][0]
    wire, fused = step["wire_bytes_rank0"], step["fused_bytes_rank0"]
    mb = VARIANTS[variant].get("microbatches", 1)
    loss_ar = 2 * 4 * (DP - 1) / DP          # one f32 scalar, two-phase
    assert wire["reduce_scatter"] == wire["all_gather"]
    assert 3 * wire["all_gather"] + wire["all_reduce"] + mb * loss_ar == \
        float(reference[f"{variant}|wire"])
    assert 3 * fused.get("all_gather", 0.0) == \
        float(reference[f"{variant}|fused"])


@pytest.mark.parametrize("variant", ["auto", "auto-default-plan"])
def test_auto_resolves_like_reference(runs, variant):
    """Under ``auto`` every decision the reference takes is the port's,
    and the port's other decisions - the gathers' transposes, which the
    reference never resolves (its AD transposes the ppermute program) -
    are what the reference's plan lookup gives for their sizes.  Without
    a plan both sides tune the smoke-grid default."""
    from repro.tuner import load_plan
    mine, reference, paths = runs
    ref_plan = load_plan(paths["plan"]) if variant == "auto" else \
        load_plan(_cached_plans(paths["cache"])[1][0])
    got = {tuple(c[k] for k in CHOICE_KEYS)
           for s in mine[variant]["steps"] for c in s["choices_rank0"]}
    want = {tuple(c) for c in json.loads(str(reference[f"{variant}|"
                                                       f"choices"]))}
    assert want and want <= got
    for prim, size, n, *knobs in got - want:
        assert prim == "reduce_scatter"
        c = ref_plan.lookup(prim, size, n)
        assert knobs == [c.backend, c.slicing_factor, c.allreduce_mode,
                         c.overlap, c.fused]
    assert {k[3] for k in got} <= {"ring", "cxl"}


def _cached_plans(cache: str) -> tuple:
    """(the port's default plan files, the reference's)."""
    port = os.path.join(cache, "repro_torch")
    return ([os.path.join(port, f) for f in sorted(os.listdir(port))],
            [os.path.join(cache, f) for f in sorted(os.listdir(cache))
             if f.endswith(".json")])


def test_default_plans_cached_apart_from_the_reference(runs):
    """Without ``--plan`` the port's ranks and the reference each cache
    the default plan under the same fingerprint-keyed name, the port in
    a directory of its own: same cells and choices, the fused cells'
    times priced on other rooflines."""
    from repro.tuner import load_plan as jax_load_plan
    from repro_torch.tuner import load_plan
    _mine, _reference, paths = runs
    port, ref = _cached_plans(paths["cache"])
    assert [os.path.basename(f) for f in port] == \
        [os.path.basename(f) for f in ref] and len(port) == 1
    a, b = load_plan(port[0]), jax_load_plan(ref[0])
    assert a.fingerprint == b.fingerprint and sorted(a.entries) == \
        sorted(b.entries)
    for k, c in b.entries.items():
        mine = a.entries[k]
        assert (mine.backend, mine.slicing_factor, mine.fused) == \
            (c.backend, c.slicing_factor, c.fused), k
        assert (mine.predicted_time == c.predicted_time) != c.fused, k


def test_synthetic_batches_match_reference():
    from repro.configs import get_config as jax_get_config
    from repro.data.pipeline import SyntheticTokens as JaxTokens
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens, local_batch

    ours = iter(SyntheticTokens(get_config(ARCH, smoke=True), BATCH, SEQ))
    theirs = iter(JaxTokens(jax_get_config(ARCH, smoke=True), BATCH, SEQ))
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    rows = [local_batch(a, r, DP)["tokens"] for r in range(DP)]
    np.testing.assert_array_equal(np.concatenate(rows), a["tokens"])


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--reference":
        reference_main(sys.argv[2], sys.argv[3], sys.argv[4])
    else:
        print(json.dumps({"usage": "--reference OUT.npz PARAMS.npz "
                                   "PLAN.json"}))
        sys.exit(2)
