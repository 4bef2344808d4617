"""The port's FSDP + tensor-parallel training against the JAX reference:
``repro_torch.launch.train.run_ranks`` on gloo CPU ranks over the rank-major
mesh ``(("data", DP), ("model", TP))`` against
``repro.training.train_loop.make_sharded_train_step`` on the same
``("data", "model")`` mesh of forced host devices (in a subprocess), from
the same numpy params (made by the reference at that tp: padded heads and
vocabulary) and the same synthetic batches.

Runs:

* ``smoke22``: ``llama3.2-smoke`` (tied head, sharded kv) on (data 2, model
  2) under ring, cxl, cxl with fused kernels and auto, with the topology
  ``data:cxl,model:cxl`` active in both packages (so every tuple
  AllReduce decomposes per level and each level books its own bytes);
  the auto plan is ``repro.launch.tune --smoke --nranks 2 --topology
  FILE``'s;
* ``8b24``: ``llama3-8b`` smoke (replicated kv at tp = 4, untied head) on
  (data 2, model 4) under ring (the grad sync's ("data", "model")
  AllReduce is one fused ring over all 8 ranks) and cxl, no topology;
* ``8b22fused``: ``llama3-8b`` smoke on (data 2, model 2), one step with
  and without fused kernels, as the reference's ``check_fused_train(
  ragged=False)`` (ring, lr 1e-3, no remat, no warm-up).

Per variant: the loss of each step (rtol 1e-4), the step-0 synced grads
(rtol 1e-4, atol 1e-5; the reference's read back from its first AdamW
moment, ``mu / (1 - b1)``), and for ``smoke22`` the ledger's bytes of
each level against the reference's trip counts and the pool bytes of
each level.  ``test_reference_tp_grads_against_unsharded`` pins what the
reference's sharded gradients are against ``jax.grad`` of its unsharded
step (ROADMAP queue 3).

Also runnable as a script: ``python tests/test_torch_train_tp.py
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
FUSED_PARAM_ATOL = 5e-4

TUNED = "<the tuned plan>"     # stands for the fixture's plan path
# run -> arch, (dp, tp), steps, batch, seq, topology active, variants
RUNS = {
    "smoke22": dict(arch="llama3.2-1b", dp=2, tp=2, steps=3, batch=4,
                    seq=32, topology=True, variants={
                        "ring": dict(backend="ring"),
                        "cxl": dict(backend="cxl"),
                        "cxl-fused": dict(backend="cxl", fuse_kernels=True),
                        "auto": dict(backend="auto", plan_path=TUNED)}),
    "8b24": dict(arch="llama3-8b", dp=2, tp=4, steps=3, batch=4, seq=32,
                 topology=False, variants={
                     "ring": dict(backend="ring"),
                     "cxl": dict(backend="cxl")}),
    "8b22fused": dict(arch="llama3-8b", dp=2, tp=2, steps=1, batch=2,
                      seq=16, topology=False, variants={
                          "unfused": dict(backend="ring"),
                          "fused": dict(backend="ring", fuse_kernels=True)}),
}
CASES = [(run, v) for run, r in RUNS.items() for v in r["variants"]]
# the port's variant -> the reference's it is held to (the reference's
# fused step equals its unfused one within the 5e-4 of
# check_fused_train; one compile fewer)
REF_VARIANT = {("8b22fused", "fused"): "unfused"}


def _tcfg_kwargs(run: str, fields: dict, plan_path: str) -> dict:
    r = RUNS[run]
    if run == "8b22fused":      # check_fused_train's step
        base = dict(lr=1e-3, warmup=0, total_steps=1, remat=False)
    else:                       # the launcher's
        base = dict(lr=3e-4, warmup=min(20, r["steps"] // 5),
                    total_steps=r["steps"])
    return dict(base, clip_norm=None, **{
        k: plan_path if v == TUNED else v for k, v in fields.items()})


def reference_topology_json() -> dict:
    from repro.core.topology import Level, Topology
    return Topology(levels=(Level("data", "cxl"),
                            Level("model", "cxl"))).to_json()


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


# the reference's runs in two processes that compile side by side
REF_GROUPS = (("smoke22",), ("8b24", "8b22fused"))


def reference_main(out_path: str, tmp: str, group: str) -> None:
    """The reference side of the runs of ``REF_GROUPS[group]``, in a
    process with 8 forced host devices."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.core import ledger
    from repro.core.topology import (clear_active_topology, parse_topology,
                                     set_active_topology)
    from repro.data.pipeline import SyntheticTokens
    from repro.optim import adamw_init
    from repro.training.train_loop import (TrainConfig, make_sharded_train_step,
                                           make_train_step)

    out = {}
    plan_path = os.path.join(tmp, "plan.json")
    for run in REF_GROUPS[int(group)]:
        r = RUNS[run]
        cfg = get_config(r["arch"], smoke=True)
        params0 = _load_tree(os.path.join(tmp, f"{run}.npz"))
        batches = [{k: jnp.asarray(v) for k, v in b.items()} for _, b in zip(
            range(r["steps"]), SyntheticTokens(cfg, batch=r["batch"],
                                               seq=r["seq"]))]
        mesh = jax.make_mesh((r["dp"], r["tp"]), ("data", "model"),
                             devices=jax.devices()[:r["dp"] * r["tp"]])
        for name, fields in r["variants"].items():
            if (run, name) in REF_VARIANT:
                continue
            if r["topology"]:
                set_active_topology(parse_topology(
                    os.path.join(tmp, "topology.json")))
            else:
                clear_active_topology()
            tcfg = TrainConfig(**_tcfg_kwargs(run, fields, plan_path))
            step, _, _, _ = make_sharded_train_step(cfg, tcfg, mesh,
                                                    dp_axis=("data",))
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
                    out[f"{key}|wire"] = np.asarray(json.dumps(
                        snap["wire_bytes"]))
                    out[f"{key}|choices"] = np.asarray(json.dumps(sorted(
                        {(c["primitive"], c["level"], c["fabric"],
                          c["backend"]) for c in snap["auto_choices"]})))
                    for k, g in _grads_from_mu(opt).items():
                        out[f"{key}|grad|{k}"] = g
            out[f"{run}|{name}|loss"] = np.asarray(losses)
            if run == "8b22fused":
                for path, x in jax.tree_util.tree_leaves_with_path(params):
                    out[f"{run}|{name}|param|"
                        + "/".join(p.key for p in path)] = np.asarray(x)
        clear_active_topology()
        if run == "smoke22":
            # jax.grad of the unsharded step on the same params and batch
            tcfg = TrainConfig(**_tcfg_kwargs(run, dict(backend="ring"),
                                              plan_path))
            ustep = jax.jit(make_train_step(cfg, tcfg))
            _, uopt, _ = ustep(params0, adamw_init(params0), batches[0])
            for k, g in _grads_from_mu(uopt).items():
                out[f"{run}|unsharded|grad|{k}"] = g
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

    tmp = str(tmp_path_factory.mktemp("torch_train_tp"))
    ref_path = os.path.join(tmp, "reference.npz")
    plan_path = os.path.join(tmp, "plan.json")
    topo_path = os.path.join(tmp, "topology.json")
    with open(topo_path, "w") as f:
        json.dump(reference_topology_json(), f)
    argv = sys.argv
    try:
        sys.argv = ["tune", "--smoke", "--nranks", "2", "--quiet",
                    "--topology", topo_path, "--out", plan_path]
        jax_tune.main()
    finally:
        sys.argv = argv
    for run, r in RUNS.items():
        jparams = jax_model.init_params(
            jax.random.key(7), jax_get_config(r["arch"], smoke=True),
            tp=r["tp"], dtype=jnp.float32)
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
        mine = {}
        for run, r in RUNS.items():
            spec = train.RunSpec(
                arch=r["arch"], smoke=True,
                variants=tuple(TrainConfig(**_tcfg_kwargs(run, f, plan_path))
                               for f in r["variants"].values()),
                steps=r["steps"], batch=r["batch"], seq=r["seq"],
                dp=r["dp"], tp=r["tp"], device="cpu",
                topology=parse_topology(topo_path) if r["topology"]
                else None,
                params_path=os.path.join(tmp, f"{run}.npz"),
                capture_grads=True, capture_params=run == "8b22fused",
                timeout_s=120.0)
            for name, got in zip(r["variants"], train.run_ranks(spec)):
                mine[run, name] = got
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


def _specs(run: str):
    from repro_torch.configs import get_config
    from repro_torch.models import model, sharding
    r = RUNS[run]
    cfg = get_config(r["arch"], smoke=True)
    sharding.set_mesh_sizes({"data": r["dp"], "model": r["tp"]})
    return sharding.param_specs(model.abstract_params(cfg, tp=r["tp"]), cfg,
                                dp_axis="data")


def _full(run: str, per_rank: list) -> dict:
    """Every rank's shards (rank r at data r // TP, model r % TP) -> full
    arrays: a sharded leaf concatenates its shards along its dims, model
    inside data; a replicated one must agree on every rank."""
    from repro_torch.core import tree
    dp, tp = RUNS[run]["dp"], RUNS[run]["tp"]
    shards = [tree.from_paths([(tuple(k.split("/")), v)
                               for k, v in g.items()]) for g in per_rank]
    out = {}
    for path, spec in tree.leaves_with_paths(_specs(run)):
        grid = [[tree.get(shards[d * tp + m], path) for m in range(tp)]
                for d in range(dp)]
        if "model" in spec:
            rows = [np.concatenate(row, axis=spec.index("model"))
                    for row in grid]
        else:
            for row in grid:
                for p in row[1:]:
                    np.testing.assert_array_equal(p, row[0])
            rows = [row[0] for row in grid]
        if "data" in spec:
            out["/".join(path)] = np.concatenate(rows,
                                                 axis=spec.index("data"))
        else:
            for p in rows[1:]:
                np.testing.assert_array_equal(p, rows[0])
            out["/".join(path)] = rows[0]
    return out


def _ref_tree(reference: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in reference.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("run,variant", CASES)
def test_losses_match_reference(runs, run, variant):
    mine, reference = runs
    got = np.asarray([s["loss"] for s in mine[run, variant]["steps"]])
    ref = REF_VARIANT.get((run, variant), variant)
    np.testing.assert_allclose(got, reference[f"{run}|{ref}|loss"],
                               rtol=LOSS_RTOL)
    if len(got) > 1:
        assert got[-1] < got[0]          # the loss falls over the steps


@pytest.mark.parametrize("run,variant", CASES)
def test_synced_grads_match_reference(runs, run, variant):
    mine, reference = runs
    got = _full(run, mine[run, variant]["grads"])
    ref = REF_VARIANT.get((run, variant), variant)
    want = _ref_tree(reference, f"{run}|{ref}|grad|")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


def test_fused_matches_unfused_after_one_step(runs):
    """``check_fused_train(ragged=False)``'s comparison on the port: one
    AdamW step (lr 1e-3) with and without ``--fuse-kernels`` on (data 2,
    model 2), the params within 5e-4 and the losses within 1e-5, each
    against the reference's unfused step's params too."""
    mine, reference = runs
    u, f = mine["8b22fused", "unfused"], mine["8b22fused", "fused"]
    assert abs(u["steps"][0]["loss"] - f["steps"][0]["loss"]) < 1e-5
    pu, pf = _full("8b22fused", u["params"]), _full("8b22fused", f["params"])
    worst = max(float(np.max(np.abs(pu[k] - pf[k]))) for k in pu)
    assert worst < FUSED_PARAM_ATOL, worst
    want = _ref_tree(reference, "8b22fused|unfused|param|")
    for got in (pu, pf):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=FUSED_PARAM_ATOL, err_msg=k)
    assert f["steps"][0]["fused_bytes_rank0"].get("all_gather", 0.0) > 0
    assert u["steps"][0]["fused_bytes_rank0"] == {}


def _tp_bytes(run: str) -> dict:
    """Per-call wire bytes (``core.ledger``'s convention, all-reduce 2 s
    (n - 1) / n, all-gather s (n - 1)) of the activation collectives of
    one forward on the model axis: an activation AllReduce of (B, L, D)
    f32 (the embedding's, and each row's attention and FFN outputs), a
    cross-entropy AllReduce of (B, L) f32 (its sum of exponentials and
    its label logit), the max's all-gather of (1, B, L); and the loss
    mean's AllReduce of one f32 over the data axis."""
    from repro_torch.configs import get_config
    r = RUNS[run]
    cfg = get_config(r["arch"], smoke=True)
    rows, tp, dp = r["batch"] // r["dp"], r["tp"], r["dp"]
    act, tok = rows * r["seq"] * cfg.d_model * 4, rows * r["seq"] * 4
    ar = 2 * (tp - 1) / tp
    return {"act": act * ar, "tok": tok * ar, "max": tok * (tp - 1),
            "rows": cfg.n_layers, "loss": 4 * 2 * (dp - 1) / dp}


def _trip_count_gaps(run: str) -> dict:
    """What the reference books beyond the port, by primitive.  The
    reference books at trace time: everything inside ``value_and_grad``
    3 times (forward, remat replay, AD transpose, each booked as the
    forward's kind), the grad sync once.  The port books each call as
    it runs: a row's attention AllReduce 3 times, its FFN AllReduce
    twice (the replay stops at the row's last saved tensor, before that
    AllReduce, whose output feeds only the residual add), the
    embedding's and the cross-entropy's AllReduces and the loss mean's
    twice (no replay outside the rows), the max's gather once (detached,
    no transpose), the FSDP gathers once and their transposes as
    reduce-scatters; the grad sync once."""
    c = _tp_bytes(run)
    return {"model_all_reduce": c["act"] * (1 + c["rows"]) + 2 * c["tok"],
            "model_all_gather": 2 * c["max"], "loss": c["loss"]}


@pytest.mark.parametrize("variant", list(RUNS["smoke22"]["variants"]))
def test_level_bytes_follow_the_reference_trip_counts(runs, variant):
    """With ``data:cxl,model:cxl`` active every byte lands on its level
    (:func:`_trip_count_gaps` says what the reference books beyond the
    port); G is the port's FSDP gathers, which the reference books 3
    times as all-gathers:

    * model: reference all_reduce and all_gather = the port's + the gaps;
      reduce_scatter (the decomposed grad sync's) equal;
    * data: reference all_gather = 3 G, the port's reduce_scatter = G;
      reference all_reduce = the port's + one more loss mean."""
    mine, reference = runs
    step = mine["smoke22", variant]["steps"][0]
    got = step["level_wire_bytes_rank0"]
    want = json.loads(str(reference[f"smoke22|{variant}|levels"]))
    gap = _trip_count_gaps("smoke22")
    assert set(got) == set(want) == {"data/cxl", "model/cxl"}
    m, rm = got["model/cxl"], want["model/cxl"]
    assert rm["all_reduce"] == m["all_reduce"] + gap["model_all_reduce"]
    assert rm["all_gather"] == m["all_gather"] + gap["model_all_gather"]
    assert rm["reduce_scatter"] == m["reduce_scatter"] > 0
    d, rd = got["data/cxl"], want["data/cxl"]
    assert d["reduce_scatter"] == d["all_gather"] > 0
    assert rd["all_gather"] == 3 * d["all_gather"]
    assert "reduce_scatter" not in rd
    assert rd["all_reduce"] == d["all_reduce"] + gap["loss"]


@pytest.mark.parametrize("variant", list(RUNS["8b24"]["variants"]))
def test_wire_bytes_at_tp4_follow_the_reference_trip_counts(runs, variant):
    """(data 2, model 4), no topology: the ledger's totals over both axes
    against the reference's, with the gaps of :func:`_trip_count_gaps`.
    The grad sync's ("data", "model") AllReduce is one fused ring under
    ``ring`` (booked as all-reduce bytes of each axis) and decomposed
    under ``cxl`` (a reduce-scatter and an all-gather over model around
    an all-reduce over data), booked once by both packages; G, the FSDP
    gathers, the reference books 3 times as all-gathers."""
    mine, reference = runs
    got = mine["8b24", variant]["steps"][0]["wire_bytes_rank0"]
    want = json.loads(str(reference[f"8b24|{variant}|wire"]))
    gap = _trip_count_gaps("8b24")
    c = _tp_bytes("8b24")
    assert want["all_reduce"] == got["all_reduce"] + \
        gap["model_all_reduce"] + gap["loss"]
    sync_rs = want.get("reduce_scatter", 0.0)
    assert (sync_rs > 0) == (variant == "cxl")
    fsdp = got["reduce_scatter"] - sync_rs
    sync_ag = got["all_gather"] - fsdp - c["max"]
    assert sync_ag == sync_rs and fsdp > 0
    assert want["all_gather"] == 3 * (fsdp + c["max"]) + sync_ag


def test_pool_bytes_by_level(runs):
    """Every level's pool moves the same bytes each step, both levels
    under cxl; ring touches no pool."""
    mine, _ = runs
    for (run, name), got in mine.items():
        levels = [s["pool_by_level"] for s in got["steps"]]
        if RUNS[run]["variants"][name]["backend"] == "ring":
            assert levels[0] == {} and all(s["pool_bytes"] == 0
                                           for s in got["steps"])
            continue
        assert set(levels[0]) == {"data", "model"}, (run, name)
        assert all(lv == levels[0] for lv in levels), (run, name)
        if RUNS[run]["variants"][name]["backend"] == "cxl":
            assert all(c["retrieved"] > 0 for c in levels[0].values())


def test_auto_resolves_each_level_like_reference(runs):
    """Under ``auto`` every decision the reference takes, at both
    levels, is one the port takes."""
    mine, reference = runs
    got = {(c["primitive"], c["level"], c["fabric"], c["backend"])
           for s in mine["smoke22", "auto"]["steps"]
           for c in s["choices_rank0"]}
    want = {tuple(c) for c in json.loads(
        str(reference["smoke22|auto|choices"]))}
    assert want and want <= got
    assert {c[1] for c in got} == {"data", "model"}


def test_reference_tp_grads_against_unsharded(runs):
    """The reference's sharded step at tp = 2 against ``jax.grad`` of its
    unsharded step on the same params and batch: a uniform multiple,
    dp x tp, of every leaf (ROADMAP queue 3: no fault).  Every rank's
    loss is the same value, and the transpose of a sum over ranks is a
    sum over ranks, so the sharded step differentiates the sum of its
    dp x tp copies of the loss (each dp rank's a mean over its rows);
    the port follows the sharded step (the tests above)."""
    _, reference = runs
    sharded = _ref_tree(reference, "smoke22|ring|grad|")
    plain = _ref_tree(reference, "smoke22|unsharded|grad|")
    assert sorted(sharded) == sorted(plain)
    n = RUNS["smoke22"]["dp"] * RUNS["smoke22"]["tp"]
    for k in plain:
        np.testing.assert_allclose(
            sharded[k], n * plain[k], rtol=GRAD_RTOL,
            atol=GRAD_ATOL * float(np.max(np.abs(sharded[k]))), err_msg=k)


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--reference":
        reference_main(*sys.argv[2:5])
    else:
        print(json.dumps({"usage": "--reference OUT.npz TMPDIR GROUP"}))
        sys.exit(2)
