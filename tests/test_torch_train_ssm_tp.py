"""The port's tensor-parallel training of the SSM models against the JAX
reference: ``repro_torch.launch.train.run_ranks`` on gloo CPU ranks over
the rank-major mesh ``(("data", DP), ("model", TP))`` for
``zamba2-smoke`` (Mamba-2 rows, the shared attention block) and
``falcon-mamba-smoke`` (Mamba-1 rows), against the reference's
UNSHARDED ``repro.training.train_loop.make_train_step`` on the whole
batch, from the same numpy params (made by the reference) and the same
synthetic batches.

Why the unsharded step: the reference's sharded Mamba-2 computes another
function (its gated norm reduces over a rank's d_inner / tp channels,
ROADMAP queue 3); the port's gated norm spans d_inner at every tp, so
its sharded step is held to the contract of the reference's
``check_train_equivalence``, the unsharded step.

Runs (prefetch 1, the launcher's default):

* ``zamba22``, ``falcon22``: (data 2, model 2) under ring, cxl, cxl with
  fused kernels and auto, with the topology ``data:cxl,model:cxl``
  active in both packages; the auto plan is ``repro.launch.tune --smoke
  --nranks 2 --topology FILE``'s;
* ``zamba24``, ``falcon24``: the reference's (data 2, model 4) of
  ``check_train_equivalence`` under ring and cxl, no topology.

Per variant: the loss of each of 3 steps (rtol 1e-4); the step-0 synced
grads (rtol 1e-4, atol 1e-5) divided by dp x tp, the multiple that the
reference's own sharded step forms
(``test_torch_train_tp.py::test_reference_tp_grads_against_unsharded``);
zamba2-smoke's loss falls.  For the (2, 2) runs: each level's ledger
bytes against the reference's sharded step's (traced on the same mesh
and topology) by the trip counts of ``test_torch_train_tp.py``, plus the
port's gated-norm AllReduce, which the reference has not; the pool bytes
of both levels; auto's decisions at both levels; the model level's
AllReduce calls (``level_counts``).  Also ``param_specs``
of both packages for both models at (2, 2) and (2, 4).

The two models of one mesh train in one spawn of the ranks
(``train.run_many``).  Also runnable as a script: ``python
tests/test_torch_train_ssm_tp.py --reference OUT.npz TMPDIR ARCH``.
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
STEPS, BATCH, SEQ = 3, 4, 32
ARCHS = ("zamba2-1.2b", "falcon-mamba-7b")

TUNED = "<the tuned plan>"     # stands for the fixture's plan path
VARIANTS22 = {"ring": dict(backend="ring"), "cxl": dict(backend="cxl"),
              "cxl-fused": dict(backend="cxl", fuse_kernels=True),
              "auto": dict(backend="auto", plan_path=TUNED)}
VARIANTS24 = {"ring": dict(backend="ring"), "cxl": dict(backend="cxl")}
# run -> arch, (dp, tp), topology active, variants
RUNS = {
    "zamba22": dict(arch="zamba2-1.2b", dp=2, tp=2, topology=True,
                    variants=VARIANTS22),
    "falcon22": dict(arch="falcon-mamba-7b", dp=2, tp=2, topology=True,
                     variants=VARIANTS22),
    "zamba24": dict(arch="zamba2-1.2b", dp=2, tp=4, topology=False,
                    variants=VARIANTS24),
    "falcon24": dict(arch="falcon-mamba-7b", dp=2, tp=4, topology=False,
                     variants=VARIANTS24),
}
CASES = [(run, v) for run, r in RUNS.items() for v in r["variants"]]


def _tcfg_kwargs(fields: dict, plan_path: str) -> dict:
    """The launcher's TrainConfig (warm-up min(20, steps // 5), no
    clipping) with the variant's fields."""
    return dict(lr=3e-4, warmup=min(20, STEPS // 5), total_steps=STEPS,
                clip_norm=None, **{k: plan_path if v == TUNED else v
                                   for k, v in fields.items()})


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


def reference_main(out_path: str, tmp: str, arch: str) -> None:
    """The reference side for ``arch``, in a process with 4 forced host
    devices: its unsharded step's losses and step-0 grads (from its first
    AdamW moment, ``mu / (1 - b1)``), and for each (2, 2) variant the
    ledger of its sharded step's trace on the same mesh and topology."""
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

    cfg = get_config(arch, smoke=True)
    plan_path = os.path.join(tmp, "plan.json")
    params0 = _load_tree(os.path.join(tmp, f"{arch}.npz"))
    batches = [{k: jnp.asarray(v) for k, v in b.items()} for _, b in zip(
        range(STEPS), SyntheticTokens(cfg, batch=BATCH, seq=SEQ))]
    out = {}
    step = jax.jit(make_train_step(cfg, TrainConfig(**_tcfg_kwargs(
        {}, plan_path))))
    params, opt = params0, adamw_init(params0)
    losses = []
    for i, b in enumerate(batches):
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        if i == 0:
            for path, mu in jax.tree_util.tree_leaves_with_path(opt.mu):
                out["grad|" + "/".join(p.key for p in path)] = \
                    np.asarray(mu) / np.float32(1 - B1)
    out["loss"] = np.asarray(losses)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         devices=jax.devices()[:4])
    for name, fields in VARIANTS22.items():
        set_active_topology(parse_topology(os.path.join(tmp,
                                                        "topology.json")))
        sstep, _, _, _ = make_sharded_train_step(
            cfg, TrainConfig(**_tcfg_kwargs(fields, plan_path)), mesh,
            dp_axis=("data",))
        ledger.reset()
        sstep.lower(params0, adamw_init(params0), batches[0])
        snap = ledger.snapshot()
        out[f"{name}|levels"] = np.asarray(json.dumps(
            snap["level_wire_bytes"]))
        out[f"{name}|choices"] = np.asarray(json.dumps(sorted(
            {(c["primitive"], c["level"], c["fabric"], c["backend"])
             for c in snap["auto_choices"]})))
        clear_active_topology()
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

    tmp = str(tmp_path_factory.mktemp("torch_train_ssm_tp"))
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
    for arch in ARCHS:
        # the smoke models' GLOBAL shapes are the same at tp 1, 2 and 4
        # (no padded heads or vocabulary): one set of params serves the
        # unsharded step and every mesh (the port's loader checks the
        # shapes at the run's tp)
        jparams = jax_model.init_params(
            jax.random.key(7), jax_get_config(arch, smoke=True), tp=1,
            dtype=jnp.float32)
        train.save_params_npz(jax.tree.map(np.asarray, jparams),
                              os.path.join(tmp, f"{arch}.npz"))

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    refs = {arch: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--reference",
         os.path.join(tmp, f"reference.{arch}.npz"), tmp, arch], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for arch in ARCHS}
    try:
        mine = {}
        # the runs of one mesh share a spawn of the ranks (run_many)
        for group in (("zamba22", "falcon22"), ("zamba24", "falcon24")):
            specs = [train.RunSpec(
                arch=RUNS[run]["arch"], smoke=True,
                variants=tuple(TrainConfig(**_tcfg_kwargs(f, plan_path))
                               for f in RUNS[run]["variants"].values()),
                steps=STEPS, batch=BATCH, seq=SEQ, dp=RUNS[run]["dp"],
                tp=RUNS[run]["tp"], device="cpu",
                topology=parse_topology(topo_path)
                if RUNS[run]["topology"] else None,
                params_path=os.path.join(tmp, f"{RUNS[run]['arch']}.npz"),
                capture_grads=True, timeout_s=120.0) for run in group]
            for run, got in zip(group, train.run_many(specs)):
                for name, rec in zip(RUNS[run]["variants"], got):
                    mine[run, name] = rec
        logs = {arch: ref.communicate(timeout=400)[0]
                for arch, ref in refs.items()}
    finally:
        for ref in refs.values():
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    reference = {}
    for arch, ref in refs.items():
        assert ref.returncode == 0, logs[arch][-3000:]
        with np.load(os.path.join(tmp, f"reference.{arch}.npz")) as f:
            reference[arch] = {k: f[k] for k in f.files}
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
    """Every rank's synced grad shards (rank r at data r // TP, model
    r % TP) -> the GLOBAL arrays: a sharded leaf concatenates its shards
    along its dims, model inside data; a replicated one must agree on
    every rank."""
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


@pytest.mark.parametrize("run,variant", CASES)
def test_losses_match_unsharded_reference(runs, run, variant):
    mine, reference = runs
    arch = RUNS[run]["arch"]
    got = np.asarray([s["loss"] for s in mine[run, variant]["steps"]])
    want = reference[arch]["loss"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    # zamba2-smoke's loss falls over the 3 steps; falcon-mamba-smoke's
    # rises on its third batch in both packages, as at tp = 1
    assert (got[-1] < got[0]) == (want[-1] < want[0])
    if arch == "zamba2-1.2b":
        assert got[-1] < got[0]


@pytest.mark.parametrize("run,variant", CASES)
def test_synced_grads_match_unsharded_reference(runs, run, variant):
    """The step-0 synced grads, assembled, are dp x tp times the
    reference's unsharded gradient of the whole batch's mean loss (every
    rank differentiates its copy of the loss; the transposes of the data
    mean and of the model-axis sums add the dp x tp cotangents)."""
    mine, reference = runs
    r = RUNS[run]
    got = _full(run, mine[run, variant]["grads"])
    want = {k[5:]: v for k, v in reference[r["arch"]].items()
            if k.startswith("grad|")}
    assert sorted(got) == sorted(want)
    n = r["dp"] * r["tp"]
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k] / n, want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


def _model_bytes(run: str) -> dict:
    """Per-call wire bytes (``core.ledger``'s convention, all-reduce
    2 s (n - 1) / n, all-gather s (n - 1)) on the model axis of one
    forward: an activation AllReduce of (B, L, D) f32 (the embedding's,
    and each row's output projection or FFN), a per-token one of (B, L)
    f32 (the cross-entropy's two sums; the gated norm's sum of squares,
    (B, L, 1)), the max's all-gather of (1, B, L); and the loss mean's
    AllReduce of one f32 over the data axis.  ``rows`` counts the rows
    of each kind."""
    from repro_torch.configs import get_config
    r = RUNS[run]
    cfg = get_config(r["arch"], smoke=True)
    rows, tp, dp = BATCH // r["dp"], r["tp"], r["dp"]
    act, tok = rows * SEQ * cfg.d_model * 4, rows * SEQ * 4
    ar = 2 * (tp - 1) / tp
    return {"act": act * ar, "tok": tok * ar, "max": tok * (tp - 1),
            "rows": cfg.n_layers, "mamba2": cfg.layer_pattern.count("2"),
            "loss": 4 * 2 * (dp - 1) / dp}


def _trip_count_gaps(run: str) -> dict:
    """What the reference's sharded step books beyond the port, by
    primitive, on the model level.  The reference books at trace time,
    everything inside ``value_and_grad`` 3 times (forward, remat replay,
    AD transpose).  The port books each call as it runs: a row's last
    AllReduce (Mamba's ``out_proj``, the shared block's FFN) twice (the
    replay stops at the row's last saved tensor, before it), every other
    AllReduce inside a row 3 times (Mamba-1's ``x_proj``, the shared
    block's attention), the embedding's and the cross-entropy's twice,
    the max's gather once.  The gated norm's AllReduce (each Mamba-2
    row, replayed: 3 times) is the port's alone, by design (ROADMAP
    queue 3)."""
    c = _model_bytes(run)
    return {"model_all_reduce": c["act"] * (1 + c["rows"]) + 2 * c["tok"]
            - 3 * c["tok"] * c["mamba2"],
            "model_all_gather": 2 * c["max"], "loss": c["loss"]}


@pytest.mark.parametrize("run,variant", [c for c in CASES
                                         if RUNS[c[0]]["topology"]])
def test_level_bytes_follow_the_reference_trip_counts(runs, run, variant):
    """With ``data:cxl,model:cxl`` active every byte lands on its level;
    against the reference's sharded step on the same mesh:

    * model: reference all_reduce and all_gather = the port's + the gaps
      of :func:`_trip_count_gaps` (the gated norm's AllReduce taken out
      of the port's); reduce_scatter (the decomposed grad sync's) equal;
    * data: the port's reduce_scatter (the transposes of its FSDP
      gathers) = its all_gather; the reference's all_gather = 3 times
      the port's; reference all_reduce = the port's + one more loss
      mean."""
    mine, reference = runs
    step = mine[run, variant]["steps"][0]
    got = step["level_wire_bytes_rank0"]
    want = json.loads(str(reference[RUNS[run]["arch"]][f"{variant}|levels"]))
    gap = _trip_count_gaps(run)
    assert set(got) == set(want) == {"data/cxl", "model/cxl"}
    m, rm = got["model/cxl"], want["model/cxl"]
    assert rm["all_reduce"] == pytest.approx(
        m["all_reduce"] + gap["model_all_reduce"], rel=1e-12)
    assert rm["all_gather"] == m["all_gather"] + gap["model_all_gather"]
    assert rm["reduce_scatter"] == m["reduce_scatter"] > 0
    d, rd = got["data/cxl"], want["data/cxl"]
    assert d["reduce_scatter"] == d["all_gather"] > 0
    assert rd["all_gather"] == 3 * d["all_gather"]
    assert "reduce_scatter" not in rd
    assert rd["all_reduce"] == d["all_reduce"] + gap["loss"]


@pytest.mark.parametrize("run,variant", [c for c in CASES
                                         if RUNS[c[0]]["topology"]])
def test_model_level_all_reduce_calls(runs, run, variant):
    """The model level's AllReduce calls a rank-step, as booked: the
    embedding's and the cross-entropy's two, twice each (forward,
    transpose), and 5 a row: a Mamba-1 row's ``x_proj`` (3: forward,
    replay, transpose) and ``out_proj`` (2), a Mamba-2 row's gated norm
    (3) and ``out_proj`` (2), the shared block's attention (3) and FFN
    (2).  The grad sync's model-level share is a reduce-scatter and an
    all-gather around the data level's AllReduce (no smoke leaf is
    FSDP-sharded and replicated over model)."""
    from repro_torch.configs import get_config
    mine, _ = runs
    rows = get_config(RUNS[run]["arch"], smoke=True).n_layers
    for s in mine[run, variant]["steps"]:
        calls = s["level_counts_rank0"]["model/cxl"]
        assert calls["all_reduce"] == 2 + 2 * 2 + 5 * rows, calls


def test_pool_bytes_by_level(runs):
    """Every level's pool moves the same bytes each step, both levels
    under cxl and cxl+fused; ring touches no pool."""
    mine, _ = runs
    for (run, name), got in mine.items():
        levels = [s["pool_by_level"] for s in got["steps"]]
        backend = RUNS[run]["variants"][name]["backend"]
        if backend == "ring":
            assert levels[0] == {} and all(s["pool_bytes"] == 0
                                           for s in got["steps"])
            continue
        assert set(levels[0]) == {"data", "model"}, (run, name)
        assert all(lv == levels[0] for lv in levels), (run, name)
        if backend == "cxl":
            assert all(c["retrieved"] > 0 for c in levels[0].values())


@pytest.mark.parametrize("run", ["zamba22", "falcon22"])
def test_auto_resolves_each_level_like_reference(runs, run):
    """Under ``auto`` every decision the reference's sharded step takes,
    at both levels, is one the port takes."""
    mine, reference = runs
    got = {(c["primitive"], c["level"], c["fabric"], c["backend"])
           for s in mine[run, "auto"]["steps"] for c in s["choices_rank0"]}
    want = {tuple(c) for c in json.loads(
        str(reference[RUNS[run]["arch"]]["auto|choices"]))}
    assert want and want <= got
    assert {c[1] for c in got} == {"data", "model"}


@pytest.mark.parametrize("run", list(RUNS))
def test_shared_block_gathers_and_scan_launches(runs, run):
    """Every step of every variant: ``shared_a`` gathered once a shared
    group (the reference's site under prefetch 1), and the SSM rows'
    scan forward and backward run on every rank (their plain versions
    on the CPU: the kernels' counters stay 0 here)."""
    from repro_torch.configs import get_config
    from repro_torch.models import blocks
    mine, _ = runs
    cfg = get_config(RUNS[run]["arch"], smoke=True)
    sites = sum(g.shared for g in blocks.scan_groups(cfg))
    for name in RUNS[run]["variants"]:
        for s in mine[run, name]["steps"]:
            assert s["gathers_rank0"].get("shared_a", 0) == sites
            assert s["launches"]["ssm_scan"] == 0


@pytest.mark.parametrize("mesh", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_param_specs_match_reference(arch, mesh, smoke):
    """Leaf by leaf, the Mamba leaves included (``in_bc`` and
    ``conv_bc`` replicated over model; ``A_log``, ``D`` and ``norm``
    sharded on their channel or head dim), on the GLOBAL shapes of each
    package's params at that tp."""
    import jax

    from repro.configs import get_config as jax_config
    from repro.models import model as jax_model
    from repro.models import sharding as jax_sharding
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models import model, sharding

    dp, tp = mesh
    sizes = {"data": dp, "model": tp}
    jcfg, cfg = jax_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    jax_sharding.set_mesh_sizes(sizes)
    jabs = jax_model.abstract_params(jcfg, tp=tp)
    jspecs = jax_sharding.param_specs(jabs, jcfg, dp_axis="data", fsdp=True)
    want = {"/".join(k.key for k in path): (tuple(leaf.shape), tuple(spec))
            for (path, leaf), spec in zip(
                jax.tree_util.tree_leaves_with_path(jabs),
                jax.tree.leaves(jspecs, is_leaf=lambda s: isinstance(
                    s, jax.sharding.PartitionSpec)))}
    sharding.set_mesh_sizes(sizes)
    abstract = model.abstract_params(cfg, tp=tp)
    specs = sharding.param_specs(abstract, cfg, dp_axis="data")
    got = {"/".join(p): (tuple(x.shape), tree.get(specs, p))
           for p, x in tree.leaves_with_paths(abstract)}
    assert got == want
    mamba = {k: s for k, (_, s) in got.items() if "/mamba/" in k}
    assert mamba
    for k, s in mamba.items():
        leaf = k.rsplit("/", 1)[1]
        assert ("model" in s) == (leaf not in ("in_bc", "conv_bc")), k


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--reference":
        reference_main(*sys.argv[2:5])
    else:
        print(json.dumps({"usage": "--reference OUT.npz TMPDIR ARCH"}))
        sys.exit(2)
