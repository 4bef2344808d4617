"""The port's FSDP (+ tensor-parallel) training of the non-text models
against the JAX reference: ``repro_torch.launch.train.run_many`` on gloo
CPU ranks for ``whisper-smoke`` (the encoder, cross attention in every
decoder row) and ``phi3-vision-smoke`` (the vision prefix), over the
rank-major meshes ``(("data", 4),)`` and ``(("data", 2), ("model",
2))``, against the reference's UNSHARDED
``repro.training.train_loop.make_train_step`` on the whole batch (in a
subprocess, one a model), from the same numpy params (made by the
reference) and the same synthetic batches, extras included.

Runs, each model under ring, cxl, cxl with fused kernels and auto
(prefetch 1, the launcher's default; the two models of one mesh in one
spawn of the ranks, ``train.run_many``):

* ``*41``: (data 4), no topology; the auto plan is ``repro.launch.tune
  --smoke --nranks 4``'s;
* ``*22``: (data 2, model 2) with ``data:cxl,model:cxl`` active in both
  packages; the plan is ``tune --smoke --nranks 2 --topology FILE``'s.

Per variant: the loss of each of 3 steps (rtol 1e-4); the
step-0 synced grads, every leaf's (the encoder's, ``enc_proj``'s and
``front_proj``'s included), divided by dp x tp (ROADMAP queue 3: the
multiple the reference's own sharded step forms) at rtol 1e-4, atol
1e-5.  The ledger against the reference's sharded step, traced on the
same mesh (and topology), by trip counts: at (2, 2) each level's bytes,
the model level's AllReduce calls and auto's decisions; at (4) the
FSDP bytes.  Also the pool bytes of each level.

Also runnable as a script: ``python tests/test_torch_train_encdec.py
--reference OUT.npz TMPDIR ARCH``.
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
ARCHS = ("whisper-tiny", "phi-3-vision-4.2b")

TUNED = "<the tuned plan>"     # stands for the fixture's plan path
VARIANTS = {"ring": dict(backend="ring"), "cxl": dict(backend="cxl"),
            "cxl-fused": dict(backend="cxl", fuse_kernels=True),
            "auto": dict(backend="auto", plan_path=TUNED)}
# run -> arch, (dp, tp), topology active
RUNS = {
    "whisper41": dict(arch="whisper-tiny", dp=4, tp=1, topology=False),
    "vlm41": dict(arch="phi-3-vision-4.2b", dp=4, tp=1, topology=False),
    "whisper22": dict(arch="whisper-tiny", dp=2, tp=2, topology=True),
    "vlm22": dict(arch="phi-3-vision-4.2b", dp=2, tp=2, topology=True),
}
CASES = [(run, v) for run in RUNS for v in VARIANTS]
TP_CASES = [c for c in CASES if RUNS[c[0]]["tp"] > 1]


def _plan(tmp: str, tp: int) -> str:
    return os.path.join(tmp, f"plan{tp}.json")


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
    AdamW moment, ``mu / (1 - b1)``), the ledger of its sharded step's
    trace at (2, 2) for each variant (topology active) and at (4) under
    ring."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.core import ledger
    from repro.core.topology import (clear_active_topology, parse_topology,
                                     set_active_topology)
    from repro.data.pipeline import SyntheticTokens
    from repro.optim import adamw_init
    from repro.training.train_loop import (TrainConfig,
                                           make_sharded_train_step,
                                           make_train_step)

    cfg = get_config(arch, smoke=True)
    params0 = _load_tree(os.path.join(tmp, f"{arch}.npz"))
    batches = [{k: jnp.asarray(v) for k, v in b.items()} for _, b in zip(
        range(STEPS), SyntheticTokens(cfg, batch=BATCH, seq=SEQ))]
    out = {}
    step = jax.jit(make_train_step(cfg, TrainConfig(**_tcfg_kwargs(
        {}, ""))))
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
    cells = [((2, 2), name, fields) for name, fields in VARIANTS.items()]
    cells.append(((4, 1), "ring", VARIANTS["ring"]))
    for (dp, tp), name, fields in cells:
        if tp > 1:
            set_active_topology(parse_topology(os.path.join(
                tmp, "topology.json")))
        mesh = jax.make_mesh((dp, tp), ("data", "model"),
                             devices=jax.devices()[:dp * tp])
        sstep, _, _, _ = make_sharded_train_step(
            cfg, TrainConfig(**_tcfg_kwargs(fields, _plan(tmp, tp))), mesh,
            dp_axis=("data",))
        ledger.reset()
        sstep.lower(params0, adamw_init(params0), batches[0])
        snap = ledger.snapshot()
        key = f"{dp}{tp}|{name}"
        out[f"{key}|levels"] = np.asarray(json.dumps(
            snap["level_wire_bytes"]))
        out[f"{key}|wire"] = np.asarray(json.dumps(snap["wire_bytes"]))
        out[f"{key}|choices"] = np.asarray(json.dumps(sorted(
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

    tmp = str(tmp_path_factory.mktemp("torch_train_encdec"))
    topo_path = os.path.join(tmp, "topology.json")
    with open(topo_path, "w") as f:
        json.dump(reference_topology_json(), f)
    argv = sys.argv
    try:
        for tp, extra in ((2, ["--topology", topo_path]), (1, [])):
            sys.argv = ["tune", "--smoke", "--nranks", str(4 // tp),
                        "--quiet", "--out", _plan(tmp, tp)] + extra
            jax_tune.main()
    finally:
        sys.argv = argv
    for arch in ARCHS:
        # the smoke models' GLOBAL shapes are the same at tp 1 and 2 (no
        # padded heads or vocabulary): one set of params serves the
        # unsharded step and both meshes
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
        for group in (("whisper41", "vlm41"), ("whisper22", "vlm22")):
            specs = [train.RunSpec(
                arch=RUNS[run]["arch"], smoke=True,
                variants=tuple(TrainConfig(**_tcfg_kwargs(
                    f, _plan(tmp, RUNS[run]["tp"])))
                    for f in VARIANTS.values()),
                steps=STEPS, batch=BATCH, seq=SEQ, dp=RUNS[run]["dp"],
                tp=RUNS[run]["tp"], device="cpu",
                topology=parse_topology(topo_path)
                if RUNS[run]["topology"] else None,
                params_path=os.path.join(tmp, f"{RUNS[run]['arch']}.npz"),
                capture_grads=True, timeout_s=120.0) for run in group]
            for run, got in zip(group, train.run_many(specs)):
                for name, rec in zip(VARIANTS, got):
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
        if tp > 1 and "model" in spec:
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
    got = np.asarray([s["loss"] for s in mine[run, variant]["steps"]])
    want = reference[RUNS[run]["arch"]]["loss"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    # each model's loss moves over the 3 batches as the reference's does:
    # phi3-vision-smoke's falls; whisper-smoke's later batches score
    # above its first in both packages
    assert list(got[1:] < got[0]) == list(want[1:] < want[0])
    if RUNS[run]["arch"] == "phi-3-vision-4.2b":
        assert got[-1] < got[0]


@pytest.mark.parametrize("run,variant", CASES)
def test_synced_grads_match_unsharded_reference(runs, run, variant):
    """The step-0 synced grads, assembled, are dp x tp times the
    reference's unsharded gradient of the whole batch's mean loss, the
    frontend's leaves included (the encoder runs outside the FSDP gather
    and without remat; its grads reach it through the decoder rows'
    replays and are summed by the grad sync)."""
    mine, reference = runs
    r = RUNS[run]
    got = _full(run, mine[run, variant]["grads"])
    want = {k[5:]: v for k, v in reference[r["arch"]].items()
            if k.startswith("grad|")}
    assert sorted(got) == sorted(want)
    frontend = [k for k in want if k.split("/")[0] in
                ("encoder", "enc_proj", "enc_norm", "front_proj")]
    assert frontend
    n = r["dp"] * r["tp"]
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k] / n, want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


def _model_bytes(run: str) -> dict:
    """Per-call wire bytes (``core.ledger``'s convention, all-reduce
    2 s (n - 1) / n, all-gather s (n - 1)) on the model axis of one
    forward: the embedding's AllReduce of (B, L, D) f32, a decoder row's
    of (B, P + L, D) (P the vision prefix), an encoder row's of (B, S,
    D) (S the audio stub's frames), the cross-entropy's two of (B, L)
    f32, the max's all-gather of (1, B, L); and the loss mean's
    AllReduce of one f32 over the data axis."""
    from repro_torch.configs import get_config
    r = RUNS[run]
    cfg = get_config(r["arch"], smoke=True)
    rows, tp, dp = BATCH // r["dp"], r["tp"], r["dp"]
    prefix = cfg.frontend_tokens if cfg.encoder is None else 0
    ar = 2 * (tp - 1) / tp
    row = rows * cfg.d_model * 4 * ar
    return {"embed": row * SEQ, "row": row * (prefix + SEQ),
            "enc_row": row * (cfg.encoder.source_len if cfg.encoder else 0),
            "tok": rows * SEQ * 4 * ar, "max": rows * SEQ * 4 * (tp - 1),
            "rows": cfg.n_layers,
            "enc_rows": cfg.encoder.n_layers if cfg.encoder else 0,
            "loss": 4 * 2 * (dp - 1) / dp}


def _trip_count_gaps(run: str) -> dict:
    """What the reference's sharded step books beyond the port, by
    primitive, on the model level.  The reference books at trace time,
    everything inside ``value_and_grad`` 3 times (forward, remat replay,
    AD transpose), the encoder's rows too though no remat wraps them.
    The port books each call as it runs: in a decoder row the self and
    the cross attention's AllReduces 3 times (forward, replay,
    transpose), the FFN's twice (the replay stops at the row's last
    saved tensor, before it); an encoder row's two AllReduces twice (no
    replay); the embedding's and the cross-entropy's twice, the max's
    gather once."""
    c = _model_bytes(run)
    return {"model_all_reduce": c["embed"] + c["row"] * c["rows"]
            + 2 * c["enc_row"] * c["enc_rows"] + 2 * c["tok"],
            "model_all_gather": 2 * c["max"], "loss": c["loss"]}


@pytest.mark.parametrize("run,variant", TP_CASES)
def test_level_bytes_follow_the_reference_trip_counts(runs, run, variant):
    """With ``data:cxl,model:cxl`` active every byte lands on its level;
    against the reference's sharded step on the same mesh:

    * model: reference all_reduce and all_gather = the port's + the gaps
      of :func:`_trip_count_gaps`; reduce_scatter (the decomposed grad
      sync's) equal;
    * data: the port's reduce_scatter (the transposes of its FSDP
      gathers) = its all_gather; the reference's all_gather = 3 times
      the port's; reference all_reduce = the port's + one more loss
      mean (the encoder's dp-replicated grads are synced once by
      both)."""
    mine, reference = runs
    got = mine[run, variant]["steps"][0]["level_wire_bytes_rank0"]
    want = json.loads(str(reference[RUNS[run]["arch"]][
        f"22|{variant}|levels"]))
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


@pytest.mark.parametrize("run,variant", TP_CASES)
def test_model_level_all_reduce_calls(runs, run, variant):
    """The model level's AllReduce calls a rank-step, as booked: the
    embedding's and the cross-entropy's two, twice each (forward,
    transpose); a decoder row's self attention (3: forward, replay,
    transpose), cross attention (3) and FFN (2); an encoder row's
    attention and FFN, twice each."""
    from repro_torch.configs import get_config
    mine, _ = runs
    cfg = get_config(RUNS[run]["arch"], smoke=True)
    per_row = 8 if cfg.encoder else 5
    enc = 4 * cfg.encoder.n_layers if cfg.encoder else 0
    for s in mine[run, variant]["steps"]:
        calls = s["level_counts_rank0"]["model/cxl"]
        assert calls["all_reduce"] == 2 + 2 * 2 + per_row * cfg.n_layers \
            + enc, calls


@pytest.mark.parametrize("run", [r for r in RUNS if RUNS[r]["tp"] == 1])
def test_fsdp_bytes_follow_the_reference_trip_counts(runs, run):
    """(data 4), ring, no topology: the port's FSDP reduce-scatters (its
    gathers' transposes) equal its all-gathers, the reference books its
    gathers 3 times, and the AllReduces differ by one loss mean (the
    grad sync of the replicated leaves, the encoder's and the frontend
    projection's among them, booked once by both)."""
    mine, reference = runs
    got = mine[run, "ring"]["steps"][0]["wire_bytes_rank0"]
    want = json.loads(str(reference[RUNS[run]["arch"]]["41|ring|wire"]))
    gap = _trip_count_gaps(run)
    assert got["reduce_scatter"] == got["all_gather"] > 0
    assert want["all_gather"] == 3 * got["all_gather"]
    assert want["all_reduce"] == pytest.approx(
        got["all_reduce"] + gap["loss"], rel=1e-12)


def test_pool_bytes_by_level(runs):
    """Every level's pool moves the same bytes each step, under cxl and
    cxl+fused; ring touches no pool."""
    mine, _ = runs
    for (run, name), got in mine.items():
        levels = [s["pool_by_level"] for s in got["steps"]]
        backend = VARIANTS[name]["backend"]
        if backend == "ring":
            assert levels[0] == {} and all(s["pool_bytes"] == 0
                                           for s in got["steps"])
            continue
        want = {"data", "model"} if RUNS[run]["tp"] > 1 else {"data"}
        assert set(levels[0]) == want, (run, name)
        assert all(lv == levels[0] for lv in levels), (run, name)
        if backend == "cxl":
            assert all(c["retrieved"] > 0 for c in levels[0].values())


@pytest.mark.parametrize("run", [r for r in RUNS if RUNS[r]["tp"] > 1])
def test_auto_resolves_each_level_like_reference(runs, run):
    """Under ``auto`` every decision the reference's sharded step takes,
    at both levels, is one the port takes."""
    mine, reference = runs
    got = {(c["primitive"], c["level"], c["fabric"], c["backend"])
           for s in mine[run, "auto"]["steps"] for c in s["choices_rank0"]}
    want = {tuple(c) for c in json.loads(
        str(reference[RUNS[run]["arch"]]["22|auto|choices"]))}
    assert want and want <= got
    assert {c[1] for c in got} == {"data", "model"}


@pytest.mark.parametrize("run", list(RUNS))
def test_fused_kernels_take_the_frontend_rows(runs, run):
    """Under ``--fuse-kernels`` the decoder rows' matmul weights reach
    the fused path (fused all-gather bytes booked), the encoder's never
    do (dp-replicated, outside the gather); the gathers a step are the
    decoder rows' and the embedding's only."""
    mine, _ = runs
    s = mine[run, "cxl-fused"]["steps"][0]
    assert s["fused_bytes_rank0"].get("all_gather", 0.0) > 0
    assert not any(k.startswith("encoder") for k in s["gathers_rank0"])
    assert set(s["gathers_rank0"]) == {"embed", "g0"}


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--reference":
        reference_main(*sys.argv[2:5])
    else:
        print(json.dumps({"usage": "--reference OUT.npz TMPDIR ARCH"}))
        sys.exit(2)
