"""The port's expert-parallel MoE training against the JAX reference:
``repro_torch.launch.train.run_ranks`` on gloo CPU ranks over the
rank-major mesh ``(("data", 2), ("model", 2))`` against
``repro.training.train_loop.make_sharded_train_step`` on the same mesh
of forced host devices (in a subprocess per arch), from the same numpy
params (made by the reference at tp = 2) and the same synthetic batches,
with the topology ``data:cxl,model:cxl`` active in both packages.

The reference's ``check_train_equivalence`` holds a sharded MoE step to
an unsharded one with ``capacity_factor=16`` and no router loss; here
the port is held to the reference's *sharded* step at the configs' own
capacity factor (1.25) and router-loss weight, so every rank drops the
same (token, slot) pairs and adds the same auxiliary loss.

Runs: ``granite-moe-smoke`` (40 experts -> 4, top-2) and
``arctic-smoke`` (its dense residual MLP beside the experts), each under
ring (the default double-buffered prefetch), and cxl, cxl with fused
kernels and auto (``repro.launch.tune --smoke --nranks 2 --topology``'s
plan) with ``prefetch=0``, the schedule of the card's Granite cell.
Per variant: the loss of each step (rtol 1e-4, and it falls), the
step-0 synced grads (rtol 1e-4, atol 1e-5; the reference's from its
first AdamW moment, ``mu / (1 - b1)``), and the ledger's bytes of each
level - the model level's all_to_all among them - against the
reference's trip counts.

Also runnable as a script: ``python tests/test_torch_train_moe.py
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
sys.path.insert(0, HERE)
from test_torch_train_tp import (_grads_from_mu, _load_tree,  # noqa: E402
                                 reference_topology_json)

B1 = 0.9
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
ARCHS = ("granite-moe-3b-a800m", "arctic-480b")
DP, TP, STEPS, BATCH, SEQ = 2, 2, 3, 4, 32
TUNED = "<the tuned plan>"     # stands for the fixture's plan path
VARIANTS = {
    "ring": dict(backend="ring"),
    "cxl": dict(backend="cxl", prefetch=0),
    "cxl-fused": dict(backend="cxl", fuse_kernels=True, prefetch=0),
    "auto": dict(backend="auto", plan_path=TUNED, prefetch=0)}
CASES = [(arch, v) for arch in ARCHS for v in VARIANTS]


def _tcfg_kwargs(fields: dict, plan_path: str) -> dict:
    """The launcher's TrainConfig (warm-up min(20, steps // 5), no
    clipping) with the variant's fields."""
    return dict(lr=3e-4, warmup=min(20, STEPS // 5), total_steps=STEPS,
                clip_norm=None, **{k: plan_path if v == TUNED else v
                                   for k, v in fields.items()})


def reference_main(out_path: str, tmp: str, arch: str) -> None:
    """The reference side of ``arch``'s runs, in a process with 8 forced
    host devices."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.core import ledger
    from repro.core.topology import (clear_active_topology, parse_topology,
                                     set_active_topology)
    from repro.data.pipeline import SyntheticTokens
    from repro.optim import adamw_init
    from repro.training.train_loop import (TrainConfig,
                                           make_sharded_train_step)

    out = {}
    plan_path = os.path.join(tmp, "plan.json")
    cfg = get_config(arch, smoke=True)
    params0 = _load_tree(os.path.join(tmp, f"{arch}.npz"))
    batches = [{k: jnp.asarray(v) for k, v in b.items()} for _, b in zip(
        range(STEPS), SyntheticTokens(cfg, batch=BATCH, seq=SEQ))]
    mesh = jax.make_mesh((DP, TP), ("data", "model"),
                         devices=jax.devices()[:DP * TP])
    for name, fields in VARIANTS.items():
        set_active_topology(parse_topology(
            os.path.join(tmp, "topology.json")))
        tcfg = TrainConfig(**_tcfg_kwargs(fields, plan_path))
        step, _, _, _ = make_sharded_train_step(cfg, tcfg, mesh,
                                                dp_axis=("data",))
        params, opt = params0, adamw_init(params0)
        losses, auxes = [], []
        for i, b in enumerate(batches):
            ledger.reset()
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            auxes.append(float(m["aux"]))
            if i == 0:      # the first call traced: the step's ledger
                snap = ledger.snapshot()
                key = f"{arch}|{name}"
                out[f"{key}|levels"] = np.asarray(json.dumps(
                    snap["level_wire_bytes"]))
                out[f"{key}|choices"] = np.asarray(json.dumps(sorted(
                    {(c["primitive"], c["level"], c["fabric"],
                      c["backend"]) for c in snap["auto_choices"]})))
                for k, g in _grads_from_mu(opt).items():
                    out[f"{key}|grad|{k}"] = g
        out[f"{arch}|{name}|loss"] = np.asarray(losses)
        out[f"{arch}|{name}|aux"] = np.asarray(auxes)
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

    tmp = str(tmp_path_factory.mktemp("torch_train_moe"))
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
        jparams = jax_model.init_params(
            jax.random.key(7), jax_get_config(arch, smoke=True), tp=TP,
            dtype=jnp.float32)
        train.save_params_npz(jax.tree.map(np.asarray, jparams),
                              os.path.join(tmp, f"{arch}.npz"))

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
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
        for arch in ARCHS:
            spec = train.RunSpec(
                arch=arch, smoke=True,
                variants=tuple(TrainConfig(**_tcfg_kwargs(f, plan_path))
                               for f in VARIANTS.values()),
                steps=STEPS, batch=BATCH, seq=SEQ, dp=DP, tp=TP,
                device="cpu", topology=parse_topology(topo_path),
                params_path=os.path.join(tmp, f"{arch}.npz"),
                capture_grads=True, timeout_s=120.0)
            for name, got in zip(VARIANTS, train.run_ranks(spec)):
                mine[arch, name] = got
        logs = {arch: ref.communicate(timeout=600)[0]
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
            reference.update({k: f[k] for k in f.files})
    return mine, reference


def _full(arch: str, per_rank: list) -> dict:
    """Every rank's shards (rank r at data r // TP, model r % TP) -> the
    GLOBAL arrays, by the launcher's own assembly."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.launch import train
    from repro_torch.models import model, sharding
    cfg = get_config(arch, smoke=True)
    sharding.set_mesh_sizes({"data": DP, "model": TP})
    specs = sharding.param_specs(model.abstract_params(cfg, tp=TP), cfg,
                                 dp_axis="data")
    layouts = [{"specs": {"/".join(p): s
                          for p, s in tree.leaves_with_paths(specs)},
                "dp_axis": "data", "tp_axis": "model", "dp_index": r // TP,
                "n_dp": DP, "tp_index": r % TP, "tp": TP}
               for r in range(DP * TP)]
    full = train.assemble_params(per_rank, layouts)
    return {"/".join(p): x for p, x in tree.leaves_with_paths(full)}


@pytest.mark.parametrize("arch,variant", CASES)
def test_losses_match_reference(runs, arch, variant):
    mine, reference = runs
    got = np.asarray([s["loss"] for s in mine[arch, variant]["steps"]])
    np.testing.assert_allclose(got, reference[f"{arch}|{variant}|loss"],
                               rtol=LOSS_RTOL)
    assert got[-1] < got[0]          # the loss falls over the steps
    # the routers' loss is in it: the reference's metric is positive
    assert np.all(reference[f"{arch}|{variant}|aux"] > 0)


@pytest.mark.parametrize("arch,variant", CASES)
def test_synced_grads_match_reference(runs, arch, variant):
    mine, reference = runs
    got = _full(arch, mine[arch, variant]["grads"])
    pre = f"{arch}|{variant}|grad|"
    want = {k[len(pre):]: v for k, v in reference.items()
            if k.startswith(pre)}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


def test_pool_bytes_by_level(runs):
    """Every level's pool moves the same bytes each step, both levels
    under cxl (the AllToAlls ride the model level's); ring touches no
    pool."""
    mine, _ = runs
    for (arch, name), got in mine.items():
        levels = [s["pool_by_level"] for s in got["steps"]]
        if VARIANTS[name]["backend"] == "ring":
            assert levels[0] == {} and all(s["pool_bytes"] == 0
                                           for s in got["steps"])
            continue
        assert set(levels[0]) == {"data", "model"}, (arch, name)
        assert all(lv == levels[0] for lv in levels), (arch, name)
        if VARIANTS[name]["backend"] == "cxl":
            assert all(c["retrieved"] > 0 for c in levels[0].values())


def test_auto_resolves_each_level_like_reference(runs):
    """Under ``auto`` every decision the reference takes, at both levels
    and all_to_all included, is one the port takes, and every
    all_to_all call of the port resolved at the model level."""
    mine, reference = runs
    for arch in ARCHS:
        got = {(c["primitive"], c["level"], c["fabric"], c["backend"])
               for s in mine[arch, "auto"]["steps"]
               for c in s["choices_rank0"]}
        want = {tuple(c) for c in json.loads(
            str(reference[f"{arch}|auto|choices"]))}
        assert want and want <= got
        a2a = {c for c in got if c[0] == "all_to_all"}
        assert a2a and {c[1] for c in a2a} == {"model"}



def _moe_bytes(arch: str) -> dict:
    """Per-step wire bytes of one rank (``core.ledger``'s convention:
    all-reduce 2 s (n - 1) / n, all-gather s (n - 1), all-to-all s (n -
    1) / n) of the calls whose trip counts differ between the packages:
    on the model axis, an activation AllReduce of (B, L, D) f32 (the
    embedding's, and each row's dense residual FFN's in Arctic), the
    cross-entropy's two of (B, L) f32 and the max's all-gather of (1, B,
    L); each row's MoE combine (an all-gather of its token slice) and
    its AllToAll of the (E, C, D) dispatch buffer; on the data axis the
    embedding's FSDP gather and the loss mean's AllReduce of one f32."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models import model, sharding
    cfg = get_config(arch, smoke=True)
    m = cfg.moe
    rows = BATCH // DP
    act, tok = rows * SEQ * cfg.d_model * 4, rows * SEQ * 4
    ar = 2 * (TP - 1) / TP
    t = rows * SEQ // TP                     # a model rank's tokens
    e_pad = m.padded_experts(TP)
    cap = max(1, int(t * m.top_k * m.capacity_factor) // e_pad)
    dense_rows = cfg.n_layers if m.dense_residual_d_ff else 0
    sharding.set_mesh_sizes({"data": DP, "model": TP})
    specs = sharding.param_specs(model.abstract_params(cfg, tp=TP), cfg,
                                 dp_axis="data")
    embed = sum(x.numel() // (TP if "model" in s else 1) // DP * 4
                * (DP - 1) for (_, x), (_, s) in zip(
                    tree.leaves_with_paths(model.abstract_params(
                        cfg, tp=TP)["embed"]),
                    tree.leaves_with_paths(specs["embed"])))
    return {"ar_gap": act * ar * (1 + dense_rows) + 2 * tok * ar,
            "max": tok * (TP - 1),
            "combine": cfg.n_layers * t * cfg.d_model * 4 * (TP - 1),
            # the replay of an Arctic row runs on to its dense FFN, past
            # the combine's all-gather
            "combine_trips": 2 if dense_rows else 1,
            "a2a": e_pad * cap * cfg.d_model * 4 * (TP - 1) / TP,
            "rows": cfg.n_layers, "embed_gather": embed,
            "loss": 4 * 2 * (DP - 1) / DP}


@pytest.mark.parametrize("arch,variant", CASES)
def test_level_bytes_follow_the_reference_trip_counts(runs, arch, variant):
    """With ``data:cxl,model:cxl`` active every byte lands on its level.
    The reference books at trace time: everything inside
    ``value_and_grad`` 3 times (forward, remat replay, AD transpose,
    each as the forward's kind), the grad sync once.  The port books
    each call as it runs:

    * the AllToAlls 6 times a row (forward, replay, and the transpose of
      each, an all_to_all too): equal to the reference's;
    * the MoE combine's all-gather once (the replay stops before it: its
      output feeds only the residual add; in Arctic twice, the replay
      runs on to the dense FFN after it) and its transpose as a
      reduce-scatter, the max's gather once (detached);
    * the embedding's, the cross-entropy's and Arctic's dense FFN's
      AllReduces twice (one fewer than the reference, see
      ``tests/test_torch_train_tp.py``), each row's attention AllReduce
      3 times;
    * the grad sync's model-level reduce-scatter and all-gather once, as
      the reference; the FSDP gathers G once (twice a row's under
      ``prefetch=0``: the replay gathers again) and their transposes as
      reduce-scatters."""
    mine, reference = runs
    c = _moe_bytes(arch)
    step = mine[arch, variant]["steps"][0]
    got = step["level_wire_bytes_rank0"]
    want = json.loads(str(reference[f"{arch}|{variant}|levels"]))
    assert set(got) == set(want) == {"data/cxl", "model/cxl"}
    m, rm = got["model/cxl"], want["model/cxl"]
    assert m["all_to_all"] == rm["all_to_all"] == 6 * c["rows"] * c["a2a"]
    assert rm["all_reduce"] == m["all_reduce"] + c["ar_gap"]
    sync = rm["reduce_scatter"]
    assert m["reduce_scatter"] == sync + c["combine"]
    assert m["all_gather"] == c["max"] + c["combine_trips"] * c["combine"] \
        + sync
    assert rm["all_gather"] == 3 * (c["max"] + c["combine"]) + sync
    d, rd = got["data/cxl"], want["data/cxl"]
    g = d["reduce_scatter"]
    assert g > 0 and "reduce_scatter" not in rd and rd["all_gather"] == 3 * g
    replayed = g - c["embed_gather"] \
        if VARIANTS[variant].get("prefetch", 1) == 0 else 0
    assert d["all_gather"] == g + replayed
    assert rd["all_reduce"] == d["all_reduce"] + c["loss"]


def test_tuned_plan_has_all_to_all_cells_at_the_model_level(tmp_path):
    """``launch.tune`` for ``data:cxl,model:cxl`` (the card cell's
    sizes) gives ``auto`` a plan cell of its own level for every
    all_to_all the MoE issues over ``model``: the smoke model's dispatch
    buffer and Granite's (40 experts x capacity 256 x 1536 f32 at a
    model rank's 1024 tokens)."""
    from repro_torch import tuner
    from repro_torch.configs import get_config
    from repro_torch.core.topology import parse_topology
    from repro_torch.launch import tune
    path = str(tmp_path / "plan.json")
    topo = "data:cxl,model:cxl"
    tune.main(["--topology", topo, "--nranks", "2", "--sizes-mib", "1",
               "4", "16", "64", "256", "--quiet", "--out", path])
    plan = tuner.load_plan(path)
    level = parse_topology(topo).level_key("model")
    cfg = get_config("granite-moe-3b")
    m = cfg.moe
    t = 4 // 2 * 1024 // 2
    cap = int(t * m.top_k * m.capacity_factor) // m.padded_experts(2)
    sizes = (4 * 20 * 256 * 4, m.padded_experts(2) * cap * cfg.d_model * 4)
    assert cap == 256 and sizes[1] == 62_914_560
    for size in sizes:
        cell = plan.lookup("all_to_all", size, 2, level=level)
        assert cell is not None and cell.backend in ("cxl", "ring")

if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--reference":
        reference_main(*sys.argv[2:5])
    else:
        print(json.dumps({"usage": "--reference OUT.npz TMPDIR ARCH"}))
        sys.exit(2)
