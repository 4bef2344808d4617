"""The port's tensor-parallel modules against the JAX reference.

Module parity: ``embed_tokens``, ``sharded_xent`` (whole and padded
vocabulary), ``attention_forward`` and ``ffn_forward`` of
``llama3.2-smoke`` on a model axis of 2 ranks (sharded kv) and of 4
(replicated kv: tp does not divide its 2 kv heads), each rank holding its
Megatron shards.  The port runs on gloo CPU ranks under ``ring`` and
``cxl``; the reference runs the same numpy inputs (made from a seed)
inside ``shard_map`` over forced host devices in a subprocess.  Every
rank's forward value (rtol 1e-5, atol 1e-6) and its gradients of ``sum(y
* ct)`` with respect to its param shards and its input (rtol 1e-4, atol
1e-5) equal the reference's.

Also: ``param_specs`` of both packages leaf by leaf at (data 2, model 2)
and (data 2, model 4); the AllReduce over the tuple ("data", "model") of
two independent mesh axes (a fused ring sum without a topology, the
per-level decomposition under cxl and auto, with each level's ledger
bytes under a topology) against the reference's; the four dense configs
the port copies, field by field and with ``param_count`` at tp 1, 2 and
4; the tuner's plan for a topology with a model level; and the tp > 1
decode paths on a one-rank stand-in (its cache, ``tp_psum_max``).

Also runnable as a script: ``python tests/test_torch_tp.py --reference
OUT.npz TMPDIR`` writes the reference's results.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ARCH = "llama3.2-1b"
B, L = 2, 16
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
TPS = (2, 4)
BACKENDS = ("ring", "cxl")
FNS = ("embed", "xent", "xent_padded", "attention", "ffn")
PADDED_VOCAB = 510           # < the smoke model's 512: padded ids masked
# the tuple AllReduce over ("data", "model") = (2, 2): backend, topology
TUPLE_CASES = (("ring", None), ("cxl", None), ("cxl", "topo"),
               ("auto", "topo"))
TUPLE_ROWS = 8
# the data tuple ("pod", "data") beside a model axis: (pod, data, model)
# = (2, 2, 2), ring, no topology - the fused ring on the joint group
POD_SHAPE = (("pod", 2), ("data", 2), ("model", 2))


def _inputs(tp: int) -> dict:
    """Global numpy inputs of every module case at ``tp`` (seeded)."""
    rng = np.random.default_rng(100 + tp)
    d, v = 256, 512
    f32 = np.float32
    hd = 32
    return {
        "x": rng.standard_normal((B, L, d)).astype(f32),
        # scaled so the gradients are of order one: f32 rounding of
        # their sums over B x L tokens then sits well under GRAD_ATOL
        "ct": (rng.standard_normal((B, L, d)) / 8).astype(f32),
        "tokens": rng.integers(0, v, (B, L)).astype(np.int32),
        "labels": rng.integers(0, PADDED_VOCAB, (B, L)).astype(np.int32),
        "logits": (3 * rng.standard_normal((B, L, v))).astype(f32),
        "tok": (0.02 * rng.standard_normal((v, d))).astype(f32),
        "wq": (rng.standard_normal((d, 8 * hd)) / 16).astype(f32),
        "wk": (rng.standard_normal((d, 2 * hd)) / 16).astype(f32),
        "wv": (rng.standard_normal((d, 2 * hd)) / 16).astype(f32),
        "wo": (rng.standard_normal((8 * hd, d)) / 16).astype(f32),
        "wg": (rng.standard_normal((d, 512)) / 16).astype(f32),
        "wu": (rng.standard_normal((d, 512)) / 16).astype(f32),
        "wd": (rng.standard_normal((512, d)) / 22.6).astype(f32),
    }


def _param_tree(fn: str, a: dict) -> dict:
    """The module's params as the model tree names them (so both
    packages' ``param_specs`` shard them), from the inputs ``a``."""
    if fn == "embed":
        return {"embed": {"tok": a["tok"]}}
    if fn == "attention":
        return {"attn": {k: a[k] for k in ("wq", "wk", "wv", "wo")}}
    if fn == "ffn":
        return {"ffn": {k: a[k] for k in ("wg", "wu", "wd")}}
    return {}


def _tuple_input(n: int = 4) -> np.ndarray:
    """Every rank's (TUPLE_ROWS, 5) integer-valued f32 rows, stacked."""
    rng = np.random.default_rng(7 + n)
    return rng.integers(-8, 8, (n * TUPLE_ROWS, 5)).astype(np.float32)


def reference_topology_json() -> dict:
    from repro.core.topology import Level, Topology
    return Topology(levels=(Level("data", "cxl"),
                            Level("model", "cxl"))).to_json()


# ---------------------------------------------------------------------- #
# the reference side (a subprocess with 8 forced host devices)
# ---------------------------------------------------------------------- #

def reference_main(out_path: str, tmp: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config
    from repro.core import ledger
    from repro.core.api import Communicator
    from repro.core.topology import Topology
    from repro.models import layers, sharding
    from repro.models.pcontext import ParallelContext
    from repro.tuner import load_plan

    cfg = get_config(ARCH, smoke=True)
    out = {}
    for tp in TPS:
        a = {k: jnp.asarray(v) for k, v in _inputs(tp).items()}
        mesh = jax.make_mesh((tp,), ("model",), devices=jax.devices()[:tp])
        pc = ParallelContext(tp_axis="model", tp=tp,
                             comm=Communicator(backend="ring"))
        sharding.set_mesh_sizes({"model": tp})
        positions = jnp.arange(L)

        def apply(fn, p, x):
            if fn == "embed":
                return layers.embed_tokens(p["embed"], x, cfg, pc)
            if fn == "attention":
                return layers.attention_forward(p["attn"], x, cfg, pc,
                                                positions)
            if fn == "ffn":
                return layers.ffn_forward(p["ffn"], x, pc)
            return layers.sharded_xent(
                x, a["labels"], pc,
                vocab_size=PADDED_VOCAB if fn == "xent_padded" else None)

        for fn in FNS:
            params = _param_tree(fn, a)
            pspecs = sharding.param_specs(params, cfg, fsdp=False)
            if fn.startswith("xent"):
                x, xspec = a["logits"], P(None, None, "model")
            elif fn == "embed":
                x, xspec = a["tokens"], P()
            else:
                x, xspec = a["x"], P()

            def body(p, xx, fn=fn):
                y = apply(fn, p, xx)
                if fn.startswith("xent"):
                    g = jax.grad(lambda pp, z: apply(fn, pp, z),
                                 argnums=1)(p, xx)
                    gp = {}
                elif fn == "embed":
                    gp = jax.grad(lambda pp: jnp.sum(
                        apply(fn, pp, xx) * a["ct"]))(p)
                    g = jnp.zeros(())
                else:
                    gp, g = jax.grad(lambda pp, z: jnp.sum(
                        apply(fn, pp, z) * a["ct"]), argnums=(0, 1))(p, xx)
                lead = jax.tree.map(lambda t: t[None], (y, gp, g))
                return lead

            f = jax.jit(jax.shard_map(
                body, mesh=mesh, in_specs=(pspecs, xspec),
                out_specs=P("model"), check_vma=False))
            y, gp, g = jax.tree.map(np.asarray, f(params, x))
            for r in range(tp):
                key = f"tp{tp}|{fn}|{r}"
                out[f"{key}|y"] = np.asarray(y[r])
                out[f"{key}|gx"] = np.asarray(g[r])
                for path, leaf in jax.tree_util.tree_leaves_with_path(gp):
                    out[f"{key}|g|" + "/".join(k.key for k in path)] = \
                        np.asarray(leaf[r])

    # the AllReduce over the tuple of two independent mesh axes
    topo = Topology.from_json(reference_topology_json())
    plan = load_plan(os.path.join(tmp, "plan.json"))
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         devices=jax.devices()[:4])
    axes = ("data", "model")
    for backend, topo_name in TUPLE_CASES:
        comm = Communicator(backend=backend, plan=plan,
                            topology=topo if topo_name else None)
        f = jax.jit(jax.shard_map(
            lambda z, comm=comm: comm.all_reduce(z, axes), mesh=mesh,
            in_specs=P(axes), out_specs=P(axes), check_vma=False))
        ledger.reset()
        y = np.asarray(f(jnp.asarray(_tuple_input())))
        snap = ledger.snapshot()
        key = f"tuple|{backend}|{topo_name}"
        out[f"{key}|y"] = y
        out[f"{key}|ledger"] = np.asarray(json.dumps({
            "wire_bytes": snap["wire_bytes"],
            "level_wire_bytes": snap["level_wire_bytes"],
            "levels": sorted({(c["level"], c["backend"])
                              for c in snap["auto_choices"]})}))
    names = tuple(a for a, _ in POD_SHAPE)
    mesh = jax.make_mesh(tuple(n for _, n in POD_SHAPE), names,
                         devices=jax.devices()[:8])
    comm = Communicator(backend="ring")
    f = jax.jit(jax.shard_map(
        lambda z: comm.all_reduce(z, ("pod", "data")), mesh=mesh,
        in_specs=P(names), out_specs=P(names), check_vma=False))
    ledger.reset()
    out["pod|y"] = np.asarray(f(jnp.asarray(_tuple_input(8))))
    out["pod|wire"] = np.asarray(json.dumps(ledger.snapshot()["wire_bytes"]))
    np.savez(out_path, **out)


# ---------------------------------------------------------------------- #
# the port's side (gloo CPU ranks)
# ---------------------------------------------------------------------- #

def port_rank(ctx, tp: int, tuple_cases: list) -> dict:
    """Every module case on this rank of a model axis of ``tp`` ranks,
    under each backend; then ``tuple_cases`` through the collectives
    launcher's rank function."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.api import Communicator
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers, sharding
    from repro_torch.models.pcontext import ParallelContext

    cfg = get_config(ARCH, smoke=True)
    a = _inputs(tp)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    positions = torch.arange(L)
    out = {}
    if ctx.nranks == tp:
        mesh = make_host_mesh((("model", tp),), ctx)
        sharding.set_mesh_sizes({"model": tp})
        for backend in BACKENDS:
            pc = ParallelContext(tp_axis="model", tp=tp, comm=Communicator(
                backend=backend, axes=mesh))
            rank = pc.tp_index()
            for fn in FNS:
                full = _param_tree(fn, {k: torch.from_numpy(v)
                                        for k, v in a.items()})
                specs = sharding.param_specs(full, cfg, fsdp=False)
                p = sharding.shard_params(full, specs, None, 0, 1,
                                          tp_axis="model", tp_rank=rank,
                                          tp=tp)
                leaves = [x for _, x in _leaves(p)]
                for x in leaves:
                    x.requires_grad_(True)
                if fn.startswith("xent"):
                    x = t["logits"].chunk(tp, dim=-1)[rank].clone()
                    x.requires_grad_(True)
                    y = layers.sharded_xent(
                        x, t["labels"], pc, vocab_size=PADDED_VOCAB
                        if fn == "xent_padded" else None)
                    y.backward()
                elif fn == "embed":
                    x = t["tokens"]
                    y = layers.embed_tokens(p["embed"], x, cfg, pc)
                    (y * t["ct"]).sum().backward()
                else:
                    x = t["x"].clone().requires_grad_(True)
                    y = layers.attention_forward(p["attn"], x, cfg, pc,
                                                 positions) \
                        if fn == "attention" else \
                        layers.ffn_forward(p["ffn"], x, pc)
                    (y * t["ct"]).sum().backward()
                key = f"{backend}|{fn}"
                out[f"{key}|y"] = y.detach().numpy()
                out[f"{key}|gx"] = x.grad.numpy() if x.grad is not None \
                    else np.zeros((), np.float32)
                for path, leaf in _leaves(p):
                    out[f"{key}|g|" + "/".join(path)] = leaf.grad.numpy()
    if tuple_cases:
        out["tuple"] = collectives.rank_cases(ctx, tuple_cases)
    return out


def _leaves(tree) -> list:
    from repro_torch.core import tree as tree_mod
    return tree_mod.leaves_with_paths(tree)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro import tuner as rtuner
    from repro.core.topology import Topology as RTopology
    from repro_torch.core.topology import Topology
    from repro_torch.launch import ranks
    from repro_torch.launch.mesh import level_groups
    from repro_torch.tuner import load_plan

    tmp = str(tmp_path_factory.mktemp("torch_tp"))
    ref_path = os.path.join(tmp, "reference.npz")
    plan_path = os.path.join(tmp, "plan.json")
    rtuner.save_plan(rtuner.generate_plan(rtuner.TuneGrid(
        sizes=(256, 4096, 65536), nranks=(2, 4), slicing_factors=(1, 4)),
        topology=RTopology.from_json(reference_topology_json())), plan_path)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    ref = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                            "--reference", ref_path, tmp], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        topo = Topology.from_json(reference_topology_json())
        plan = load_plan(plan_path)
        shape = (("data", 2), ("model", 2))
        xs = np.split(_tuple_input(), 4)
        tuple_cases = [dict(name="all_reduce_two_phase", backend=backend,
                            x=xs, shape=shape, axis=("data", "model"),
                            topology=topo if topo_name else None,
                            plan=plan if backend == "auto" else None,
                            ledger=True)
                       for backend, topo_name in TUPLE_CASES]
        mine = {}
        for tp in TPS:
            mine[tp] = ranks.spawn(
                port_rank, tp, (tp, tuple_cases if tp == 4 else []),
                device="cpu", partition_bytes=1 << 20,
                groups=level_groups(shape) if tp == 4 else (),
                timeout_s=120.0)
        pod_case = [dict(name="all_reduce_two_phase", backend="ring",
                         x=np.split(_tuple_input(8), 8), shape=POD_SHAPE,
                         axis=("pod", "data"), ledger=True)]
        mine["pod"] = ranks.spawn(
            port_rank, 8, (0, pod_case), device="cpu",
            groups=level_groups(POD_SHAPE), timeout_s=120.0)
        log, _ = ref.communicate(timeout=400)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log[-3000:]
    with np.load(ref_path) as f:
        reference = {k: f[k] for k in f.files}
    return mine, reference


MODULE_CASES = [(tp, backend, fn) for tp in TPS for backend in BACKENDS
                for fn in FNS]


@pytest.mark.parametrize("tp,backend,fn", MODULE_CASES)
def test_module_forward_matches_reference(results, tp, backend, fn):
    mine, reference = results
    for r in range(tp):
        np.testing.assert_allclose(
            mine[tp][r][f"{backend}|{fn}|y"],
            reference[f"tp{tp}|{fn}|{r}|y"], rtol=FWD_RTOL, atol=FWD_ATOL,
            err_msg=f"rank {r}")


@pytest.mark.parametrize("tp,backend,fn", MODULE_CASES)
def test_module_grads_match_reference(results, tp, backend, fn):
    mine, reference = results
    for r in range(tp):
        got = {k.split("|", 3)[3]: v for k, v in mine[tp][r].items()
               if k.startswith(f"{backend}|{fn}|g|")}
        pre = f"tp{tp}|{fn}|{r}|g|"
        want = {k[len(pre):]: v for k, v in reference.items()
                if k.startswith(pre)}
        assert sorted(got) == sorted(want)
        got["x"] = mine[tp][r][f"{backend}|{fn}|gx"]
        want["x"] = reference[f"tp{tp}|{fn}|{r}|gx"]
        for k in want:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("backend,topo", TUPLE_CASES)
def test_tuple_all_reduce_over_data_and_model(results, backend, topo):
    """The sum over ("data", "model") = (2, 2) equals the reference's
    bitwise (integer-valued f32), with the same wire bytes; under a
    topology each level books its own, and auto resolves at both."""
    mine, reference = results
    key = f"tuple|{backend}|{topo}"
    i = TUPLE_CASES.index((backend, topo))
    want_y = np.split(reference[f"{key}|y"], 4)
    want = json.loads(str(reference[f"{key}|ledger"]))
    for r in range(4):
        y, snap = mine[4][r]["tuple"][i]
        np.testing.assert_array_equal(y, want_y[r])
        assert snap["wire_bytes"] == want["wire_bytes"]
        assert snap["level_wire_bytes"] == want["level_wire_bytes"]
    snap = mine[4][0]["tuple"][i][1]
    if topo:
        assert set(snap["level_wire_bytes"]) == {"data/cxl", "model/cxl"}
    else:
        assert snap["level_wire_bytes"] == {}
    if backend == "ring":
        # one fused ring sum over all 4 ranks, booked once per axis
        assert set(snap["wire_bytes"]) == {"all_reduce"}
    else:
        assert set(snap["wire_bytes"]) == {"all_reduce", "reduce_scatter",
                                           "all_gather"}
    if backend == "auto":
        got = sorted({(c["level"], c["backend"])
                      for c in snap["auto_choices"]})
        assert [list(c) for c in got] == want["levels"]
        assert {c[0] for c in got} == {"data", "model"}


def test_data_tuple_beside_a_model_axis_rides_the_joint_group(results):
    """(pod, data, model) = (2, 2, 2) under ring with no topology: the
    AllReduce over ("pod", "data") is one ring over the joint group of
    the 4 ranks of each model index (``launch.mesh.joint_groups``),
    bitwise the reference's fused psum, with its wire bytes."""
    mine, reference = results
    want_y = np.split(reference["pod|y"], 8)
    want = json.loads(str(reference["pod|wire"]))
    for r in range(8):
        y, snap = mine["pod"][r]["tuple"][0]
        np.testing.assert_array_equal(y, want_y[r])
        assert snap["wire_bytes"] == want
    xs = np.split(_tuple_input(8), 8)
    np.testing.assert_array_equal(want_y[5], xs[1] + xs[3] + xs[5] + xs[7])


# ---------------------------------------------------------------------- #
# specs, configs, the tuner and the raises (no ranks)
# ---------------------------------------------------------------------- #

SPEC_ARCHS = ("llama3.2-1b", "llama3-8b", "yi-6b", "phi3-medium-14b",
              "deepseek-coder-33b")


@pytest.mark.parametrize("mesh", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
@pytest.mark.parametrize("arch", SPEC_ARCHS)
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_param_specs_match_reference(arch, mesh, smoke):
    """Leaf by leaf, on the GLOBAL shapes of each package's params at
    that tp (meta tensors / ShapeDtypeStructs: nothing is allocated)."""
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


NEW_CONFIGS = ("llama3-8b", "yi-6b", "phi3-medium-14b", "deepseek-coder-33b")


@pytest.mark.parametrize("arch", NEW_CONFIGS)
def test_dense_configs_equal_reference(arch):
    import dataclasses

    from repro.configs import get_config as jax_config
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch import train
    assert arch in ARCH_IDS
    assert arch in train.build_parser()._option_string_actions[
        "--arch"].choices
    for smoke in (False, True):
        want, got = jax_config(arch, smoke=smoke), get_config(arch,
                                                              smoke=smoke)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for tp in (1, 2, 4):
            assert got.param_count(tp) == want.param_count(tp)
            assert got.padded_heads(tp) == want.padded_heads(tp)
            assert got.padded_vocab(tp) == want.padded_vocab(tp)
            assert got.kv_sharded(tp) == want.kv_sharded(tp)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_init_params_global_shapes_match_reference(tp):
    """``init_params(tp)`` lays params out in the reference's GLOBAL
    padded shapes, and params made by the reference at that tp load
    through ``params_from_numpy`` (checked against ``cfg`` and ``tp``);
    params padded for another tp raise."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.models import model as jax_model
    from repro.models.config import ModelConfig as JaxModelConfig
    from repro_torch.core import tree
    from repro_torch.models import model
    from repro_torch.models.config import ModelConfig, dense_pattern

    # 6 q heads and a vocabulary of 510: both pad at tp = 4
    fields = dict(name="pad", family="dense", n_layers=1, d_model=48,
                  n_heads=6, n_kv_heads=2, d_ff=64, vocab_size=510,
                  layer_pattern=dense_pattern(1))
    jcfg, cfg = JaxModelConfig(**fields), ModelConfig(**fields)
    jparams = jax_model.init_params(jax.random.key(3), jcfg, tp=tp,
                                    dtype=jnp.float32)
    npp = jax.tree.map(np.asarray, jparams)
    params = model.params_from_numpy(npp, "cpu", cfg, tp)
    mine = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                             tp=tp)
    for p, x in tree.leaves_with_paths(mine):
        assert tuple(x.shape) == tuple(tree.get(params, p).shape), p
    attn = params["g0"]["attn"]
    hq = cfg.padded_heads(tp)
    assert attn["wq"].shape[-1] == hq * cfg.head_dim
    if hq != cfg.n_heads:     # padded heads are zero in both packages
        real = cfg.n_heads * cfg.head_dim
        assert not mine["g0"]["attn"]["wq"][..., real:].any()
        assert not mine["g0"]["attn"]["wo"][:, real:].any()
    other = 4 if tp != 4 else 1
    if cfg.padded_vocab(other) != cfg.padded_vocab(tp):
        with pytest.raises(ValueError, match="shapes"):
            model.params_from_numpy(npp, "cpu", cfg, other)


def test_tune_plans_a_model_level(tmp_path):
    """``launch.tune --topology data:cxl,model:cxl --nranks 2`` writes
    cells for both levels."""
    from repro_torch.launch import tune
    from repro_torch.tuner import load_plan
    path = str(tmp_path / "plan.json")
    tune.main(["--topology", "data:cxl,model:cxl", "--nranks", "2",
               "--smoke", "--quiet", "--out", path])
    plan = load_plan(path)
    topo = plan.topology()
    assert [lv.axis for lv in topo.levels] == ["data", "model"]
    for ax in ("data", "model"):
        cell = plan.lookup("all_reduce", 1 << 20, 2,
                           level=topo.level_key(ax))
        assert cell is not None, ax


def test_tp_mesh_is_rank_major_with_level_and_joint_groups():
    """``--mesh DPxTP``: rank r at data r // TP, model r % TP; every
    model group and data group a level group; with ``--multi-pod`` and
    TP > 1 the data levels also form a joint group per model index (the
    fused ring's process group over ("pod", "data")), without a pool."""
    import types

    from repro_torch.launch import mesh
    assert mesh.parse_mesh("2x4") == (2, 4)
    shape = mesh.mesh_shape(2, 2)
    assert shape == (("data", 2), ("model", 2))
    assert mesh.level_groups(shape) == [(0, 2), (1, 3), (0, 1), (2, 3)]
    assert mesh.joint_groups(shape) == []
    shape = mesh.mesh_shape(4, 2, multi_pod=True)
    assert shape == (("pod", 2), ("data", 2), ("model", 2))
    joint = [(0, 2, 4, 6), (1, 3, 5, 7)]
    assert mesh.joint_groups(shape) == joint
    assert mesh.level_groups(shape)[-2:] == joint
    assert mesh.joint_groups(mesh.mesh_shape(4, 1, multi_pod=True)) == []
    groups = {g: (None, "pool") for g in mesh.level_groups(shape)}
    ctx = types.SimpleNamespace(rank=5, nranks=8, pool=None, groups=groups)
    m = mesh.make_host_mesh(shape, ctx)
    assert [(m[a].rank, m[a].size) for a in ("pod", "data", "model")] == \
        [(1, 2), (0, 2), (1, 2)]
    j = m[("pod", "data")]
    assert (j.name, j.rank, j.size, j.pool) == ("pod+data", 2, 4, None)


@pytest.mark.parametrize("nout,tile,blocks", [
    (1024, 0, 128),    # wq: 16 x 8 tiles of 128 x 128
    (256, 1, 256),     # wk, wv: 128 x 128 would give 32 blocks
    (4096, 0, 512)])   # wg, wu
def test_agm_geometry_at_the_tp_shapes(nout, tile, blocks):
    """``all_gather_matmul`` on the (data, model) = (2, 2) path of
    Llama-3.2-1B: x (2048, 2 x 1024) @ (2, 1024, N); every stack gives at
    least 90% of the H100's SMs a block, with 16-byte copies."""
    from repro_torch.kernels import fused_collectives as fc
    geo = fc.agm_geometry(2048, 2, 1024, nout)
    assert geo["tile"] == tile and geo["vec"]
    assert geo["grid"][0] * geo["grid"][1] == blocks
    assert blocks >= fc.AGM_FILL * fc.H100_SMS


def test_tp_paths_not_ported_raise():
    """Decode, its cache and prefill at tp > 1 (the reference's
    sequence-sharded KV cache) and ``tp_psum_max`` no longer raise: on a
    one-rank stand-in of a model axis of 2 (its AllReduce and max the
    identity, its AllGather two copies) the cache has the sharded
    layout, ``tp_psum_max`` is the Communicator's ``all_max`` over the
    model axis, and a dense and a Mamba-1 row prefill and decode to
    finite values of the right shapes, through their model-axis
    collectives (tests/test_torch_decode_tp.py holds the values on 2
    and 4 ranks against the reference).  At tp = 1 the same context is
    the identity."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import blocks, model, sharding
    from repro_torch.models.pcontext import ParallelContext
    calls = []

    class _OneRank:                   # a model axis of 2, seen by rank 0
        def all_reduce(self, x, axis):
            calls.append(("all_reduce", axis))
            return x

        def all_gather(self, x, axis):
            calls.append(("all_gather", axis))
            return torch.cat([x, x])

        def all_max(self, x, axis):
            calls.append(("all_max", axis))
            return x

        def axis_index(self, axis):
            return 0
    pc = ParallelContext(tp_axis="model", tp=2, comm=_OneRank())
    sharding.set_mesh_sizes({"model": 2})     # kv sharded at tp 2
    x = torch.arange(3.0)
    assert pc.tp_psum_max(x) is x and calls == [("all_max", "model")]
    cfg = get_config(ARCH, smoke=True)
    cache = model.init_cache(cfg, pc, 1, 8, device="cpu")
    assert tuple(cache[0]["k"].shape) == (cfg.n_layers, 1, 4,
                                          cfg.n_kv_heads, cfg.head_dim)
    with pytest.raises(ValueError, match="must divide over tp"):
        model.init_cache(cfg, pc, 1, 7, device="cpu")
    for arch, kind in ((ARCH, "a"), ("falcon-mamba-7b", "1")):
        rcfg = get_config(arch, smoke=True)
        row = model._layer(blocks.init_row(
            torch.Generator().manual_seed(0), kind, rcfg, 2, torch.float32,
            "cpu"), 0)
        row = sharding.shard_params(
            row, sharding.param_specs(row, rcfg, fsdp=False), None, 0, 1,
            tp_axis="model", tp_rank=0, tp=2)
        h = torch.randn(1, 3, rcfg.d_model,
                        generator=torch.Generator().manual_seed(1))
        del calls[:]
        out, aux = blocks.row_forward(row, h, kind, rcfg, pc,
                                      torch.arange(3))
        assert out.shape == h.shape and bool(torch.isfinite(out).all())
        assert float(aux) == 0.0
        if kind == "1":
            # x_proj's and out_proj's row-parallel sums, over the model axis
            assert calls == [("all_reduce", "model")] * 2
        c = model._layer(blocks.row_cache_init(kind, rcfg, pc, 1, 8,
                                               torch.float32, "cpu"), 0)
        out = blocks.row_prefill(row, h, kind, rcfg, pc, torch.arange(3),
                                 c)
        assert out.shape == h.shape and bool(torch.isfinite(out).all())
        del calls[:]
        out, _ = blocks.row_decode(row, h[:, :1], kind, c, torch.tensor(3),
                                   rcfg, pc)
        assert out.shape == (1, 1, rcfg.d_model)
        assert bool(torch.isfinite(out).all())
        assert {a for _, a in calls} == {"model"}
        if kind == "a":
            assert ("all_max", "model") in calls
    sharding.set_mesh_sizes({})
    # at tp = 1 the same context is the identity
    one = ParallelContext(tp_axis="model", tp=1)
    x = torch.ones(3)
    assert one.tp_psum_max(x) is x and one.tp_max(x) is x
    assert one.tp_all_reduce(x) is x and one.tp_index() == 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--reference":
        reference_main(*sys.argv[2:4])
    else:
        print(json.dumps({"usage": "--reference OUT.npz TMPDIR"}))
        sys.exit(2)
