"""The pipeline's pieces against the reference, outside a training run:

* ``Communicator.send`` / ``recv`` on 2 and 4 gloo CPU ranks (ring and
  cxl; shift 1, and 2 on 4 ranks) against the reference's under
  ``shard_map`` over forced host devices (in a subprocess): the payloads
  bitwise, the gradient of ``sum(w * send(x))`` equal to ``recv(w)`` (the
  reference's ``jax.grad`` through ``ppermute``), the backward hop booked
  in the ledger like the forward;
* ``models.pipeline_stages``: ``partition_stages`` over the zoo,
  ``uniform_stage_rows``' errors (zamba2-smoke, whisper-smoke,
  phi3-vision-smoke, rows that do not divide), ``stage_param_specs`` and
  ``stage_forward`` (output and grads, remat on and off) against the
  reference's;
* the p2p plumbing ``tests/test_pipeline_p2p.py`` holds in the
  reference and the port had no test of: the placement mix's pipeline
  terms, a placement priced over it, the sweep's per-level p2p cells,
  the dry-run mix's p2p attribution, ``tune --topology
  stage:cxl,data:cxl``'s stage-level p2p cells;
* the launcher: ``--pp-stages``' refusals, ``pipeline_shape`` and its
  rank groups (a (data, model) spawn of the same sizes carries it),
  ``train --pp-stages 2 --ckpt`` restored bitwise into the GLOBAL
  shapes and ``serve --ckpt`` of it.

Also runnable as a script: ``python tests/test_torch_pipeline.py
--reference OUT.npz`` writes the reference's send / recv results.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MiB = 1 << 20
# (ranks, shift) of the send / recv cases, each under both backends
P2P = ((2, 1), (4, 1), (4, 2))
BACKENDS = ("ring", "cxl")
SHAPE = (3, 5)


def _p2p_inputs(n: int, shift: int) -> tuple:
    rng = np.random.default_rng(10 * n + shift)
    x = rng.standard_normal((n,) + SHAPE).astype(np.float32)
    w = rng.standard_normal((n,) + SHAPE).astype(np.float32)
    return x, w


def reference_main(out_path: str) -> None:
    """The reference side of the send / recv cases, in a process with 4
    forced host devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core import ledger
    from repro.core.api import Communicator

    out = {}
    for n, shift in P2P:
        mesh = jax.make_mesh((n,), ("stage",), devices=jax.devices()[:n])
        x, w = _p2p_inputs(n, shift)
        for backend in BACKENDS:
            comm = Communicator(backend=backend, slicing_factor=2)
            fns = {"send": lambda xl, wl, c=comm, k=shift: c.send(
                       xl, "stage", shift=k),
                   "recv": lambda xl, wl, c=comm, k=shift: c.recv(
                       xl, "stage", shift=k),
                   "grad": lambda xl, wl, c=comm, k=shift: jax.grad(
                       lambda v: jnp.sum(wl * c.send(v, "stage", shift=k)))(
                           xl)}
            key = f"{n}|{shift}|{backend}"
            for kind, fn in fns.items():
                ledger.reset()
                f = jax.jit(jax.shard_map(
                    fn, mesh=mesh, in_specs=(P("stage"), P("stage")),
                    out_specs=P("stage"), check_vma=False))
                y = np.asarray(f(x.reshape(-1, SHAPE[1]),
                                 w.reshape(-1, SHAPE[1])))
                out[f"{key}|{kind}"] = y.reshape(x.shape)
                out[f"{key}|{kind}|wire"] = np.asarray(json.dumps(
                    ledger.snapshot()["wire_bytes"]))
    np.savez(out_path, **out)


def port_rank(ctx, n: int, shift: int) -> dict:
    """send, recv and send's gradient on this rank of a stage axis of
    ``n`` ranks, under each backend, with the ledger of each."""
    from repro_torch.core import ledger
    from repro_torch.core.api import Communicator
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh((("stage", n),), ctx)
    x, w = (torch.from_numpy(a[ctx.rank]) for a in _p2p_inputs(n, shift))
    out = {}
    for backend in BACKENDS:
        comm = Communicator(backend=backend, slicing_factor=2, axes=mesh)
        ledger.reset()
        y = comm.send(x, "stage", shift=shift)
        fwd = ledger.snapshot()["wire_bytes"]
        ledger.reset()
        r = comm.recv(x, "stage", shift=shift)
        rev = ledger.snapshot()["wire_bytes"]
        xg = x.clone().requires_grad_(True)
        ledger.reset()
        (w * comm.send(xg, "stage", shift=shift)).sum().backward()
        grad_wire = ledger.snapshot()["wire_bytes"]
        out[backend] = {"send": y.numpy(), "recv": r.numpy(),
                        "grad": xg.grad.numpy(),
                        "recv_w": comm.recv(w, "stage", shift=shift).numpy(),
                        "send_wire": fwd, "recv_wire": rev,
                        "grad_wire": grad_wire}
    return out


@pytest.fixture(scope="module")
def p2p(tmp_path_factory):
    from repro_torch.launch import ranks

    tmp = str(tmp_path_factory.mktemp("torch_pipeline"))
    ref_path = os.path.join(tmp, "reference.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    ref = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                            "--reference", ref_path], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        mine = {(n, shift): ranks.spawn(port_rank, n, (n, shift),
                                        device="cpu", partition_bytes=1 << 12,
                                        timeout_s=120.0)
                for n, shift in P2P}
        log, _ = ref.communicate(timeout=400)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log[-3000:]
    with np.load(ref_path) as f:
        reference = {k: f[k] for k in f.files}
    return mine, reference


CASES = [(n, shift, b) for n, shift in P2P for b in BACKENDS]


@pytest.mark.parametrize("n,shift,backend", CASES)
def test_send_and_recv_match_reference(p2p, n, shift, backend):
    """Rank r receives from rank r - shift under send and from r + shift
    under recv (cyclic), bitwise the reference's."""
    mine, reference = p2p
    x, _ = _p2p_inputs(n, shift)
    key = f"{n}|{shift}|{backend}"
    for kind, sign in (("send", 1), ("recv", -1)):
        got = np.stack([r[backend][kind] for r in mine[n, shift]])
        np.testing.assert_array_equal(got, reference[f"{key}|{kind}"])
        np.testing.assert_array_equal(got, np.roll(x, sign * shift, 0))


@pytest.mark.parametrize("n,shift,backend", CASES)
def test_send_gradient_is_recv_of_the_cotangent(p2p, n, shift, backend):
    """The gradient of ``sum(w * send(x))`` is ``recv(w)``, the
    reference's ``jax.grad`` through ``ppermute``, bitwise."""
    mine, reference = p2p
    got = np.stack([r[backend]["grad"] for r in mine[n, shift]])
    np.testing.assert_array_equal(
        got, np.stack([r[backend]["recv_w"] for r in mine[n, shift]]))
    np.testing.assert_array_equal(got, reference[f"{n}|{shift}|{backend}|grad"])


@pytest.mark.parametrize("n,shift,backend", CASES)
def test_the_ledger_books_the_backward_hop_like_the_forward(p2p, n, shift,
                                                           backend):
    """A send and a recv each book S bytes of ``p2p``, as the
    reference's; a differentiated send books S more for its backward hop,
    where the reference's trace books the forward once and its train
    step scales what it differentiates by 2 (``ledger.scale``)."""
    mine, reference = p2p
    s = float(np.prod(SHAPE) * 4)
    ref = {kind: json.loads(str(reference[f"{n}|{shift}|{backend}|{kind}|"
                                          "wire"]))
           for kind in ("send", "recv", "grad")}
    assert ref == {"send": {"p2p": s}, "recv": {"p2p": s},
                   "grad": {"p2p": s}}
    for r in mine[n, shift]:
        assert r[backend]["send_wire"] == r[backend]["recv_wire"] \
            == {"p2p": s}
        assert r[backend]["grad_wire"] == {"p2p": 2 * s}


def test_send_and_recv_on_one_rank_move_nothing():
    """On an axis of one rank both return their input, and neither takes
    a tuple axis."""
    from repro_torch.core.api import Communicator
    from repro_torch.core.mesh_collectives import AxisGroup
    comm = Communicator(axes={"stage": AxisGroup("stage", 0, 1)})
    x = torch.arange(6.0)
    assert comm.send(x, "stage") is x and comm.recv(x, "stage") is x
    with pytest.raises(NotImplementedError, match="single-axis"):
        comm.recv(x, ("stage", "data"))


# -- models.pipeline_stages ---------------------------------------------------

def test_partition_stages_matches_reference_over_the_zoo():
    from repro.configs import ALL_IDS, get_config as jget
    from repro.models import pipeline_stages as jps
    from repro_torch.configs import get_config
    from repro_torch.models import pipeline_stages as ps
    for arch in ALL_IDS:
        for smoke in (False, True):
            cfg, jcfg = get_config(arch, smoke), jget(arch, smoke)
            for s in range(1, min(8, len(cfg.layer_pattern)) + 1):
                got = ps.partition_stages(cfg, s)
                want = jps.partition_stages(jcfg, s)
                assert [dataclasses.astuple(x) for x in got] == \
                    [dataclasses.astuple(x) for x in want], (arch, s)
                assert sum(x.count for x in got) == len(cfg.layer_pattern)
    with pytest.raises(ValueError, match="n_stages must be >= 1"):
        ps.partition_stages(get_config("llama3.2-1b"), 0)
    with pytest.raises(ValueError, match="17 stages > 16 layer rows"):
        ps.partition_stages(get_config("llama3.2-1b"), 17)


@pytest.mark.parametrize("arch,stages", [
    ("zamba2-1.2b", 2), ("whisper-tiny", 2), ("phi-3-vision-4.2b", 2),
    ("llama3.2-1b", 4), ("llama3.2-1b", 0)])
def test_uniform_stage_rows_refuses_as_the_reference(arch, stages):
    """The same exception and message as the reference's on the smoke
    models: a hybrid stack (one scan group needed), an encoder or a
    vision prefix (decoder-only text), rows that do not divide."""
    from repro.configs import get_config as jget
    from repro.models import pipeline_stages as jps
    from repro_torch.configs import get_config
    from repro_torch.models import pipeline_stages as ps
    with pytest.raises(Exception) as want:
        jps.uniform_stage_rows(jget(arch, smoke=True), stages)
    with pytest.raises(type(want.value)) as got:
        ps.uniform_stage_rows(get_config(arch, smoke=True), stages)
    assert str(got.value) == str(want.value)


def test_uniform_stage_rows_of_the_uniform_stacks():
    from repro_torch.configs import get_config
    from repro_torch.models import pipeline_stages as ps
    assert ps.uniform_stage_rows(get_config("llama3.2-1b"), 2) == 8
    assert ps.uniform_stage_rows(get_config("granite-moe-3b"), 4) == 8
    assert ps.uniform_stage_rows(get_config("falcon-mamba-7b"), 2) == 32


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-3b-a800m",
                                  "llama3-8b"])
def test_stage_param_specs_match_reference(arch):
    """The stage axis in place of every ``g*`` leaf's layer dim, the rest
    replicated (the reference's short ``P()`` entries padded with None),
    and composed over a base spec tree."""
    from repro.configs import get_config as jget
    from repro.models import model as jmodel
    from repro.models import pipeline_stages as jps
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models import model, pipeline_stages as ps, sharding
    import jax
    cfg = get_config(arch)
    abstract = model.abstract_params(cfg)
    want = jps.stage_param_specs(jmodel.abstract_params(jget(arch), tp=1),
                                 "stage")
    got = ps.stage_param_specs(abstract, "stage")
    flat = dict(jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0])
    want = {"/".join(k.key for k in p): s for p, s in flat.items()}
    for path, spec in tree.leaves_with_paths(got):
        w = tuple(want["/".join(path)])
        assert spec == w + (None,) * (len(spec) - len(w)), path
        assert len(spec) == tree.get(abstract, path).dim()
    sharding.set_mesh_sizes({"data": 2, "model": 1})
    base = sharding.param_specs(abstract, cfg, dp_axis="data")
    composed = ps.stage_param_specs(abstract, "stage", base)
    for path, spec in tree.leaves_with_paths(composed):
        b = tree.get(base, path)
        assert spec == (("stage",) + b[1:] if path[0].startswith("g")
                        else b), path


@pytest.mark.parametrize("remat", [False, True])
def test_stage_forward_matches_reference(remat):
    """A rank's slab of two rows of llama3.2-smoke, output and aux, and
    the grads of ``sum(ct * out)`` to the slab and the input, against the
    reference's ``stage_forward`` (``lax.scan``, ``jax.checkpoint``), at
    rtol 1e-4 and atol 1e-5 of each array's largest entry (the grads of
    a sum over 6144 outputs run to ~10)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import model as jmodel
    from repro.models import pipeline_stages as jps
    from repro.models.pcontext import ParallelContext as JPC
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models import model, pipeline_stages as ps
    from repro_torch.models.pcontext import UNSHARDED
    cfg, jcfg = get_config("llama3.2-1b", True), jget("llama3.2-1b", True)
    jslab = jmodel.init_params(jax.random.key(3), jcfg, tp=1,
                               dtype=jnp.float32)["g0"]
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(h.shape).astype(np.float32)
    pos = jnp.arange(12)

    def jloss(slab, hh):
        out, aux = jps.stage_forward(slab, hh, jcfg, JPC(), pos, remat=remat)
        return jnp.sum(out * ct) + aux, out
    (_, jout), (jgs, jgh) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jslab, jnp.asarray(h))

    slab = model.params_from_numpy(jax.tree.map(np.asarray, jslab), "cpu")
    slab = tree.map_with_path(lambda _p, x: x.requires_grad_(True), slab)
    th = torch.from_numpy(h).requires_grad_(True)
    out, aux = ps.stage_forward(slab, th, cfg, UNSHARDED,
                                torch.arange(12), remat=remat)
    ((out * torch.from_numpy(ct)).sum() + aux).backward()
    def close(got, want, msg=""):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=msg)
    close(out.detach().numpy(), jout)
    close(th.grad.numpy(), jgh)
    want = {"/".join(k.key for k in p): g for p, g in
            jax.tree_util.tree_leaves_with_path(jgs)}
    for path, x in tree.leaves_with_paths(slab):
        close(x.grad.numpy(), want["/".join(path)], str(path))


# -- the p2p plumbing ----------------------------------------------------------

def _pp_mix(pkg):
    if pkg == "port":
        from repro_torch.configs import get_config
        from repro_torch.tuner.placement import CollectiveMix
    else:
        from repro.configs import get_config
        from repro.tuner.placement import CollectiveMix
    cfg = get_config("deepseek-coder-33b")
    return cfg, CollectiveMix

@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_for_model_pipeline_terms(pkg):
    """The pipeline axis carries 2 p2p hops a microbatch; pipelining
    shrinks the other axes' per-layer traffic by 1/p; the two packages'
    mixes are the same."""
    cfg, mix_cls = _pp_mix(pkg)
    axes = {"stage": 4, "model": 4, "data": 2}
    mix = mix_cls.for_model(cfg, axes, pp_axis="stage", microbatches=8)
    stage = mix.axis("stage")
    assert [c.primitive for c in stage.calls] == ["p2p"]
    assert stage.calls[0].calls == 16.0
    base = mix_cls.for_model(cfg, {"model": 4, "data": 2})
    assert mix.axis("model").bytes_per_step == pytest.approx(
        base.axis("model").bytes_per_step / 4)
    assert mix.axis("data").bytes_per_step == pytest.approx(
        base.axis("data").bytes_per_step / 4)
    _, other = _pp_mix("reference" if pkg == "port" else "port")
    twin = other.for_model(cfg, axes, pp_axis="stage", microbatches=8)
    for name in axes:
        a, b = mix.axis(name), twin.axis(name)
        assert [(c.primitive, c.msg_bytes, c.calls) for c in a.calls] == \
            [(c.primitive, c.msg_bytes, c.calls) for c in b.calls], name


def _topology(pkg):
    if pkg == "port":
        from repro_torch.core.hw import (CXLPoolConfig, ICIConfig,
                                         InfiniBandConfig)
        from repro_torch.core.topology import Level, Topology
        from repro_torch.tuner.placement import plan_placement
    else:
        from repro.core.hw import CXLPoolConfig, ICIConfig, InfiniBandConfig
        from repro.core.topology import Level, Topology
        from repro.tuner.placement import plan_placement
    topo = Topology(levels=(
        Level("pod", "ib", ib=InfiniBandConfig(link_bw=2.5e9), shape=(2,)),
        Level("node", "cxl", pool=CXLPoolConfig(device_bw=18e9),
              ib=InfiniBandConfig(link_bw=10e9), shape=(4,)),
        Level("gpu", "ici", ici=ICIConfig(link_bw=45e9), shape=(4,))))
    return topo, plan_placement


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_placement_prices_pipeline_mix(pkg):
    """A (stage, model, data) mix with a pipeline axis ranks, the best
    placement priced finite and positive."""
    cfg, mix_cls = _pp_mix(pkg)
    topo, plan_placement = _topology(pkg)
    mix = mix_cls.for_model(cfg, {"stage": 4, "model": 4, "data": 2},
                            pp_axis="stage", microbatches=8)
    plan = plan_placement(mix, topo)
    assert plan.ranked
    assert np.isfinite(plan.best.predicted_exposed_s)
    assert plan.best.predicted_exposed_s > 0.0


def test_sweep_emits_per_level_p2p_cells():
    """With ``stage`` on ib and ``node`` on the pool: p2p cells at both
    levels, ring on the ib level, cxl for the 16 MiB bucket on the pool
    level, the cells the reference's sweep chooses, and a round trip
    through JSON keeps them."""
    from repro import tuner as jtuner
    from repro.core.hw import CXLPoolConfig as JCXL
    from repro.core.hw import InfiniBandConfig as JIB
    from repro.core.topology import Level as JLevel
    from repro.core.topology import Topology as JTopology
    from repro_torch import tuner
    from repro_torch.core.hw import CXLPoolConfig, InfiniBandConfig
    from repro_torch.core.topology import Level, Topology
    grid = dict(sizes=(4096, 16 * MiB), nranks=(2, 4),
                slicing_factors=(1, 4, 8))
    topo = Topology(levels=(
        Level("stage", "ib", ib=InfiniBandConfig(link_bw=2.5e9)),
        Level("node", "cxl", pool=CXLPoolConfig(device_bw=18e9),
              ib=InfiniBandConfig(link_bw=10e9))))
    jtopo = JTopology(levels=(
        JLevel("stage", "ib", ib=JIB(link_bw=2.5e9)),
        JLevel("node", "cxl", pool=JCXL(device_bw=18e9),
               ib=JIB(link_bw=10e9))))
    plan = tuner.generate_plan(tuner.TuneGrid(**grid), topology=topo)
    jplan = jtuner.generate_plan(jtuner.TuneGrid(**grid), topology=jtopo)
    ib_key, node_key = topo.level_key("stage"), topo.level_key("node")
    for lkey in (ib_key, node_key):
        for size in grid["sizes"]:
            ch = plan.lookup("p2p", size, 2, level=lkey)
            want = jplan.lookup("p2p", size, 2, level=lkey)
            assert (ch.backend, ch.slicing_factor) == \
                (want.backend, want.slicing_factor), (lkey, size)
    for key, ch in plan.entries.items():
        if key[0] == "p2p" and len(key) == 4 and key[3] == ib_key:
            assert ch.backend == "ring", (key, ch)
    assert plan.lookup("p2p", 16 * MiB, 2, level=node_key).backend == "cxl"
    again = tuner.Plan.from_json(plan.to_json())
    assert again.entries == plan.entries


def test_from_dryrun_keeps_p2p_level_attribution():
    from repro_torch.tuner.placement import CollectiveMix
    rec = {"ledger": {"auto_choices": [
        {"primitive": "p2p", "msg_bytes": 65536, "nranks": 2,
         "backend": "cxl", "slicing_factor": 4,
         "allreduce_mode": "two_phase", "level": "stage", "calls": 8.0},
        {"primitive": "all_reduce", "msg_bytes": 4096, "nranks": 4,
         "backend": "ring", "slicing_factor": 1,
         "allreduce_mode": "two_phase", "level": None, "calls": 2.0}]}}
    mix = CollectiveMix.from_dryrun(rec, {"data": 4})
    stage = mix.axis("stage")
    assert stage.calls[0].primitive == "p2p"
    assert stage.calls[0].calls == 8.0
    assert stage.size == 2
    assert mix.axis("data").size == 4


def test_tune_writes_stage_level_p2p_cells(tmp_path):
    """``launch.tune --topology stage:cxl,data:cxl --nranks 2`` (the card's
    plan for the pipeline) holds p2p cells at the stage level for every
    size, which a handoff under auto resolves to."""
    from repro_torch.core.topology import parse_topology
    from repro_torch.launch import tune
    from repro_torch.tuner import load_plan
    path = str(tmp_path / "plan.json")
    tune.main(["--topology", "stage:cxl,data:cxl", "--nranks", "2",
               "--sizes-mib", "1", "4", "--quiet", "--out", path])
    plan = load_plan(path)
    topo = parse_topology("stage:cxl,data:cxl")
    stage = topo.level_key("stage")
    cells = [k for k in plan.entries if k[0] == "p2p" and len(k) == 4
             and k[3] == stage]
    assert len(cells) == 2
    for mib in (1, 4):
        assert plan.lookup("p2p", mib * MiB, 2, level=stage) is not None


# -- the launcher ------------------------------------------------------------

REFUSALS = [
    (["--placement", "auto", "--topology", "stage:cxl,data:cxl"],
     "--placement is not supported with --pp-stages > 1"),
    (["--multi-pod"], "--multi-pod is not supported with --pp-stages > 1"),
    (["--fuse-kernels"], "--fuse-kernels has nothing to fuse"),
    (["--mesh", "2x2"], "the model axis must be 1"),
    (["--pp-stages", "3"], "--pp-stages 3 does not divide 4 ranks"),
    (["--pp-stages", "4"], "2 layers not divisible by 4 stages"),
    (["--arch", "zamba2-1.2b"], "needs a uniform layer stack"),
    (["--arch", "whisper-tiny"], "decoder-only text models"),
    (["--arch", "phi-3-vision-4.2b"], "decoder-only text models"),
    (["--pp-schedule", "interleaved", "--microbatches", "3", "--batch",
      "12"], "interleaved schedule needs microbatches % stages == 0"),
    (["--batch", "6"], "--batch 6 must split over 2 data ranks x 2"),
    (["--pp-stages", "0"], "--pp-stages must be >= 1"),
]


@pytest.mark.parametrize("extra,message", REFUSALS,
                         ids=[r[1][:24] for r in REFUSALS])
def test_launcher_refuses(extra, message):
    from repro_torch.launch import train
    base = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--mesh",
            "4x1", "--pp-stages", "2", "--microbatches", "2", "--batch", "8"]
    args = train.build_parser().parse_args(base + extra)
    with pytest.raises(SystemExit, match=re.escape(message)):
        train.spec_from_args(args)


def test_pipeline_mesh_and_its_rank_groups():
    """``--mesh 4x1 --pp-stages 2`` is ((stage, 2), (data, 2)), rank r at
    stage r // 2: its level groups are those of ``--mesh 2x2``'s (data,
    model), so the two ride one spawn of the ranks; (4, 1) has none, as
    the flat mesh."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import level_groups, mesh_shape
    ap = train.build_parser()
    spec = train.spec_from_args(ap.parse_args([
        "--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--mesh",
        "4x1", "--pp-stages", "2", "--microbatches", "2", "--batch", "8"]))
    assert spec.mesh() == (("stage", 2), ("data", 2))
    assert spec.data_ranks() == 2
    assert level_groups(spec.mesh()) == [(0, 2), (1, 3), (0, 1), (2, 3)] \
        == level_groups(mesh_shape(2, 2))
    tp = dataclasses.replace(spec, dp=2, tp=2, pp_stages=1)
    assert train._spawn_groups(tp) == train._spawn_groups(spec)
    flat = dataclasses.replace(spec, pp_stages=1)
    deep = dataclasses.replace(spec, pp_stages=4)
    assert train._spawn_groups(flat) == train._spawn_groups(deep)
    assert train._spawn_groups(flat) != train._spawn_groups(spec)


def test_train_ckpt_across_stages_and_serve_it(tmp_path):
    """``train --pp-stages 2 --ckpt`` on 4 gloo ranks, in one spawn with
    a (data, model) run of the same rank groups: the checkpoint holds the
    stage slabs concatenated into the GLOBAL shapes, bitwise the ranks'
    final params, and ``serve --ckpt`` of it gives the greedy tokens of
    an engine built from them.  Each run books its own levels."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.core.topology import parse_topology
    from repro_torch.launch import serve, train
    from repro_torch.models import model
    from repro_torch.serving import ServeConfig, ServeEngine
    from repro_torch.training import checkpoint
    from repro_torch.training.train_loop import TrainConfig
    cfg = get_config("llama3.2-1b", smoke=True)
    ckpt = str(tmp_path / "ckpt")
    tc = dict(lr=3e-4, warmup=0, total_steps=2, clip_norm=None,
              microbatches=2)
    pp = train.RunSpec(
        arch="llama3.2-1b", smoke=True,
        variants=(TrainConfig(backend="cxl", **tc),
                  TrainConfig(backend="ring", **tc)),
        steps=2, batch=8, seq=16, dp=4, device="cpu", capture_params=True,
        ckpt=ckpt, timeout_s=120.0, pp_stages=2,
        topology=parse_topology("stage:cxl,data:cxl"))
    tp = dataclasses.replace(
        pp, dp=2, tp=2, pp_stages=1, ckpt=None, capture_params=False,
        variants=(TrainConfig(backend="cxl", lr=3e-4, warmup=0,
                              total_steps=2, clip_norm=None),),
        topology=parse_topology("data:cxl,model:cxl"))
    (cxl, ring), (tp_run,) = train.run_many([pp, tp])
    assert {a for a in tp_run["steps"][0]["pool_by_level"]} == \
        {"data", "model"}
    assert {a for a in cxl["steps"][0]["pool_by_level"]} == {"stage", "data"}
    assert set(cxl["steps"][0]["level_wire_bytes_rank0"]) == \
        {"stage/cxl", "data/cxl"}
    assert cxl["ckpt"] == os.path.join(ckpt, "step_00000002")
    like = {"params": model.abstract_params(cfg)}
    got = checkpoint.restore(ckpt, 2, like)["params"]
    ranks_params = cxl["params"]
    for path, x in tree.leaves_with_paths(got):
        key = "/".join(path)
        assert tuple(x.shape) == tuple(tree.get(like["params"], path).shape)
        if path[0].startswith("g"):
            want = np.concatenate([ranks_params[0][key],
                                   ranks_params[2][key]], 0)
        else:
            want = ranks_params[0][key]
        assert x.tobytes() == want.tobytes(), key
        assert x.tobytes() == tree.get(cxl["global_params"],
                                       path).tobytes(), key
    # ring and cxl trained the same arithmetic; the checkpoint is cxl's
    np.testing.assert_allclose([s["loss"] for s in ring["steps"]],
                               [s["loss"] for s in cxl["steps"]], rtol=1e-5)
    trained = model.params_from_numpy(cxl["global_params"], "cpu", cfg, 1)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    _, eng = serve.engine_from_args(serve.build_parser().parse_args([
        "--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--batch",
        "2", "--prompt-len", "8", "--new-tokens", "4", "--ckpt", ckpt]))
    want = ServeEngine(cfg, trained, ServeConfig(max_seq=20),
                       device="cpu").generate({"tokens": toks}, 4)
    np.testing.assert_array_equal(eng.generate({"tokens": toks}, 4), want)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--reference":
        reference_main(sys.argv[2])
    else:
        raise SystemExit(__doc__)
