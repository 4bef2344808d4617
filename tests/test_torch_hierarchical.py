"""The port's hierarchical (tuple) axes against the reference
``Communicator``.

The port's side runs on gloo CPU ranks (``repro_torch.launch.ranks``,
every level group with its own process group and its own 4 KiB pool);
the reference runs the same numpy inputs under ``shard_map`` over forced
host devices in a subprocess, so the device count never leaks into this
process.  Two families of cases:

* ``check_hierarchical`` and ``check_rank_major_layout`` of
  ``tests/_mesh_runner.py``, with no topology: the 48 x 5 all-gather,
  the (n, 16, 5) reduce-scatter then all-gather, and all-gather,
  reduce-scatter and all-reduce (a fused ring AllReduce under ring,
  the untagged decomposition under cxl and auto) of (8n, 5) over the
  tuple beside the flat axis, on 4
  ranks as (2, 2) and on 8 as (2, 4) and (4, 2), under ring, cxl and
  auto (a flat plan from the reference's tuner);
* ``check_topology_hierarchical``: ("pod", "node", "gpu") = (2, 2, 2)
  with ib / cxl / ici levels (each with its own fabric config, a plan
  tuned per level by the reference), every primitive that takes a
  tuple (all-reduce in both modes, root 5 for the rooted ones) under
  ring, cxl and auto, a bf16 all-reduce, and ("pod", "node") on (2, 4)
  and (4, 2) for all-reduce and broadcast.

Each port result equals the reference's, the numpy oracle's and the
flat axis's result: bitwise for data movement and for sums of
integer-valued f32; random f32 sums at rtol 1e-6, atol 1e-6; bf16 at rtol
3e-2, atol 3e-1.  The ledger's wire bytes, by primitive and by level,
equal the reference's snapshot of the same call, and under ``auto`` the
audit's decisions (level, fabric, backend and knobs) equal the
reference's, call by call.

Also runnable as a script: ``python tests/test_torch_hierarchical.py
--reference OUT.npz CASES.npz CASES.json`` writes the reference's
results.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT_DIR = os.path.dirname(HERE)
ROOT = 5
AUDIT_KEYS = ("primitive", "msg_bytes", "nranks", "backend",
              "slicing_factor", "allreduce_mode", "level", "fabric")
BACKENDS = ("ring", "cxl", "auto")
# mirror of check_hierarchical / check_rank_major_layout (no topology)
LAYOUT_SHAPES = {4: ((("p", 2), ("d", 2)),),
                 8: ((("p", 2), ("d", 4)), (("p", 4), ("d", 2)))}
TOPO_AXES = ("pod", "node", "gpu")
TOPO_PRIMS = ("all_reduce_two_phase", "all_reduce_faithful", "all_gather",
              "reduce_scatter", "broadcast", "reduce", "gather", "scatter")


def _layout_cases(n: int) -> list:
    out = []
    for shape in LAYOUT_SHAPES[n]:
        axes = tuple(a for a, _ in shape)
        tag = "x".join(str(s) for _, s in shape)
        for backend in BACKENDS:
            for op, then, rows, data in (
                    ("all_gather", None, 48 // n, "normal"),
                    ("reduce_scatter", "all_gather", 16,
                     "normal" if n == 4 else "int"),
                    ("all_gather", None, 8, "normal"),
                    ("reduce_scatter", None, 8, "int"),
                    ("all_reduce_two_phase", None, 8, "int")):
                for flat in (False, True):
                    out.append(dict(
                        id=f"layout-{tag}-{backend}-{op}"
                           + (f"-{then}" if then else "") + f"-{rows}"
                           + ("-flat" if flat else ""),
                        n=n, shape=(("x", n),) if flat else shape,
                        axis="x" if flat else axes, name=op, then=then,
                        backend=backend, rows=rows, data=data,
                        topology=None, pair=None if flat else True))
    return out


def _topo_cases() -> list:
    out = []
    shape3 = tuple((a, 2) for a in TOPO_AXES)
    for backend in BACKENDS:
        for name in TOPO_PRIMS + ("bf16",):
            prim = "all_reduce_two_phase" if name == "bf16" else name
            for flat in (False, True):
                out.append(dict(
                    id=f"topo-2x2x2-{backend}-{name}"
                       + ("-flat" if flat else ""),
                    n=8, shape=(("x", 8),) if flat else shape3,
                    axis="x" if flat else TOPO_AXES, name=prim, then=None,
                    backend=backend, rows=8,
                    data="bf16" if name == "bf16" else "int",
                    topology=None if flat else "pod,node,gpu",
                    pair=None if flat else True))
    for sizes in ((2, 4), (4, 2)):
        shape = (("pod", sizes[0]), ("node", sizes[1]))
        for backend in ("ring", "cxl"):
            for name in ("all_reduce_two_phase", "broadcast"):
                for flat in (False, True):
                    out.append(dict(
                        id=f"topo-{sizes[0]}x{sizes[1]}-{backend}-{name}"
                           + ("-flat" if flat else ""),
                        n=8, shape=(("x", 8),) if flat else shape,
                        axis="x" if flat else ("pod", "node"), name=name,
                        then=None, backend=backend, rows=8, data="int",
                        topology=None if flat else "pod,node",
                        pair=None if flat else True))
    return out


CASES = _layout_cases(4) + _layout_cases(8) + _topo_cases()


def _flat_of(i: int) -> int:
    return CASES.index(dict(CASES[i], id=CASES[i]["id"] + "-flat",
                            shape=(("x", CASES[i]["n"]),), axis="x",
                            topology=None, pair=None))


def _input(i: int) -> np.ndarray:
    """Every rank's rows stacked rank-major, from a seed per case (the
    flat twin of a tuple case takes the same input)."""
    c = CASES[i]
    base = c["id"].replace("-flat", "")
    seed = sorted({x["id"].replace("-flat", "") for x in CASES}).index(base)
    rng = np.random.default_rng(1000 + seed)
    shape = (c["n"] * c["rows"], 5)
    if c["data"] == "int":
        return rng.integers(-8, 8, shape).astype(np.float32)
    if c["data"] == "bf16":
        return (rng.integers(-8, 8, shape)
                + 0.25 * rng.standard_normal(shape)).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def reference_topology():
    """The reference's 3-level topology of ``check_topology_hierarchical``
    (distinct fabric configs per level)."""
    from repro.core.hw import CXLPoolConfig, ICIConfig, InfiniBandConfig
    from repro.core.topology import Level, Topology
    return Topology(levels=(
        Level("pod", "ib", ib=InfiniBandConfig(link_bw=12.5e9)),
        Level("node", "cxl", pool=CXLPoolConfig(device_bw=18e9)),
        Level("gpu", "ici", ici=ICIConfig(link_bw=45e9))))


def _method(name: str) -> tuple:
    from repro_torch.launch.collectives import PRIMITIVES
    return PRIMITIVES[name]


def reference_main(out_path: str, cases_path: str, meta_path: str) -> None:
    """The reference side, in a process with 8 forced host devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core import ledger
    from repro.core.api import Communicator
    from repro.core.topology import Topology
    from repro.tuner import load_plan

    with open(meta_path) as f:
        meta = json.load(f)
    topo3 = Topology.from_json(meta["topology"])
    topos = {"pod,node,gpu": topo3,
             "pod,node": Topology(levels=topo3.levels[:2])}
    plans = {"flat": load_plan(meta["flat_plan"]),
             "topo": load_plan(meta["topo_plan"])}
    with np.load(cases_path) as f:
        data = {k: f[k] for k in f.files}
    out = {}
    for i, c in enumerate(CASES):
        method, mode = _method(c["name"])
        topo = topos.get(c["topology"]) if c["topology"] else None
        plan = plans["topo" if c["id"].startswith("topo") else "flat"]
        comm = Communicator(backend=c["backend"],
                            allreduce_mode=mode or "two_phase", plan=plan,
                            topology=topo)
        names = tuple(a for a, _ in c["shape"])
        mesh = jax.make_mesh(tuple(s for _, s in c["shape"]), names,
                             devices=jax.devices()[:c["n"]])
        axis = c["axis"] if isinstance(c["axis"], str) else tuple(c["axis"])
        spec = P(axis)

        def fn(a, comm=comm, c=c, axis=axis, method=method):
            if c["name"] in ("broadcast", "reduce", "gather", "scatter"):
                y = getattr(comm, method)(a, axis, root=ROOT)
            else:
                y = getattr(comm, method)(a, axis)
            if c["then"]:
                y = getattr(comm, _method(c["then"])[0])(y, axis)
            return y

        x = data[f"x{i}"]
        if c["data"] == "bf16":
            x = jnp.asarray(x, jnp.bfloat16)
        ledger.reset()
        f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=spec,
                                  out_specs=spec, check_vma=False))
        y = np.asarray(f(x), np.float32)
        snap = ledger.snapshot()
        for r, part in enumerate(np.split(y, c["n"])):
            out[f"y{i}_{r}"] = part
        out[f"ledger{i}"] = np.asarray(json.dumps({
            "wire_bytes": snap["wire_bytes"],
            "level_wire_bytes": snap["level_wire_bytes"],
            "audit": [[a[k] for k in AUDIT_KEYS]
                      for a in snap["auto_choices"]]}))
    np.savez(out_path, **out)


def _run_port(n: int, plans: dict, topo3) -> list:
    from repro_torch.core.topology import Topology
    from repro_torch.launch import collectives, ranks
    from repro_torch.launch.mesh import level_groups
    topos = {"pod,node,gpu": topo3,
             "pod,node": Topology(levels=topo3.levels[:2])}
    idx = [i for i, c in enumerate(CASES) if c["n"] == n]
    cases, groups = [], []
    for i in idx:
        c = CASES[i]
        xs = np.split(_input(i), n)
        cases.append(dict(
            name=c["name"], then=c["then"], backend=c["backend"],
            x=xs, shape=c["shape"], axis=c["axis"], root=ROOT,
            topology=topos.get(c["topology"]) if c["topology"] else None,
            plan=plans["topo" if c["id"].startswith("topo") else "flat"]
            if c["backend"] == "auto" else None,
            dtype="bfloat16" if c["data"] == "bf16" else "float32",
            ledger=True))
        groups += [g for g in level_groups(c["shape"]) if g not in groups]
    res = ranks.spawn(collectives.rank_cases, n, (cases,), device="cpu",
                      partition_bytes=1 << 12, groups=groups,
                      timeout_s=120.0)
    return [(i, [res[r][k] for r in range(n)]) for k, i in enumerate(idx)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro import tuner as rtuner
    from repro_torch import tuner as ptuner
    from repro_torch.core.topology import Topology

    tmp = tmp_path_factory.mktemp("torch_hierarchical")
    paths = {k: str(tmp / f"{k}.{ext}") for k, ext in (
        ("cases", "npz"), ("ref", "npz"), ("meta", "json"),
        ("flat_plan", "json"), ("topo_plan", "json"))}
    rtopo = reference_topology()
    rtuner.save_plan(rtuner.generate_plan(rtuner.SMOKE_GRID),
                     paths["flat_plan"])
    rtuner.save_plan(rtuner.generate_plan(rtuner.TuneGrid(
        sizes=(256, 4096, 65536), nranks=(2, 4, 8),
        slicing_factors=(1, 4)), topology=rtopo), paths["topo_plan"])
    with open(paths["meta"], "w") as f:
        json.dump({"topology": rtopo.to_json(),
                   "flat_plan": paths["flat_plan"],
                   "topo_plan": paths["topo_plan"]}, f)
    np.savez(paths["cases"], **{f"x{i}": _input(i)
                                for i in range(len(CASES))})
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT_DIR, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    ref = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                            "--reference", paths["ref"], paths["cases"],
                            paths["meta"]], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        # the same topology JSON and plan files on the port's side, so
        # every level fingerprints as the reference's does
        topo3 = Topology.from_json(rtopo.to_json())
        plans = {"flat": ptuner.load_plan(paths["flat_plan"]),
                 "topo": ptuner.load_plan(paths["topo_plan"])}
        mine = dict(_run_port(4, plans, topo3) + _run_port(8, plans, topo3))
        log, _ = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log[-3000:]
    with np.load(paths["ref"]) as f:
        reference = {k: f[k] for k in f.files}
    return mine, reference


def _oracle(i: int, r: int) -> np.ndarray:
    from repro_torch.launch.collectives import oracle
    c = CASES[i]
    xs = np.split(_input(i), c["n"])
    if c["then"]:                       # reduce_scatter then all_gather
        return oracle("all_reduce_two_phase", xs, r)
    return oracle(c["name"], xs, r, ROOT)


def _tol(i: int):
    """None: bitwise; else (rtol, atol)."""
    c = CASES[i]
    if c["data"] == "bf16":
        return (3e-2, 3e-1)
    reducing = c["name"] in ("reduce_scatter", "all_reduce_two_phase",
                             "all_reduce_faithful", "reduce")
    return (1e-6, 1e-6) if reducing and c["data"] == "normal" else None


def _check(got, want, tol, msg):
    assert got.shape == want.shape, msg
    if tol is None:
        np.testing.assert_array_equal(got, want, err_msg=msg)
    else:
        np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1],
                                   err_msg=msg)


def _group(c: dict) -> str:
    """A case's family, mesh and backend: ``layout-2x4-cxl``."""
    return "-".join(c["id"].split("-")[:3])


GROUPS = sorted({_group(c) for c in CASES})


def _members(group: str, tuple_only: bool = False) -> list:
    return [i for i, c in enumerate(CASES) if _group(c) == group
            and (c["pair"] or not tuple_only)]


@pytest.mark.parametrize("group", GROUPS)
def test_matches_reference_and_oracle(results, group):
    mine, reference = results
    for i in _members(group):
        tol = _tol(i)
        for r, (got, _) in enumerate(mine[i]):
            _check(got, reference[f"y{i}_{r}"], tol,
                   f"{CASES[i]['id']} rank {r} vs reference")
            if CASES[i]["data"] != "bf16":
                _check(got, _oracle(i, r), tol,
                       f"{CASES[i]['id']} rank {r} vs oracle")


@pytest.mark.parametrize("group", GROUPS)
def test_tuple_axis_equals_the_flat_axis(results, group):
    """Rank-major: the tuple's result on rank r is the flat axis's on
    rank r (the reference's ``check_rank_major_layout`` and the flat
    comparisons of ``check_topology_hierarchical``)."""
    mine, _ = results
    for i in _members(group, tuple_only=True):
        j = _flat_of(i)
        for r in range(CASES[i]["n"]):
            _check(mine[i][r][0], mine[j][r][0], _tol(i),
                   f"{CASES[i]['id']} rank {r}")


@pytest.mark.parametrize("group", GROUPS)
def test_ledger_matches_reference(results, group):
    """Wire bytes by primitive and by level/fabric, and the ``auto``
    decisions call by call, equal the reference's snapshot."""
    mine, reference = results
    for i in _members(group):
        want = json.loads(str(reference[f"ledger{i}"]))
        for r in range(CASES[i]["n"]):
            snap, msg = mine[i][r][1], f"{CASES[i]['id']} rank {r}"
            assert snap["wire_bytes"] == want["wire_bytes"], msg
            assert snap["level_wire_bytes"] == \
                want["level_wire_bytes"], msg
            got = [[a[k] for k in AUDIT_KEYS]
                   for a in snap["auto_choices"]]
            assert got == want["audit"], msg
            assert got or CASES[i]["backend"] != "auto", msg
            assert not got or CASES[i]["backend"] == "auto", msg


def test_topology_levels_book_every_fabric_and_pool_only_on_cxl(results):
    """The reference's acceptance on the 3-level all-reduce: every level
    books bytes on its own fabric, the pod (ib) level fewer than the gpu
    (ici) level, and under ``auto`` only the cxl level may take the
    pool."""
    mine, _ = results
    for backend in BACKENDS:
        i = [k for k, c in enumerate(CASES) if c["id"] ==
             f"topo-2x2x2-{backend}-all_reduce_two_phase"][0]
        snap = mine[i][0][1]
        lvl = {k: sum(v.values())
               for k, v in snap["level_wire_bytes"].items()}
        assert set(lvl) == {"pod/ib", "node/cxl", "gpu/ici"}, lvl
        assert lvl["pod/ib"] < lvl["gpu/ici"], lvl
        for a in snap["auto_choices"]:
            assert a["fabric"] == "cxl" or a["backend"] == "ring", a
        if backend == "auto":
            assert {a["level"] for a in snap["auto_choices"]} == \
                set(TOPO_AXES)


def test_tuple_axes_raise_where_the_reference_does():
    """all_to_all and send stay single-axis; ``axis_size`` and
    ``axis_index`` of a tuple are the product and the rank-major index.
    A grouped level inside the tuple (``data:cxl:2+1`` under ``pod:ib``,
    ROADMAP queue 1 item 6) computes: the all-reduce over ("pod",
    "data") = (2, 3) on 6 gloo ranks under cxl equals the numpy oracle
    bitwise on every rank, its data level reduce-scattering and
    all-gathering through the grouped schedules (the sub-root exchange
    booked on the pod level) and no fallback booked."""
    import torch

    from repro_torch.core.api import Communicator
    from repro_torch.core.mesh_collectives import AxisGroup
    from repro_torch.core.topology import parse_topology
    from repro_torch.launch import collectives, ranks
    from repro_torch.launch.mesh import level_groups
    axes = {"pod": AxisGroup("pod", 1, 2), "data": AxisGroup("data", 1, 3)}
    comm = Communicator(backend="cxl", axes=axes)
    assert comm.axis_size(("pod", "data")) == 6
    assert comm.axis_index(("pod", "data")) == 4
    x = torch.zeros(6, 2)
    with pytest.raises(NotImplementedError, match="single-axis"):
        comm.all_to_all(x, ("pod", "data"))
    with pytest.raises(NotImplementedError, match="single-axis"):
        comm.send(x, ("pod", "data"))
    topo = parse_topology("pod:ib,data:cxl:2+1")
    shape = (("pod", 2), ("data", 3))
    xs = np.split(np.random.default_rng(6).integers(
        -8, 8, (36, 2)).astype(np.float32), 6)
    case = dict(name="all_reduce_two_phase", backend="cxl", x=xs,
                shape=shape, axis=("pod", "data"), topology=topo,
                ledger=True)
    res = ranks.spawn(collectives.rank_cases, 6, ([case],), device="cpu",
                      partition_bytes=1 << 12,
                      groups=level_groups(shape, topo), timeout_s=120.0)
    want = collectives.oracle("all_reduce_two_phase", xs, 0)
    for r, [(got, snap)] in enumerate(res):
        np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")
        assert snap["fallbacks"] == []
        lvl = snap["level_wire_bytes"]
        assert set(lvl) == {"pod/ib", "data/cxl"}
        assert set(lvl["data/cxl"]) == {"reduce_scatter", "all_gather",
                                        "broadcast"}


def test_level_groups_and_rank_major_mesh():
    """``launch.mesh``: the (pod, data) mesh puts rank r at pod
    r // (dp / 2), data r % (dp / 2), and every level group is listed
    once."""
    from repro_torch.launch import mesh
    shape = mesh.mesh_shape(4, 1, multi_pod=True)
    assert shape == (("pod", 2), ("data", 2), ("model", 1))
    assert mesh.level_groups(shape) == [(0, 2), (1, 3), (0, 1), (2, 3)]
    assert mesh.level_groups(mesh.mesh_shape(4)) == []
    assert mesh.level_groups(tuple((a, 2) for a in TOPO_AXES)) == [
        (0, 4), (1, 5), (2, 6), (3, 7), (0, 2), (1, 3), (4, 6), (5, 7),
        (0, 1), (2, 3), (4, 5), (6, 7)]
    with pytest.raises(ValueError, match="even"):
        mesh.mesh_shape(3, 1, multi_pod=True)


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--reference":
        reference_main(sys.argv[2], sys.argv[3], sys.argv[4])
    else:
        print("usage: --reference OUT.npz CASES.npz CASES.json")
        sys.exit(2)
