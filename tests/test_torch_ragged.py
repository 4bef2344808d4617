"""The port's grouped (ragged) topology levels against the reference
``Communicator`` and ``repro.core.mesh_collectives``.

A grouped level - a shape vector of more than one group, ``node:cxl:4+2``
- lives on one flat axis of ``sum(shape)`` ranks.  The port's side runs
on gloo CPU ranks (``repro_torch.launch.ranks``, every group of more than
one rank and the group sub-roots with a process group and a 4 KiB pool
of their own); the reference runs the same numpy inputs under
``shard_map`` over forced host devices in a subprocess.  Cases:

* ``check_irregular_ragged`` / ``check_ragged_reduce_scatter`` /
  ``check_fallback_audit`` of ``tests/_mesh_runner.py``: ``(4, 2)`` on 6
  ranks under the parent ``pod:ib`` (slicing factors 1 and 4 in the
  plan), and ``(3, 1)`` and ``(2, 1)`` under ``pod:cxl``, each under
  ring, cxl and auto (a plan per topology from the reference's tuner):
  the ragged all_reduce, all_gather, reduce_scatter and gather, and the
  four primitives that run flat on such an axis (broadcast, reduce,
  scatter, all_to_all);
* the grouped schedules themselves (``grouped_all_reduce``,
  ``subroot_all_reduce``, ``grouped_broadcast``, ``ragged_*``) on the
  three shapes, the port's under ring and cxl;
* a grouped level inside a tuple axis: ("pod", "data") = (2, 3) with
  ``data:cxl:2+1`` under ``pod:ib``.

Inputs are integer-valued f32, so every sum is exact: each port result
equals the reference's and the numpy oracle's bitwise.  The ledger's
wire bytes by primitive and by level, the ``auto`` decisions call by
call and the fallback events equal the reference's.

Also runnable as a script: ``python tests/test_torch_ragged.py
--reference OUT.npz CASES.npz META.json`` writes the reference's
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
ROWS = 12             # a rank's rows: divides 6, 4 and 3 ranks
AUDIT_KEYS = ("primitive", "msg_bytes", "nranks", "backend",
              "slicing_factor", "allreduce_mode", "level", "fabric")
BACKENDS = ("ring", "cxl", "auto")
# name -> (topology spec, mesh shape, axis)
TOPOLOGIES = {
    "4+2": ("pod:ib,node:cxl:4+2", (("node", 6),), "node"),
    "3+1": ("pod:cxl,data:cxl:3+1", (("data", 4),), "data"),
    "2+1": ("pod:cxl,data:cxl:2+1", (("data", 3),), "data"),
    "tuple": ("pod:ib,data:cxl:2+1", (("pod", 2), ("data", 3)),
              ("pod", "data")),
}
RAGGED = ("all_reduce_two_phase", "all_gather", "reduce_scatter", "gather")
FLAT_ON_RAGGED = ("broadcast", "reduce", "scatter", "all_to_all")
SCHEDULES = ("grouped_all_reduce", "subroot_all_reduce", "grouped_broadcast",
             "ragged_all_reduce", "ragged_all_gather",
             "ragged_reduce_scatter", "ragged_gather")


def _cases() -> list:
    out = []
    for topo, (_, shape, axis) in TOPOLOGIES.items():
        n = int(np.prod([s for _, s in shape]))
        prims = RAGGED + (FLAT_ON_RAGGED if topo != "tuple" else ())
        for backend in BACKENDS:
            for name in prims:
                out.append(dict(id=f"{topo}-comm-{backend}-{name}",
                                topo=topo, kind="comm", backend=backend,
                                name=name, n=n, shape=shape, axis=axis,
                                root=n - 2))
        if topo == "tuple":
            continue
        for backend in ("ring", "cxl"):
            for name in SCHEDULES:
                out.append(dict(id=f"{topo}-schedule-{backend}-{name}",
                                topo=topo, kind="schedule", backend=backend,
                                name=name, n=n, shape=shape, axis=axis,
                                root=0))
    return out


CASES = _cases()


def _base(c: dict) -> str:
    """A case's input key: a schedule's ring and cxl cases share one."""
    return f"{c['topo']}-{c['name']}" if c["kind"] == "schedule" \
        else c["id"]


BASES = sorted({_base(c) for c in CASES})


def _input(i: int) -> np.ndarray:
    """Every rank's rows stacked rank-major, integer-valued f32."""
    rng = np.random.default_rng(2100 + BASES.index(_base(CASES[i])))
    return rng.integers(-8, 8, (CASES[i]["n"] * ROWS, 5)).astype(np.float32)


def reference_topology(name: str):
    """The reference's topology of ``name``: ``(4, 2)`` under the slow IB
    parent and the 18 GB/s pool of ``check_irregular_ragged``, the others
    on the default fabric configs."""
    from repro.core.hw import CXLPoolConfig, InfiniBandConfig
    from repro.core.topology import Level, Topology, parse_topology
    if name == "4+2":
        return Topology(levels=(
            Level("pod", "ib", ib=InfiniBandConfig(link_bw=2.5e9)),
            Level("node", "cxl", pool=CXLPoolConfig(device_bw=18e9),
                  shape=(4, 2))))
    return parse_topology(TOPOLOGIES[name][0])


def reference_main(out_path: str, cases_path: str, meta_path: str) -> None:
    """The reference side, in a process with 6 forced host devices."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.core import ledger
    from repro.core import mesh_collectives as mc
    from repro.core.api import Communicator
    from repro.core.topology import Topology
    from repro.tuner import load_plan
    from repro_torch.launch.collectives import PRIMITIVES, ROOTED

    with open(meta_path) as f:
        meta = json.load(f)
    topos = {k: Topology.from_json(v) for k, v in meta["topologies"].items()}
    plans = {k: load_plan(v) for k, v in meta["plans"].items()}
    with np.load(cases_path) as f:
        data = {k: f[k] for k in f.files}
    out, done = {}, {}
    for i, c in enumerate(CASES):
        topo = topos[c["topo"]]
        # a grouped schedule takes no backend in the reference: run it
        # once for the port's ring and cxl cases
        key = _base(c)
        if key in done:
            j = done[key]
            for r in range(c["n"]):
                out[f"y{i}_{r}"] = out[f"y{j}_{r}"]
            out[f"ledger{i}"] = out[f"ledger{j}"]
            continue
        done[key] = i
        names = tuple(a for a, _ in c["shape"])
        mesh = jax.make_mesh(tuple(s for _, s in c["shape"]), names,
                             devices=jax.devices()[:c["n"]])
        axis = c["axis"] if isinstance(c["axis"], str) else tuple(c["axis"])
        if c["kind"] == "comm":
            comm = Communicator(backend=c["backend"], plan=plans[c["topo"]],
                                topology=topo, slicing_factor=4)
            method = PRIMITIVES[c["name"]][0]

            def fn(a, comm=comm, c=c, axis=axis, method=method):
                if c["name"] in ROOTED:
                    return getattr(comm, method)(a, axis, root=c["root"])
                return getattr(comm, method)(a, axis)
        else:
            shape = topo.level_for(axis).shape

            def fn(a, c=c, axis=axis, shape=shape):
                return getattr(mc, c["name"])(a, axis, shape)
        ledger.reset()
        f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P(axis),
                                  out_specs=P(axis), check_vma=False))
        y = np.asarray(f(data[f"x{i}"]))
        snap = ledger.snapshot()
        for r, part in enumerate(np.split(y, c["n"])):
            out[f"y{i}_{r}"] = part
        out[f"ledger{i}"] = np.asarray(json.dumps({
            "wire_bytes": snap["wire_bytes"],
            "level_wire_bytes": snap["level_wire_bytes"],
            "audit": [[a[k] for k in AUDIT_KEYS]
                      for a in snap["auto_choices"]],
            "fallbacks": snap["fallbacks"]}))
    np.savez(out_path, **out)


def port_rank(ctx, cases: list) -> list:
    """Each case on this rank: (its output, the ledger's snapshot)."""
    import torch

    from repro_torch.core import ledger
    from repro_torch.core import mesh_collectives as mc
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import make_host_mesh
    out = []
    for c in cases:
        x = torch.as_tensor(c["x"][ctx.rank])
        ledger.reset()
        if c["kind"] == "comm":
            comm = collectives.communicator(
                ctx, c["backend"], c["name"], 4, c["plan"], c["shape"],
                c["topology"])
            y = collectives.call(comm, c["name"], x, c["root"], c["axis"])
        else:
            mesh = make_host_mesh(c["shape"], ctx,
                                  pools=c["backend"] == "cxl",
                                  topology=c["topology"])
            y = getattr(mc, c["name"])(x, mesh[c["axis"]],
                                       backend=c["backend"])
        out.append((y.numpy(), ledger.snapshot()))
    return out


def _run_port(n: int, plans: dict, topos: dict) -> list:
    from repro_torch.launch import ranks
    from repro_torch.launch.mesh import level_groups
    idx = [i for i, c in enumerate(CASES) if c["n"] == n]
    cases, groups = [], []
    for i in idx:
        c = CASES[i]
        cases.append(dict(c, x=np.split(_input(i), n),
                          topology=topos[c["topo"]],
                          plan=plans[c["topo"]] if c["backend"] == "auto"
                          else None))
        groups += [g for g in level_groups(c["shape"], topos[c["topo"]])
                   if g not in groups]
    res = ranks.spawn(port_rank, n, (cases,), device="cpu",
                      partition_bytes=1 << 12, groups=groups,
                      timeout_s=120.0)
    return [(i, [res[r][k] for r in range(n)]) for k, i in enumerate(idx)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro import tuner as rtuner
    from repro_torch import tuner as ptuner
    from repro_torch.core.topology import Topology

    tmp = tmp_path_factory.mktemp("torch_ragged")
    paths = {"cases": str(tmp / "cases.npz"), "ref": str(tmp / "ref.npz"),
             "meta": str(tmp / "meta.json")}
    meta = {"topologies": {}, "plans": {}}
    for name in TOPOLOGIES:
        rtopo = reference_topology(name)
        meta["topologies"][name] = rtopo.to_json()
        meta["plans"][name] = str(tmp / f"plan-{name}.json")
        rtuner.save_plan(rtuner.generate_plan(rtuner.TuneGrid(
            sizes=(256, 4096, 65536), nranks=(2, 4),
            slicing_factors=(1, 4)), topology=rtopo), meta["plans"][name])
    with open(paths["meta"], "w") as f:
        json.dump(meta, f)
    np.savez(paths["cases"], **{f"x{i}": _input(i)
                                for i in range(len(CASES))})
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=6"
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
        topos = {k: Topology.from_json(v)
                 for k, v in meta["topologies"].items()}
        plans = {k: ptuner.load_plan(v) for k, v in meta["plans"].items()}
        mine = {}
        for n in sorted({c["n"] for c in CASES}):
            mine.update(_run_port(n, plans, topos))
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
    """What rank ``r`` of case ``i`` must return."""
    from repro_torch.core.mesh_collectives import _group_tables
    from repro_torch.launch.collectives import oracle
    c = CASES[i]
    xs = np.split(_input(i), c["n"])
    if c["kind"] == "comm":
        return oracle(c["name"], xs, r, c["root"])
    shape = tuple(int(g) for g in TOPOLOGIES[c["topo"]][0].split(":")[-1]
                  .split("+"))
    _, roots, gsize, _, groot = _group_tables(shape)
    group = range(groot[r], groot[r] + gsize[r])
    name = c["name"]
    if name == "grouped_all_reduce":
        return np.sum([xs[p] for p in group], axis=0, dtype=np.float32)
    if name == "subroot_all_reduce":
        return np.sum([xs[p] for p in roots], axis=0, dtype=np.float32) \
            if r in roots else xs[r]
    if name == "grouped_broadcast":
        return xs[groot[r]]
    return oracle({"ragged_all_reduce": "all_reduce_two_phase",
                   "ragged_all_gather": "all_gather",
                   "ragged_reduce_scatter": "reduce_scatter",
                   "ragged_gather": "gather"}[name], xs, r, 0)


def _group(c: dict) -> str:
    """A case's topology, kind and backend: ``3+1-comm-cxl``."""
    return "-".join(c["id"].split("-")[:3])


GROUPS = sorted({_group(c) for c in CASES})
COMM_GROUPS = [g for g in GROUPS if "-comm-" in g]


@pytest.mark.parametrize("group", GROUPS)
def test_matches_reference_and_oracle_bitwise(results, group):
    mine, reference = results
    for i, c in enumerate(CASES):
        if _group(c) != group:
            continue
        for r, (got, _) in enumerate(mine[i]):
            msg = f"{c['id']} rank {r}"
            want = reference[f"y{i}_{r}"]
            assert got.shape == want.shape, msg
            np.testing.assert_array_equal(got, want, err_msg=msg)
            np.testing.assert_array_equal(got, _oracle(i, r), err_msg=msg)


@pytest.mark.parametrize("group", COMM_GROUPS)
def test_ledger_matches_reference(results, group):
    """Wire bytes by primitive and by level, the ``auto`` decisions call
    by call, and the fallback events equal the reference's snapshot."""
    mine, reference = results
    for i, c in enumerate(CASES):
        if _group(c) != group:
            continue
        want = json.loads(str(reference[f"ledger{i}"]))
        for r in range(c["n"]):
            snap, msg = mine[i][r][1], f"{c['id']} rank {r}"
            assert snap["wire_bytes"] == want["wire_bytes"], msg
            assert snap["level_wire_bytes"] == \
                want["level_wire_bytes"], msg
            got = [[a[k] for k in AUDIT_KEYS]
                   for a in snap["auto_choices"]]
            assert got == want["audit"], msg
            assert bool(got) == (c["backend"] == "auto"), msg
            assert snap["fallbacks"] == want["fallbacks"], msg


@pytest.mark.parametrize("group", COMM_GROUPS)
def test_fallback_audit(results, group):
    """``check_fallback_audit``'s assertions, which the reference's
    runner never reaches: each flat-on-ragged call books exactly one
    event with its level, fabric and reason, and still attributes its
    wire bytes to the level; the ragged four book none."""
    mine, _ = results
    for i, c in enumerate(CASES):
        if _group(c) != group:
            continue
        level = c["axis"] if isinstance(c["axis"], str) else c["axis"][1]
        for r in range(c["n"]):
            snap, msg = mine[i][r][1], f"{c['id']} rank {r}"
            if c["name"] in RAGGED:
                assert snap["fallbacks"] == [], msg
                continue
            assert [e["primitive"] for e in snap["fallbacks"]] == \
                [c["name"]], msg
            e = snap["fallbacks"][0]
            assert (e["level"], e["fabric"], e["reason"], e["calls"]) == \
                (level, "cxl", "flat_on_ragged", 1.0), msg
            assert snap["level_wire_bytes"][f"{level}/cxl"][
                c["name"]] > 0.0, msg


@pytest.mark.parametrize("topo", ["4+2", "3+1", "2+1"])
def test_cross_group_bytes_ride_the_parent(results, topo):
    """``check_irregular_ragged`` / ``check_ragged_reduce_scatter``: the
    ragged all-reduce and reduce-scatter book bytes on the level and on
    its parent, fewer on the parent; under ``auto`` the within-group
    phase resolves at the largest group on the level and the sub-root
    exchange at the group count on the parent."""
    mine, _ = results
    _, shape, axis = TOPOLOGIES[topo]
    spec = TOPOLOGIES[topo][0]
    parent = spec.split(",")[0]
    gshape = tuple(int(g) for g in spec.split(":")[-1].split("+"))
    for backend in BACKENDS:
        for name in ("all_reduce_two_phase", "reduce_scatter"):
            i = [k for k, c in enumerate(CASES)
                 if c["id"] == f"{topo}-comm-{backend}-{name}"][0]
            snap = mine[i][0][1]
            lvl = {k: sum(v.values())
                   for k, v in snap["level_wire_bytes"].items()}
            assert set(lvl) == {f"{axis}/cxl", parent.replace(":", "/")}
            assert lvl[parent.replace(":", "/")] < lvl[f"{axis}/cxl"], lvl
            if backend == "auto":
                ns = {(a["level"], a["nranks"])
                      for a in snap["auto_choices"]}
                assert ns == {(axis, max(gshape)), ("pod", len(gshape))}


def test_level_groups_of_a_grouped_level():
    """``launch.mesh``: a grouped level adds its groups of more than one
    rank and its sub-roots, per instance of the axis, after the regular
    level groups, in rank-major order; a lone rank gets no group."""
    from repro_torch.core.topology import parse_topology
    from repro_torch.launch import mesh
    flat = mesh.mesh_shape(4)
    assert mesh.level_groups(flat, parse_topology(
        "pod:cxl,data:cxl:3+1")) == [(0, 1, 2), (0, 3)]
    assert mesh.level_groups((("node", 6),), parse_topology(
        "pod:ib,node:cxl:4+2")) == [(0, 1, 2, 3), (4, 5), (0, 4)]
    assert mesh.level_groups(TOPOLOGIES["tuple"][1], parse_topology(
        TOPOLOGIES["tuple"][0])) == [(0, 3), (1, 4), (2, 5), (0, 1, 2),
                                     (3, 4, 5), (0, 1), (0, 2), (3, 4),
                                     (3, 5)]
    assert mesh.level_groups(flat, parse_topology("pod:cxl,data:cxl")) == []
    with pytest.raises(ValueError, match="span"):
        mesh.level_groups(flat, parse_topology("pod:cxl,data:cxl:4+2"))


def test_schedules_refuse_an_ungrouped_axis():
    """A grouped schedule on an axis built without its topology raises
    naming the fix, instead of running flat."""
    import torch

    from repro_torch.core import mesh_collectives as mc
    ax = mc.AxisGroup("data", 0, 4)
    with pytest.raises(ValueError, match="topology"):
        mc.ragged_all_reduce(torch.zeros(4), ax)
    bad = mc.AxisGroup("data", 0, 4, grouped=mc.Grouping((2, 1)))
    with pytest.raises(ValueError, match="spans 3"):
        mc.grouped_all_reduce(torch.zeros(4), bad)


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--reference":
        reference_main(sys.argv[2], sys.argv[3], sys.argv[4])
    else:
        print("usage: --reference OUT.npz CASES.npz META.json")
        sys.exit(2)
