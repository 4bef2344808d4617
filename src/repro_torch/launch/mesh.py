"""The mesh of one rank: each named axis is an ``AxisGroup``.

Port of ``repro.launch.mesh`` for the one-host meshes the port runs:
``--mesh DPxTP`` with every rank a process of this host.  The ranks of a
one-card mesh share that card; the process group is ``gloo`` (NCCL
refuses two ranks on one card).

A mesh is a rank-major shape, ``((axis, size), ...)`` outer axis first:
rank r sits at the mixed-radix digits of r.  ``--multi-pod`` is the
one-host form of the reference's ``make_production_mesh(multi_pod=True)``:
the same axis names, ``("pod", "data", "model")``, at the host's rank
count, (2, DP/2, TP).  Rank r is then at pod ``r // (DP/2)`` and data
``r % (DP/2)``, the flat layout, so parameter shards are those of the
flat DPx1 run.  Each level of an axis with more than one rank is a group
of ranks (:func:`level_groups`) with a process group and a pool of its
own (``launch.ranks.spawn(groups=...)``); an axis that spans every rank
uses the default group and the pool of all the ranks.

``--mesh DPxTP`` with TP > 1 is ``(("data", DP), ("model", TP))``:
rank r sits at data ``r // TP`` and model ``r % TP``, so the ranks of
one data index (one model group) are adjacent and take the same batch
rows.  With ``--multi-pod`` and TP > 1 the data levels also form one
joint group per model index (``(("pod", "data"))`` in the mesh), the
process group of the fused ring AllReduce over the tuple.

An axis that a grouped topology level covers (``data:cxl:3+1``: one
flat axis of 4 ranks in contiguous groups of 3 and 1) also gets, for
each of its instances, a process group and a pool per group of more
than one rank and one for the group sub-roots (the first rank of each
group), created only with the topology (``level_groups(shape,
topology)``), and its ``AxisGroup`` carries this rank's
``mesh_collectives.Grouping``.

``--pp-stages S`` is ``(("stage", S), ("data", N / S))``
(:func:`pipeline_shape`): each level group has its own process group and
pool, as for ``(data, model)``.

The production meshes of the reference's dry-run are
:func:`make_production_mesh`'s axis-size dicts, ``{"data": 16, "model":
16}`` and ``{"pod": 2, "data": 16, "model": 16}``; with
``REPRO_DRYRUN_DEVICES`` set, :func:`dryrun_mesh` gives the reduced
``(2, 2)`` and ``(2, 2, 2)`` the reference's ``run_one`` builds.
:func:`make_meta_mesh` is one rank's mesh of such a shape with no
process group and no pool: what the dry-run traces on the meta device.

``make_placed_mesh`` applies a placement (``tuner.placement``): it
installs the axis aliases of a split axis and the placed topology, and
returns the mesh shape the placement chose; ``dp_axes`` resolves the
``data`` alias.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

from repro_torch.core.mesh_collectives import AxisGroup, Grouping


def parse_mesh(spec: str) -> tuple:
    """``"DPxTP"`` -> (dp, tp)."""
    try:
        dp, tp = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh wants DPxTP, e.g. 4x1, got {spec!r}"
                         ) from None
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh sizes must be >= 1, got {spec!r}")
    return dp, tp


def mesh_shape(dp: int, tp: int = 1, multi_pod: bool = False) -> tuple:
    """The rank-major shape of a host mesh: ``(("data", dp), ("model",
    tp))``, or with ``multi_pod`` ``(("pod", 2), ("data", dp // 2),
    ("model", tp))``."""
    if not multi_pod:
        return (("data", dp), ("model", tp))
    if dp % 2:
        raise ValueError(f"--multi-pod splits the data ranks over 2 pods: "
                         f"DP must be even, got {dp}")
    return (("pod", 2), ("data", dp // 2), ("model", tp))


def pipeline_shape(nranks: int, stages: int) -> tuple:
    """The rank-major shape of a pipeline's host mesh, ``(("stage", S),
    ("data", N / S))``, as the reference launcher's ``jax.make_mesh((S,
    N / S), ("stage", "data"))``: rank r at stage ``r // (N / S)`` and
    data ``r % (N / S)``."""
    if stages < 1 or nranks % stages:
        raise ValueError(f"--pp-stages {stages} does not divide "
                         f"{nranks} ranks")
    return (("stage", stages), ("data", nranks // stages))


def _coords(shape: Sequence[tuple], rank: int) -> list:
    out = []
    for _, n in reversed(shape):
        rank, c = divmod(rank, n)
        out.append(c)
    return out[::-1]


def _members(shape: Sequence[tuple], rank: int, axis: int) -> tuple:
    """The ranks that differ from ``rank`` only along axis ``axis``, in
    order of that axis's index."""
    stride = 1
    for _, n in shape[axis + 1:]:
        stride *= n
    base = rank - _coords(shape, rank)[axis] * stride
    return tuple(base + i * stride for i in range(shape[axis][1]))


def _nranks(shape: Sequence[tuple]) -> int:
    n = 1
    for _, size in shape:
        n *= size
    return n


def _dp_joint(shape: Sequence[tuple]) -> tuple:
    """The data levels (every axis but ``model``) that need a joint
    group: two or more of them with more than one rank, on a mesh whose
    model axis splits the ranks, else ()."""
    dp = tuple(i for i, (name, size) in enumerate(shape)
               if name != "model" and size > 1)
    model = dict(shape).get("model", 1)
    return dp if len(dp) > 1 and model > 1 else ()


def _joint_members(shape: Sequence[tuple], rank: int) -> tuple:
    """The ranks with ``rank``'s model coordinate, in rank order."""
    names = [name for name, _ in shape]
    m = names.index("model")
    c = _coords(shape, rank)[m]
    return tuple(r for r in range(_nranks(shape))
                 if _coords(shape, r)[m] == c)


def _grouped(topology, name: str, size: int) -> Optional[tuple]:
    """The shape vector of a grouped topology level over axis ``name``
    (None: the axis is not grouped), checked against the axis size."""
    lv = topology.level_for(name) if topology is not None else None
    if lv is None or not lv.grouped:
        return None
    if lv.size != size:
        raise ValueError(f"level {name!r} groups {lv.shape} span "
                         f"{lv.size} ranks but the mesh axis has {size}")
    return lv.shape


def _rank_groups(members: tuple, shape: tuple) -> tuple:
    """(the groups of more than one rank, the sub-roots or None) of one
    instance of a grouped axis whose ranks are ``members``."""
    groups, roots, start = [], [], 0
    for g in shape:
        roots.append(members[start])
        if g > 1:
            groups.append(members[start:start + g])
        start += g
    return groups, tuple(roots) if len(roots) > 1 else None


def level_groups(shape: Sequence[tuple], topology=None) -> list:
    """Every level group of the mesh: for each axis with more than one
    rank but fewer than all, the ranks of each of its groups (what
    ``ranks.spawn(groups=...)`` creates), in a fixed order; then the
    joint data groups (:func:`joint_groups`); then, for each axis that a
    grouped level of ``topology`` covers, each instance's rank groups of
    more than one rank and its sub-roots."""
    n = _nranks(shape)
    out: list = []
    for i, (_, size) in enumerate(shape):
        if size in (1, n):
            continue
        for r in range(n):
            g = _members(shape, r, i)
            if g not in out:
                out.append(g)
    out += [g for g in joint_groups(shape) if g not in out]
    for i, (name, size) in enumerate(shape):
        gshape = _grouped(topology, name, size)
        if gshape is None:
            continue
        for r in range(n):
            groups, roots = _rank_groups(_members(shape, r, i), gshape)
            for g in groups + ([roots] if roots else []):
                if g not in out:
                    out.append(g)
    return out


def joint_groups(shape: Sequence[tuple]) -> list:
    """The joint data groups of a multi-level data axis beside a model
    axis of TP > 1: one per model index, holding every rank of it.  They
    carry the ring AllReduce over the data tuple; no pool is needed
    (the cxl schedules decompose per level)."""
    if not _dp_joint(shape):
        return []
    out: list = []
    for r in range(_nranks(shape)):
        g = _joint_members(shape, r)
        if g not in out:
            out.append(g)
    return out


def _grouping(shape: Sequence[tuple], i: int, gshape: tuple, ctx,
              pools: bool, topology) -> Grouping:
    """This rank's groups on grouped axis ``i``: its own group (None for
    a group of one) and, on a sub-root, the sub-roots' group, named after
    the level whose fabric carries it (the parent level)."""
    name = shape[i][0]
    members = _members(shape, ctx.rank, i)
    groups, roots = _rank_groups(members, gshape)

    def sub(ranks: tuple, label: str) -> AxisGroup:
        pg, pool = ctx.groups[ranks]
        return AxisGroup(label, ranks.index(ctx.rank), len(ranks), pg,
                         pool if pools else None)

    inner = next((sub(g, name) for g in groups if ctx.rank in g), None)
    parent = topology.parent_of(name)
    cross = sub(roots, parent.axis if parent is not None else name) \
        if roots and ctx.rank in roots else None
    return Grouping(gshape, inner, cross)


def make_host_mesh(shape: Sequence[tuple], ctx, pools: bool = True,
                   topology=None) -> dict:
    """This rank's mesh: axis name -> ``AxisGroup`` for ``ctx`` (a
    ``ranks.RankContext``, spawned with ``groups=level_groups(shape,
    topology)``), and the tuple of data-level names -> the joint group
    where :func:`joint_groups` makes one (``Communicator._joint`` looks
    it up).  An axis that a grouped level of ``topology`` covers carries
    this rank's groups (``AxisGroup.grouped``).  ``pools=False`` leaves
    every level without a pool (ring only)."""
    n = _nranks(shape)
    if n != ctx.nranks:
        raise ValueError(f"mesh {shape} has {n} ranks, the host "
                         f"{ctx.nranks}")
    coords = _coords(shape, ctx.rank)
    mesh = {}
    for i, (name, size) in enumerate(shape):
        if size == 1:
            mesh[name] = AxisGroup(name, 0, 1)
        elif size == n:
            mesh[name] = AxisGroup(name, coords[i], size, None,
                                   ctx.pool if pools else None)
        else:
            pg, pool = ctx.groups[_members(shape, ctx.rank, i)]
            mesh[name] = AxisGroup(name, coords[i], size, pg,
                                   pool if pools else None)
        gshape = _grouped(topology, name, size)
        if gshape is not None:
            mesh[name] = dataclasses.replace(mesh[name], grouped=_grouping(
                shape, i, gshape, ctx, pools, topology))
    joint = _dp_joint(shape)
    if joint:
        names = tuple(shape[i][0] for i in joint)
        members = _joint_members(shape, ctx.rank)
        pg, _ = ctx.groups[members]
        mesh[names] = AxisGroup("+".join(names), members.index(ctx.rank),
                                len(members), pg, None)
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> dict:
    """The reference's production mesh as axis sizes: (data, model) =
    (16, 16), or (pod, data, model) = (2, 16, 16)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def dryrun_mesh(multi_pod: bool) -> dict:
    """The dry-run's mesh as axis sizes: the production mesh, or with
    ``REPRO_DRYRUN_DEVICES`` set the reduced (data, model) = (2, 2) and
    (pod, data, model) = (2, 2, 2), as the reference's ``run_one``."""
    if os.environ.get("REPRO_DRYRUN_DEVICES"):
        return {"pod": 2, "data": 2, "model": 2} if multi_pod \
            else {"data": 2, "model": 2}
    return make_production_mesh(multi_pod=multi_pod)


class _NoGroups(dict):
    """Every level group of a meta mesh: no process group, no pool."""

    def __missing__(self, ranks):
        return None, None


@dataclasses.dataclass(frozen=True)
class _MetaRank:
    rank: int
    nranks: int
    pool: None = None
    groups: dict = dataclasses.field(default_factory=_NoGroups)


def make_meta_mesh(sizes, rank: int = 0, topology=None) -> dict:
    """Rank ``rank``'s mesh of the rank-major shape ``sizes`` (an
    axis-size dict in mesh order, or ``((axis, size), ...)``), as
    :func:`make_host_mesh` builds it (joint data groups and a grouped
    level's rank groups included) but with no process group and no pool
    on any level: what a trace on the meta device runs its collectives
    over (``core.mesh_collectives`` moves nothing for meta tensors)."""
    shape = tuple(sizes.items()) if isinstance(sizes, dict) \
        else tuple(sizes)
    return make_host_mesh(shape, _MetaRank(rank, _nranks(shape)),
                          pools=False, topology=topology)


def make_placed_mesh(placement, mix, topology) -> tuple:
    """Apply a placement: install the axis aliases of its split axes
    (``models.sharding.set_axis_aliases``) and the placed (relabeled)
    topology as the process-wide active one, and return the mesh shape
    it chose, ``((axis, size), ...)`` outermost first (rank-major, as
    :func:`mesh_shape`)."""
    from repro_torch.core.topology import set_active_topology
    from repro_torch.models import sharding
    from repro_torch.tuner.placement import mesh_spec, placed_topology
    sizes, names, aliases = mesh_spec(placement, mix, topology)
    sharding.set_axis_aliases(aliases)
    set_active_topology(placed_topology(placement, topology))
    return tuple(zip(names, sizes))


def dp_axes(mesh: dict) -> tuple:
    """The data-parallel axis spec of a mesh: the placement alias of
    ``data`` when one is installed, else hierarchical ``("pod",
    "data")`` when the pod axis exists, else ``("data",)``."""
    from repro_torch.models import sharding
    data = sharding.resolve_axis("data")
    if isinstance(data, tuple):
        return data
    return ("pod", "data") if "pod" in mesh else (data,)
