"""Communicator: the framework-facing API of the port's collectives.

Port of ``repro.core.api.Communicator``.  Every collective
of the training stack goes through it, so the backend is a launch flag:

* ``ring`` - the process group's built-in collectives (the baseline);
* ``cxl``  - the paper's schedules on the shared host pool
             (``core.mesh_collectives``, ``core.pool.SharedPool``), with
             the slicing factor and the faithful-vs-two-phase AllReduce
             both selectable;
* ``auto`` - per-call selection from an autotuning ``Plan``
             (``repro_torch.tuner``): each (primitive, message size, axis
             size) resolves to the predicted-fastest (backend,
             slicing_factor, allreduce_mode) of the plan's nearest cell,
             and the ledger records the decision taken.

An axis is named as in the reference (``"data"``); the communicator maps
the name to this rank's :class:`~repro_torch.core.mesh_collectives.
AxisGroup`.  An axis may also be a tuple of names (``("pod", "data")``),
outer level first (rank-major), which decomposes against the topology
(the ``topology`` field, else the process-wide active one, else the one
an ``auto`` plan embeds), as in the reference:

* AllReduce is a ReduceScatter down the inner levels, an AllReduce
  across the outer level on the 1/prod(inner) shard and an AllGather
  back out (``mesh_collectives.hierarchical_all_reduce``), under every
  backend when the topology covers the tuple, and under ``cxl`` /
  ``auto`` without one (untagged).  Under ``ring`` with no covering
  topology it is one ring AllReduce over all the tuple's ranks (the
  reference's fused ``psum``), booked once per level;
* AllGather runs the inner level first, ReduceScatter the outer first;
* Broadcast scatters in the root's inner group, broadcasts the pieces
  across the outer level and all-gathers them back (a per-level root
  chain when the payload does not divide); Reduce, Gather and Scatter
  recurse with per-level roots split from the flat rank-major root;
* every level resolves its own plan cell under ``auto`` and books its
  wire bytes against its own level and fabric;
* ``all_to_all``, ``send`` and ``recv`` stay single-axis.

Every call books its wire bytes in ``core.ledger`` with the reference's
convention.  PyTorch runs eagerly, so the ledger books each call as it
runs - backward collectives and remat replays included - where the
reference books at trace time and scales by trip counts.

The collectives that training differentiates are autograd functions
whose backward is the transposed collective: all_gather <->
reduce_scatter, all_reduce <-> all_reduce, all_to_all <-> all_to_all
(the MoE dispatch and combine) and send <-> recv (the pipeline's stage
handoff).  As under the reference's
``shard_map(check_vma=False)``, the transpose of a sum over ranks is a
sum over ranks, so a loss averaged with ``all_reduce(x) / n`` hands each
rank a cotangent of 1, and synced grads are the sum of the ranks' local
grads.

Under ``auto`` the plan comes from the Communicator's ``plan`` field,
else the process-wide active plan, else the cached default plan
(``tuner.runtime``).  Where the reference resolves once per call site at
trace time, the port resolves at every call (``Plan.lookup`` memoises
the answer), including backward collectives and remat replays, each at
its own message size.  A cell's ``fused`` flag only tags the ledger's
fused split, as in the reference; it never turns fused kernels on.  An
axis covered by a topology level (the active topology, else the plan's)
resolves against that level's cells, and the pool schedule never drives
an ``ib``/``ici`` level.

**Grouped (ragged) levels**: a topology level with a shape vector of
more than one group (``Level(shape=(3, 1))``) lives on one flat axis of
``sum(shape)`` ranks whose ``AxisGroup`` carries its groups
(``launch.mesh.make_host_mesh(..., topology=)``).  AllReduce,
ReduceScatter, AllGather and Gather over it run the grouped schedules of
``core.mesh_collectives`` (within-group work on this level's fabric, the
sub-root exchange on the parent level's, the fan-out back into each
group), a grouped level inside a tuple axis too.  Each phase resolves
its own cell under ``auto`` (``max(shape)`` ranks on the level,
``len(shape)`` on the parent) and books the reference's wire bytes on
its level.  The primitives the reference also runs flat on such an axis
(broadcast, reduce, scatter, all_to_all) run the flat schedule over all
its ranks and book one ``ledger.record_fallback`` event each.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Optional, Sequence, Union

import torch

from repro_torch.core import ledger
from repro_torch.core import mesh_collectives as mc
from repro_torch.core import topology as topo_mod
from repro_torch.tuner import runtime as tuner_runtime
from repro_torch.tuner.plan import Plan

AxisSpec = Union[str, Sequence[str]]

BACKENDS = ("ring", "cxl", "auto")


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _axes(axis: AxisSpec) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


@dataclasses.dataclass(frozen=True)
class Communicator:
    backend: str = "ring"
    slicing_factor: int = mc.DEFAULT_CHUNKS
    allreduce_mode: str = "two_phase"   # 'faithful' reproduces Sec. 5.2
    axes: Mapping[str, mc.AxisGroup] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)
    # Autotuning plan for backend='auto'; falls back to the process-wide
    # active plan (tuner.runtime) when None.
    plan: Optional[Plan] = dataclasses.field(
        default=None, compare=False, repr=False)
    # Cluster topology that tuple axes decompose against; falls back to
    # the process-wide active topology, then to the plan's embedded one.
    # Part of eq/hash, as in the reference: it changes which collectives
    # run, not only which plan cell resolves.
    topology: Optional[topo_mod.Topology] = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}")
        if self.allreduce_mode not in ("faithful", "two_phase"):
            raise ValueError("allreduce_mode: 'faithful' or 'two_phase'")
        if not isinstance(self.slicing_factor, int) or \
                isinstance(self.slicing_factor, bool) or \
                self.slicing_factor < 1:
            raise ValueError(
                f"slicing_factor must be an integer >= 1, got "
                f"{self.slicing_factor!r}")

    # -- axes --------------------------------------------------------------

    def axis(self, axis: AxisSpec) -> mc.AxisGroup:
        """The flat level ``axis`` names (a name or a 1-tuple)."""
        names = _axes(axis)
        if len(names) != 1:
            raise ValueError(f"axis {names} is a tuple: name one level")
        try:
            return self.axes[names[0]]
        except KeyError:
            raise ValueError(f"axis {names[0]!r} is not in this "
                             f"communicator's mesh {sorted(self.axes)}"
                             ) from None

    def levels(self, axis: AxisSpec) -> tuple:
        """The levels of ``axis``, outer first."""
        return tuple(self.axis(a) for a in _axes(axis))

    def axis_size(self, axis: AxisSpec) -> int:
        """Ranks along ``axis``: the product of a tuple's level sizes."""
        n = 1
        for ax in self.levels(axis):
            n *= ax.size
        return n

    def axis_index(self, axis: AxisSpec) -> int:
        """This rank's rank-major index along ``axis`` (outer level most
        significant)."""
        i = 0
        for ax in self.levels(axis):
            i = i * ax.size + ax.rank
        return i

    def _joint(self, levels: tuple) -> mc.AxisGroup:
        """One flat group of all the ranks of a tuple axis, for the fused
        ring AllReduce.  The mesh holds the group under the tuple of
        names; a tuple that spans every rank of the mesh is the default
        group."""
        names = tuple(ax.name for ax in levels)
        got = self.axes.get(names)
        if got is not None:
            return got
        size = 1
        for ax in levels:
            size *= ax.size
        world = 1
        for name, ax in self.axes.items():
            if isinstance(name, str):
                world *= ax.size
        if size != world:
            raise ValueError(
                f"tuple axis {names} spans {size} of {world} ranks and "
                f"the mesh holds no process group for it")
        return mc.AxisGroup("+".join(names), self.axis_index(names), size)

    # -- topology / plan resolution ---------------------------------------

    def _topo(self) -> Optional[topo_mod.Topology]:
        """The topology whose levels key the plan's cells and decompose
        tuple axes: the ``topology`` field, else the process-wide active
        one, else the plan's embedded one."""
        if self.topology is not None:
            return self.topology
        active = topo_mod.get_active_topology()
        if active is not None:
            return active
        if self.backend == "auto" and self.plan is not None:
            return self.plan.topology()
        return None

    def _level(self, name: str):
        """(topology, the Level of axis ``name``) or (topology or None,
        None)."""
        topo = self._topo()
        level = topo.level_for(name) if topo is not None else None
        return topo, level

    def _choice(self, primitive: str, msg_bytes: int,
                ax: Union[mc.AxisGroup, str],
                n: Optional[int] = None) -> tuple:
        """Resolve (backend, slicing_factor, allreduce_mode, overlap,
        fused) for one collective call at one level, as the reference's
        ``_choice`` does: ``ax`` is the level's ``AxisGroup`` (its name
        and size), or a level name and ``n`` its rank count (the parent
        level that carries a grouped level's sub-root exchange is no
        mesh axis; a grouped level's within-group phase runs at its
        largest group).
        ``overlap``: the plan tuned the cell against the compute it
        hides behind (the ledger books its bytes as hidden); ``fused``:
        the plan priced the cell with its epilogue in a fused kernel
        (the ledger's fused split)."""
        if self.backend != "auto":
            return (self.backend, self.slicing_factor,
                    self.allreduce_mode, False, False)
        name, n = (ax, n) if isinstance(ax, str) else (ax.name, ax.size)
        topo, level = self._level(name)
        plan, epoch = self.plan, None
        if plan is None:
            plan, epoch = tuner_runtime.get_active_plan_versioned()
            if plan is None:
                plan = tuner_runtime.ensure_default_plan(topology=topo)
                epoch = tuner_runtime.plan_epoch()
        lkey = topo.level_key(name) if level is not None else None
        ch = plan.lookup(primitive, msg_bytes, n, level=lkey)
        if ch is None:     # primitive absent from the plan: ring baseline
            backend, factor, mode, overlap, fz = (
                "ring", self.slicing_factor, self.allreduce_mode, False,
                False)
            pred = base = 0.0
        else:
            backend, factor, mode, overlap = (
                ch.backend, ch.slicing_factor, ch.allreduce_mode,
                ch.overlap)
            fz = bool(ch.fused)
            ms = (plan.meta.get("online") or {}).get("min_samples", 1)
            pred, base = ch.effective_time(ms), ch.baseline_time
        if level is not None and backend not in level.backends():
            backend = "ring"     # no pool schedule off the pool
        ledger.record_choice(
            primitive, msg_bytes, n, backend, factor, mode,
            overlap=overlap, fused=fz,
            level=name if level is not None else None,
            fabric=level.fabric if level is not None else None,
            predicted_time=pred, baseline_time=base, plan_epoch=epoch)
        return backend, factor, mode, overlap, fz

    def _rec(self, kind: str, wire: float, ax: Union[mc.AxisGroup, str],
             ov: bool, fz: bool = False) -> None:
        """Book ``wire`` bytes of ``kind`` at level ``ax`` (an
        ``AxisGroup`` or a level name)."""
        name = ax if isinstance(ax, str) else ax.name
        _, level = self._level(name)
        ledger.record(kind, wire, hidden=True if ov else None,
                      fused=True if fz else None,
                      level=name if level is not None else None,
                      fabric=level.fabric if level is not None else None)

    # -- grouped (ragged) levels --------------------------------------------

    def _grouped_level(self, ax: mc.AxisGroup):
        """The Level of ``ax`` when it declares more than one rank group
        (the irregular-topology case), else None."""
        _, lv = self._level(ax.name)
        return lv if lv is not None and lv.grouped else None

    def _fallback(self, primitive: str, ax: mc.AxisGroup) -> None:
        """Book the flat schedule of ``primitive`` on a grouped level."""
        lv = self._grouped_level(ax)
        if lv is not None:
            ledger.record_fallback(primitive, level=ax.name,
                                   fabric=lv.fabric)

    def _cross_axis(self, name: str) -> str:
        """The level whose fabric carries a grouped level's sub-root
        traffic: the parent level, or the level itself when outermost."""
        parent = self._topo().parent_of(name)
        return parent.axis if parent is not None else name

    def _ragged_choices(self, primitive: str, s: int, cross_bytes: int,
                        ax: mc.AxisGroup, shape: tuple) -> tuple:
        """The within-group cell (``max(shape)`` ranks on the level) and
        the sub-root cell (``len(shape)`` ranks on the parent), in the
        reference's order."""
        inner = self._choice(primitive, s, ax.name, max(shape))
        cross = self._choice(primitive, cross_bytes,
                             self._cross_axis(ax.name), len(shape))
        return inner, cross

    def _ar_ragged(self, x: torch.Tensor, ax: mc.AxisGroup,
                   level) -> torch.Tensor:
        shape, s = level.shape, _nbytes(x)
        max_g, n_g = max(shape), len(shape)
        pax = self._cross_axis(ax.name)
        (b_in, f_in, _, ov_in, _), (b_x, f_x, _, ov_x, _) = \
            self._ragged_choices("all_reduce", s, s, ax, shape)
        # the within-group sum reads every peer's buffer (s*(g-1) on this
        # level), the sub-root exchange rides the parent, the fan-out the
        # groups again
        self._rec("all_reduce", s * (max_g - 1), ax, ov_in)
        self._rec("all_reduce", s * (n_g - 1), pax, ov_x)
        self._rec("broadcast", float(s), ax, ov_in)
        return mc.ragged_all_reduce(x, ax, f_in, b_in, f_x, b_x)

    def _ag_ragged(self, x: torch.Tensor, ax: mc.AxisGroup,
                   level) -> torch.Tensor:
        shape, s = level.shape, _nbytes(x)
        max_g, n_g, n = max(shape), len(shape), sum(shape)
        pax = self._cross_axis(ax.name)
        (b_in, f_in, _, ov_in, fz), (b_x, f_x, _, ov_x, _) = \
            self._ragged_choices("all_gather", s, s * max_g, ax, shape)
        self._rec("all_gather", s * (max_g - 1), ax, ov_in, fz)
        self._rec("all_gather", s * n * (n_g - 1), pax, ov_x, fz)
        self._rec("broadcast", float(s * n), ax, ov_in)
        return mc.ragged_all_gather(x, ax, f_in, b_in, f_x, b_x)

    def _gather_ragged(self, x: torch.Tensor, ax: mc.AxisGroup, root: int,
                       level) -> torch.Tensor:
        shape, s = level.shape, _nbytes(x)
        max_g, n_g, n = max(shape), len(shape), sum(shape)
        pax = self._cross_axis(ax.name)
        (b_in, f_in, _, ov_in, _), (b_x, f_x, _, ov_x, _) = \
            self._ragged_choices("gather", s, s * max_g, ax, shape)
        self._rec("gather", s * (max_g - 1), ax, ov_in)
        self._rec("gather", s * n * (n_g - 1), pax, ov_x)
        return mc.ragged_gather(x, ax, root, f_in, b_in, f_x, b_x)

    def _rs_ragged(self, x: torch.Tensor, ax: mc.AxisGroup,
                   level) -> torch.Tensor:
        shape, s = level.shape, _nbytes(x)
        max_g, n_g = max(shape), len(shape)
        pax = self._cross_axis(ax.name)
        (b_in, f_in, _, ov_in, fz), (b_x, f_x, _, ov_x, _) = \
            self._ragged_choices("reduce_scatter", s, s, ax, shape)
        # the within-group sum of the whole buffer on this level, the
        # sub-root exchange completing every segment on the parent, the
        # fan-out back into the groups
        self._rec("reduce_scatter", s * (max_g - 1), ax, ov_in, fz)
        self._rec("reduce_scatter", s * (n_g - 1), pax, ov_x, fz)
        self._rec("broadcast", float(s), ax, ov_in)
        return mc.ragged_reduce_scatter(x, ax, f_in, b_in, f_x, b_x)

    def _ar_axis(self, x: torch.Tensor, ax: mc.AxisGroup) -> torch.Tensor:
        lv = self._grouped_level(ax)
        return self._ar_ragged(x, ax, lv) if lv is not None \
            else self._ar_level(x, ax)

    def _rs_axis(self, x: torch.Tensor, ax: mc.AxisGroup) -> torch.Tensor:
        lv = self._grouped_level(ax)
        return self._rs_ragged(x, ax, lv) if lv is not None \
            else self._rs_level(x, ax)

    def _ag_axis(self, x: torch.Tensor, ax: mc.AxisGroup) -> torch.Tensor:
        lv = self._grouped_level(ax)
        return self._ag_ragged(x, ax, lv) if lv is not None \
            else self._ag_level(x, ax)

    # -- per-level single-axis collectives --------------------------------

    def _ar_level(self, x: torch.Tensor, ax: mc.AxisGroup) -> torch.Tensor:
        n, s = ax.size, _nbytes(x)
        backend, factor, mode, ov, _ = self._choice("all_reduce", s, ax)
        wire = s * (n - 1) if mode == "faithful" and backend == "cxl" \
            else 2 * s * (n - 1) / n
        self._rec("all_reduce", wire, ax, ov)
        if backend == "ring":
            return mc.ring_all_reduce(x, ax)
        return mc.all_reduce(x, ax, mode=mode, n_chunks=factor)

    def _ag_level(self, x: torch.Tensor, ax: mc.AxisGroup) -> torch.Tensor:
        n, s = ax.size, _nbytes(x)
        backend, factor, _, ov, fz = self._choice("all_gather", s, ax)
        self._rec("all_gather", s * (n - 1), ax, ov, fz)
        if backend == "ring":
            return mc.ring_all_gather(x, ax)
        return mc.all_gather(x, ax, n_chunks=factor)

    def _rs_level(self, x: torch.Tensor, ax: mc.AxisGroup) -> torch.Tensor:
        n, s = ax.size, _nbytes(x)
        backend, factor, _, ov, fz = self._choice("reduce_scatter", s, ax)
        self._rec("reduce_scatter", s * (n - 1) / n, ax, ov, fz)
        if backend == "ring":
            return mc.ring_reduce_scatter(x, ax)
        return mc.reduce_scatter(x, ax, n_chunks=factor)

    def _broadcast_level(self, x: torch.Tensor, ax: mc.AxisGroup,
                         root: int) -> torch.Tensor:
        if ax.size == 1:
            return x
        self._fallback("broadcast", ax)
        s = _nbytes(x)
        backend, factor, _, ov, _ = self._choice("broadcast", s, ax)
        self._rec("broadcast", float(s), ax, ov)
        if backend == "ring":
            return mc.ring_broadcast(x, ax, root)
        return mc.broadcast(x, ax, root=root, n_chunks=factor)

    def _reduce_level(self, x: torch.Tensor, ax: mc.AxisGroup,
                      root: int) -> torch.Tensor:
        n = ax.size
        if n == 1:
            return x
        self._fallback("reduce", ax)
        s = _nbytes(x)
        backend, factor, _, ov, _ = self._choice("reduce", s, ax)
        self._rec("reduce", 2 * s * (n - 1) / n, ax, ov)
        if backend == "ring":
            return mc.ring_reduce(x, ax, root)
        return mc.reduce(x, ax, root=root, n_chunks=factor)

    def _gather_level(self, x: torch.Tensor, ax: mc.AxisGroup,
                      root: int) -> torch.Tensor:
        n = ax.size
        if n == 1:
            return x
        # only reached as the outer level of a tuple-axis gather on a
        # grouped level: a single-axis gather takes _gather_ragged
        self._fallback("gather", ax)
        s = _nbytes(x)
        backend, factor, _, ov, _ = self._choice("gather", s, ax)
        self._rec("gather", s * (n - 1), ax, ov)
        if backend == "ring":
            return mc.ring_gather(x, ax, root)
        return mc.gather(x, ax, root=root, n_chunks=factor)

    def _scatter_level(self, x: torch.Tensor, ax: mc.AxisGroup,
                       root: int) -> torch.Tensor:
        n = ax.size
        if n == 1:
            return x
        self._fallback("scatter", ax)
        s = _nbytes(x)
        backend, factor, _, ov, _ = self._choice("scatter", s, ax)
        # root pushes every segment but its own: s*(n-1)/n wire bytes
        self._rec("scatter", s * (n - 1) / n, ax, ov)
        if backend == "ring":
            return mc.ring_scatter(x, ax, root)
        return mc.scatter(x, ax, root=root, n_chunks=factor)

    # -- N->N primitives (the FSDP hot path), differentiable ---------------

    def all_reduce(self, x: torch.Tensor, axis: AxisSpec) -> torch.Tensor:
        return _AllReduce.apply(x, self, self.levels(axis))

    def all_gather(self, x: torch.Tensor, axis: AxisSpec) -> torch.Tensor:
        """Tiled gather along axis 0, rank-major over the (possibly
        tuple) axis: the outer level's index is most significant."""
        return _AllGather.apply(x, self, self.levels(axis))

    def reduce_scatter(self, x: torch.Tensor,
                       axis: AxisSpec) -> torch.Tensor:
        """Reduce-scatter along axis 0, the inverse layout of
        all_gather."""
        return _ReduceScatter.apply(x, self, self.levels(axis))

    def _all_reduce(self, x: torch.Tensor, levels: tuple) -> torch.Tensor:
        if len(levels) == 1:
            return self._ar_axis(x, levels[0])
        topo = self._topo()
        hier = topo is not None and topo.covers(
            [ax.name for ax in levels])
        if self.backend == "ring" and not hier:
            # one ring AllReduce over all the tuple's ranks (the
            # reference's single fused psum), booked per level
            s = _nbytes(x)
            for ax in levels:
                self._rec("all_reduce", 2 * s * (ax.size - 1) / ax.size,
                          ax, False)
            return mc.ring_all_reduce(x, self._joint(levels))
        # RS down the inner levels, AR across the outer level on the
        # shard, AG back out
        return mc.hierarchical_all_reduce(
            x, levels, rs_fn=self._rs_axis, ar_fn=self._ar_axis,
            ag_fn=self._ag_axis)

    def _all_gather(self, x: torch.Tensor, levels: tuple) -> torch.Tensor:
        # inner level first: the outer gather then stacks whole blocks of
        # the inner groups (rank-major), and the outer fabric carries
        # each byte once
        for ax in reversed(levels):
            x = self._ag_axis(x, ax)
        return x

    def _reduce_scatter(self, x: torch.Tensor,
                        levels: tuple) -> torch.Tensor:
        # outer level first, the inverse of the gather: the payload
        # shrinks by each level's size before the next fabric sees it
        for ax in levels:
            x = self._rs_axis(x, ax)
        return x

    # -- the other primitives ----------------------------------------------

    def all_to_all(self, x: torch.Tensor, axis: AxisSpec) -> torch.Tensor:
        """Segment p of the result is rank p's segment ``my_rank`` (equal
        segments along axis 0); differentiable, its own transpose."""
        if len(_axes(axis)) != 1:
            raise NotImplementedError("all_to_all is single-axis")
        return _AllToAll.apply(x, self, self.axis(axis))

    def _all_to_all(self, x: torch.Tensor, ax: mc.AxisGroup) -> torch.Tensor:
        self._fallback("all_to_all", ax)
        n, s = ax.size, _nbytes(x)
        backend, factor, _, ov, _ = self._choice("all_to_all", s, ax)
        self._rec("all_to_all", s * (n - 1) / n, ax, ov)
        if backend == "ring":
            return mc.ring_all_to_all(x, ax)
        return mc.all_to_all(x, ax, n_chunks=factor)

    def all_max(self, x: torch.Tensor, axis: AxisSpec) -> torch.Tensor:
        """Elementwise max over a single axis: the sequence-sharded
        decode's global softmax max, the reference's ``lax.pmax``, which
        is no ``Communicator`` call.  So it books nothing in the ledger
        and resolves no plan cell.  Under ``cxl``, and under ``auto``
        where the axis has a pool that its level may use, it runs the
        pool's exchange (``mesh_collectives.all_max``); otherwise the
        group's own MAX AllReduce.  Not differentiable (decode runs under
        ``no_grad``)."""
        if len(_axes(axis)) != 1:
            raise NotImplementedError("all_max is single-axis")
        ax = self.axis(axis)
        if ax.size == 1:
            return x
        if self._max_on_pool(ax):
            return mc.all_max(x, ax, n_chunks=self.slicing_factor)
        return mc.ring_all_max(x, ax)

    def _max_on_pool(self, ax: mc.AxisGroup) -> bool:
        if self.backend != "auto":
            return self.backend == "cxl"
        _, level = self._level(ax.name)
        return ax.pool is not None and (
            level is None or "cxl" in level.backends())

    def send(self, x: torch.Tensor, axis: AxisSpec, *,
             shift: int = 1) -> torch.Tensor:
        """Ring point-to-point handoff: every rank sends ``x`` to the
        rank ``shift`` ahead and returns the payload from the rank
        ``shift`` behind (cyclic); S wire bytes per rank.
        Differentiable: the cotangent goes back by :meth:`recv` (the
        reference's ``ppermute`` transposes to the inverse permute),
        booked in the ledger like the forward."""
        if len(_axes(axis)) != 1:
            raise NotImplementedError("send/recv are single-axis")
        ax = self.axis(axis)
        if ax.size == 1 or shift % ax.size == 0:
            return x
        return _Send.apply(x, self, ax, shift)

    def recv(self, x: torch.Tensor, axis: AxisSpec, *,
             shift: int = 1) -> torch.Tensor:
        """The reverse hop of :meth:`send`: every rank sends ``x`` to the
        rank ``shift`` behind and returns the payload from the rank
        ``shift`` ahead (the backward pass's gradient handoff: stage s
        pushes grads to s - 1)."""
        return self.send(x, axis, shift=-shift)

    def _send(self, x: torch.Tensor, ax: mc.AxisGroup,
              shift: int) -> torch.Tensor:
        s = _nbytes(x)
        backend, factor, _, ov, _ = self._choice("p2p", s, ax)
        self._rec("p2p", float(s), ax, ov)
        if backend == "ring":
            return mc.ring_p2p(x, ax, shift=shift)
        return mc.p2p_shift(x, ax, shift=shift, n_chunks=factor)

    # -- rooted primitives ------------------------------------------------
    # A tuple axis recurses with per-level roots split from the flat
    # rank-major ``root``, so only one level carries each byte across
    # the outer fabric.

    @staticmethod
    def _split_root(levels: tuple, root: int) -> tuple:
        """Split a flat rank-major root at the outer level: (inner
        levels, prod(inner sizes), outer root, inner root)."""
        rest = levels[1:]
        prod_rest = 1
        for ax in rest:
            prod_rest *= ax.size
        r_out, r_rest = divmod(root, prod_rest)
        return rest, prod_rest, r_out, r_rest

    def broadcast(self, x: torch.Tensor, axis: AxisSpec,
                  root: int = 0) -> torch.Tensor:
        return self._broadcast(x, self.levels(axis), root)

    def _broadcast(self, x: torch.Tensor, levels: tuple,
                   root: int) -> torch.Tensor:
        if len(levels) == 1:
            return self._broadcast_level(x, levels[0], root)
        rest, prod_rest, r_out, r_rest = self._split_root(levels, root)
        if x.dim() >= 1 and prod_rest > 1 and x.shape[0] % prod_rest == 0:
            # scatter in the root's inner group, broadcast the
            # 1/prod(inner) pieces across the outer level, all-gather in
            # every inner group: the outer level carries s/prod(inner)
            piece = self._scatter(x, rest, r_rest)
            piece = self._broadcast_level(piece, levels[0], r_out)
            return self._all_gather(piece, rest)
        # a payload that does not divide: per-level root chain, outer
        # level first
        out = self._broadcast_level(x, levels[0], r_out)
        return self._broadcast(out, rest, r_rest)

    def reduce(self, x: torch.Tensor, axis: AxisSpec,
               root: int = 0) -> torch.Tensor:
        return self._reduce(x, self.levels(axis), root)

    def _reduce(self, x: torch.Tensor, levels: tuple,
                root: int) -> torch.Tensor:
        if len(levels) == 1:
            return self._reduce_level(x, levels[0], root)
        rest, _, r_out, r_rest = self._split_root(levels, root)
        # reduce in each inner group first: only reduced partials cross
        # the outer level
        part = self._reduce(x, rest, r_rest)
        return self._reduce_level(part, levels[0], r_out)

    def gather(self, x: torch.Tensor, axis: AxisSpec,
               root: int = 0) -> torch.Tensor:
        return self._gather(x, self.levels(axis), root)

    def _gather(self, x: torch.Tensor, levels: tuple,
                root: int) -> torch.Tensor:
        if len(levels) == 1:
            lv = self._grouped_level(levels[0])
            if lv is not None:
                return self._gather_ragged(x, levels[0], root, lv)
            return self._gather_level(x, levels[0], root)
        rest, _, r_out, r_rest = self._split_root(levels, root)
        # each inner group's block at its local root, then whole blocks
        # across the outer level (rank-major)
        blk = self._gather(x, rest, r_rest)
        return self._gather_level(blk, levels[0], r_out)

    def scatter(self, x: torch.Tensor, axis: AxisSpec,
                root: int = 0) -> torch.Tensor:
        return self._scatter(x, self.levels(axis), root)

    def _scatter(self, x: torch.Tensor, levels: tuple,
                 root: int) -> torch.Tensor:
        if len(levels) == 1:
            return self._scatter_level(x, levels[0], root)
        rest, _, r_out, r_rest = self._split_root(levels, root)
        # the outer level moves whole inner-group blocks once; the inner
        # levels fan each block out
        blk = self._scatter_level(x, levels[0], r_out)
        return self._scatter(blk, rest, r_rest)


def make_communicator(backend: str = "ring", *, slicing_factor: int = 4,
                      allreduce_mode: str = "two_phase",
                      plan: Optional[Plan] = None,
                      topology: Optional[topo_mod.Topology] = None
                      ) -> Communicator:
    """The reference's factory.  Its Communicator has no axes: give it
    this rank's mesh (``launch.mesh``) with ``dataclasses.replace(comm,
    axes=mesh)`` before it runs a collective."""
    return Communicator(backend=backend, slicing_factor=slicing_factor,
                        allreduce_mode=allreduce_mode, plan=plan,
                        topology=topology)


@dataclasses.dataclass(frozen=True)
class TimedCommunicator(Communicator):
    """An ``auto`` Communicator that times every collective call it
    resolves (``train --timing-source profiler``, the port's live source
    of per-call samples for ``tuner.online`` and ``obs``).

    Each call of one level (the differentiated primitives' backward
    calls included) books one ``ledger.record_timing`` sample beside its
    one ``auto_choices`` audit entry, carrying that entry's resolved
    cell: primitive, message bytes, rank count, backend (after the
    ring fallback off a pool level), slicing factor, AllReduce mode,
    level and fabric, and the ambient ``calls`` stamp.  A call that
    resolves no cell (a rooted primitive on one rank) books none, so
    audit and samples stay 1:1.

    The sample is the host clock around the call between two device
    synchronisations.  Neither backend's call returns only once its
    result has landed: the ring path's copy back to the device
    (``.to(device)`` of a host tensor) and the pool path's reduction
    kernel (``chunked_reduce``) run on after the call returns, and both
    paths' first copy off the device waits for the compute queued before
    the call.  So the card is synchronised before the clock starts (the
    queued compute is not charged to the collective) and before it stops
    (the result has landed).  This class adds both; ``Communicator``'s
    call path is untouched.

    A grouped (ragged) level resolves two cells (the within-group and
    the sub-root exchange) inside one schedule that cannot be timed
    apart: such a call raises.
    """

    # the cells resolved since the current call started (a list object,
    # mutated in place: the dataclass is frozen)
    _cells: list = dataclasses.field(default_factory=list, compare=False,
                                     repr=False)

    def __post_init__(self):
        super().__post_init__()
        if self.backend != "auto":
            raise ValueError("TimedCommunicator times the calls of "
                             "backend='auto' (each against its plan cell)")

    def _choice(self, primitive: str, msg_bytes: int,
                ax: Union[mc.AxisGroup, str],
                n: Optional[int] = None) -> tuple:
        cell = super()._choice(primitive, msg_bytes, ax, n)
        name, n = (ax, n) if isinstance(ax, str) else (ax.name, ax.size)
        _, level = self._level(name)
        self._cells.append(dict(
            primitive=primitive, msg_bytes=int(msg_bytes), nranks=int(n),
            backend=cell[0], slicing_factor=int(cell[1]),
            allreduce_mode=cell[2],
            level=name if level is not None else None,
            fabric=level.fabric if level is not None else None))
        return cell

    def _timed(self, op, x: torch.Tensor, *args) -> torch.Tensor:
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        del self._cells[:]
        t0 = time.perf_counter()
        out = op(x, *args)
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        seconds = time.perf_counter() - t0
        cells = list(self._cells)
        del self._cells[:]
        if len(cells) > 1:
            raise RuntimeError(f"one timed call resolved {len(cells)} "
                               f"cells: {cells}")
        if cells:
            ledger.record_timing(seconds=seconds, **cells[0])
        return out

    def _ar_level(self, x, ax):
        return self._timed(super()._ar_level, x, ax)

    def _ag_level(self, x, ax):
        return self._timed(super()._ag_level, x, ax)

    def _rs_level(self, x, ax):
        return self._timed(super()._rs_level, x, ax)

    def _broadcast_level(self, x, ax, root):
        return self._timed(super()._broadcast_level, x, ax, root)

    def _reduce_level(self, x, ax, root):
        return self._timed(super()._reduce_level, x, ax, root)

    def _gather_level(self, x, ax, root):
        return self._timed(super()._gather_level, x, ax, root)

    def _scatter_level(self, x, ax, root):
        return self._timed(super()._scatter_level, x, ax, root)

    def _all_to_all(self, x, ax):
        return self._timed(super()._all_to_all, x, ax)

    def _send(self, x, ax, shift):
        return self._timed(super()._send, x, ax, shift)

    def _ragged(self, *_args):
        raise NotImplementedError(
            "per-call timing of a grouped (ragged) level: its schedule "
            "runs two plan cells in one region (ROADMAP queue 3)")

    _ar_ragged = _ag_ragged = _gather_ragged = _rs_ragged = _ragged


# ------------------------------------------------------------------------ #
# autograd: each differentiated collective's backward is its transpose
# ------------------------------------------------------------------------ #

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, levels):
        ctx.comm, ctx.levels = comm, levels
        return comm._all_reduce(x, levels)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._all_reduce(g.contiguous(), ctx.levels), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, levels):
        ctx.comm, ctx.levels = comm, levels
        return comm._all_gather(x, levels)

    @staticmethod
    def backward(ctx, g):
        return (ctx.comm._reduce_scatter(g.contiguous(), ctx.levels), None,
                None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, levels):
        ctx.comm, ctx.levels = comm, levels
        return comm._reduce_scatter(x, levels)

    @staticmethod
    def backward(ctx, g):
        return (ctx.comm._all_gather(g.contiguous(), ctx.levels), None,
                None)


class _AllToAll(torch.autograd.Function):
    """With equal segments the exchange is a permutation of blocks whose
    inverse is itself: rank q's segment p goes to rank p's segment q, so
    the cotangent of the result goes back by the same exchange."""

    @staticmethod
    def forward(ctx, x, comm, ax):
        ctx.comm, ctx.ax = comm, ax
        return comm._all_to_all(x, ax)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._all_to_all(g.contiguous(), ctx.ax), None, None


class _Send(torch.autograd.Function):
    """A cyclic shift's transpose is the shift the other way: the
    cotangent of the payload received from the rank ``shift`` behind
    goes back to it."""

    @staticmethod
    def forward(ctx, x, comm, ax, shift):
        ctx.comm, ctx.ax, ctx.shift = comm, ax, shift
        return comm._send(x, ax, shift)

    @staticmethod
    def backward(ctx, g):
        return (ctx.comm._send(g.contiguous(), ctx.ax, -ctx.shift), None,
                None, None)
