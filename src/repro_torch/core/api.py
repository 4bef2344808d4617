"""Communicator: the framework-facing API of the port's collectives.

Port of ``repro.core.api.Communicator`` for flat axes.  Every collective
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
AxisGroup`.  Every call books its wire bytes in ``core.ledger`` with the
reference's convention.  PyTorch runs eagerly, so the ledger books each
call as it runs - backward collectives and remat replays included - where
the reference books at trace time and scales by trip counts.

The collectives that training differentiates are autograd functions
whose backward is the transposed collective: all_gather <->
reduce_scatter and all_reduce <-> all_reduce.  As under the reference's
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

Not ported yet: tuple (hierarchical) axes and ragged (grouped) levels
(ROADMAP queue 1, items 5-6).
"""
from __future__ import annotations

import dataclasses
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
        """The flat axis ``axis`` names (a name or a 1-tuple)."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        if len(names) != 1:
            raise NotImplementedError(
                f"tuple axis {names}: hierarchical collectives are not "
                f"ported yet (ROADMAP queue 1, items 5-6)")
        try:
            return self.axes[names[0]]
        except KeyError:
            raise ValueError(f"axis {names[0]!r} is not in this "
                             f"communicator's mesh {sorted(self.axes)}"
                             ) from None

    def axis_size(self, axis: AxisSpec) -> int:
        return self.axis(axis).size

    # -- topology / plan resolution ---------------------------------------

    def _topo(self) -> Optional[topo_mod.Topology]:
        """The topology whose levels key the plan's cells: the
        process-wide active one, else the plan's embedded one."""
        active = topo_mod.get_active_topology()
        if active is not None:
            return active
        if self.backend == "auto" and self.plan is not None:
            return self.plan.topology()
        return None

    def _level(self, ax: mc.AxisGroup):
        """(topology, the Level of ``ax``) or (topology or None, None)."""
        topo = self._topo()
        level = topo.level_for(ax.name) if topo is not None else None
        if level is not None and level.grouped:
            raise NotImplementedError(
                f"axis {ax.name!r} is a grouped (ragged) topology level: "
                f"the grouped schedules are not ported yet (ROADMAP queue "
                f"1, item 6)")
        return topo, level

    def _choice(self, primitive: str, msg_bytes: int,
                ax: mc.AxisGroup) -> tuple:
        """Resolve (backend, slicing_factor, allreduce_mode, overlap,
        fused) for one collective call over ``ax``, as the reference's
        ``_choice`` does for a flat axis.  ``overlap``: the plan tuned
        the cell against the compute it hides behind (the ledger books
        its bytes as hidden); ``fused``: the plan priced the cell with
        its epilogue in a fused kernel (the ledger's fused split)."""
        if self.backend != "auto":
            return (self.backend, self.slicing_factor,
                    self.allreduce_mode, False, False)
        topo, level = self._level(ax)
        plan, epoch = self.plan, None
        if plan is None:
            plan, epoch = tuner_runtime.get_active_plan_versioned()
            if plan is None:
                plan = tuner_runtime.ensure_default_plan(topology=topo)
                epoch = tuner_runtime.plan_epoch()
        lkey = topo.level_key(ax.name) if level is not None else None
        ch = plan.lookup(primitive, msg_bytes, ax.size, level=lkey)
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
            primitive, msg_bytes, ax.size, backend, factor, mode,
            overlap=overlap, fused=fz,
            level=ax.name if level is not None else None,
            fabric=level.fabric if level is not None else None,
            predicted_time=pred, baseline_time=base, plan_epoch=epoch)
        return backend, factor, mode, overlap, fz

    def _rec(self, kind: str, wire: float, ax: mc.AxisGroup, ov: bool,
             fz: bool = False) -> None:
        _, level = self._level(ax)
        ledger.record(kind, wire, hidden=True if ov else None,
                      fused=True if fz else None,
                      level=ax.name if level is not None else None,
                      fabric=level.fabric if level is not None else None)

    # -- N->N primitives (the FSDP hot path), differentiable ---------------

    def all_reduce(self, x: torch.Tensor, axis: AxisSpec) -> torch.Tensor:
        return _AllReduce.apply(x, self, self.axis(axis))

    def all_gather(self, x: torch.Tensor, axis: AxisSpec) -> torch.Tensor:
        """Tiled gather along axis 0, rank-major."""
        return _AllGather.apply(x, self, self.axis(axis))

    def reduce_scatter(self, x: torch.Tensor,
                       axis: AxisSpec) -> torch.Tensor:
        """Reduce-scatter along axis 0, the inverse layout of
        all_gather."""
        return _ReduceScatter.apply(x, self, self.axis(axis))

    def _all_reduce(self, x: torch.Tensor,
                    ax: mc.AxisGroup) -> torch.Tensor:
        n, s = ax.size, _nbytes(x)
        backend, factor, mode, ov, _ = self._choice("all_reduce", s, ax)
        wire = s * (n - 1) if mode == "faithful" and backend == "cxl" \
            else 2 * s * (n - 1) / n
        self._rec("all_reduce", wire, ax, ov)
        if backend == "ring":
            return mc.ring_all_reduce(x, ax)
        return mc.all_reduce(x, ax, mode=mode, n_chunks=factor)

    def _all_gather(self, x: torch.Tensor,
                    ax: mc.AxisGroup) -> torch.Tensor:
        n, s = ax.size, _nbytes(x)
        backend, factor, _, ov, fz = self._choice("all_gather", s, ax)
        self._rec("all_gather", s * (n - 1), ax, ov, fz)
        if backend == "ring":
            return mc.ring_all_gather(x, ax)
        return mc.all_gather(x, ax, n_chunks=factor)

    def _reduce_scatter(self, x: torch.Tensor,
                        ax: mc.AxisGroup) -> torch.Tensor:
        n, s = ax.size, _nbytes(x)
        backend, factor, _, ov, fz = self._choice("reduce_scatter", s, ax)
        self._rec("reduce_scatter", s * (n - 1) / n, ax, ov, fz)
        if backend == "ring":
            return mc.ring_reduce_scatter(x, ax)
        return mc.reduce_scatter(x, ax, n_chunks=factor)

    # -- the other flat primitives -----------------------------------------

    def all_to_all(self, x: torch.Tensor, axis: AxisSpec) -> torch.Tensor:
        ax = self.axis(axis)
        n, s = ax.size, _nbytes(x)
        backend, factor, _, ov, _ = self._choice("all_to_all", s, ax)
        self._rec("all_to_all", s * (n - 1) / n, ax, ov)
        if backend == "ring":
            return mc.ring_all_to_all(x, ax)
        return mc.all_to_all(x, ax, n_chunks=factor)

    def send(self, x: torch.Tensor, axis: AxisSpec, *,
             shift: int = 1) -> torch.Tensor:
        """Ring point-to-point handoff: every rank sends ``x`` to the
        rank ``shift`` ahead and returns the payload from the rank
        ``shift`` behind (cyclic); S wire bytes per rank."""
        ax = self.axis(axis)
        if ax.size == 1 or shift % ax.size == 0:
            return x
        s = _nbytes(x)
        backend, factor, _, ov, _ = self._choice("p2p", s, ax)
        self._rec("p2p", float(s), ax, ov)
        if backend == "ring":
            return mc.ring_p2p(x, ax, shift=shift)
        return mc.p2p_shift(x, ax, shift=shift, n_chunks=factor)

    def broadcast(self, x: torch.Tensor, axis: AxisSpec,
                  root: int = 0) -> torch.Tensor:
        ax = self.axis(axis)
        if ax.size == 1:
            return x
        s = _nbytes(x)
        backend, factor, _, ov, _ = self._choice("broadcast", s, ax)
        self._rec("broadcast", float(s), ax, ov)
        if backend == "ring":
            return mc.ring_broadcast(x, ax, root)
        return mc.broadcast(x, ax, root=root, n_chunks=factor)

    def reduce(self, x: torch.Tensor, axis: AxisSpec,
               root: int = 0) -> torch.Tensor:
        ax = self.axis(axis)
        n = ax.size
        if n == 1:
            return x
        s = _nbytes(x)
        backend, factor, _, ov, _ = self._choice("reduce", s, ax)
        self._rec("reduce", 2 * s * (n - 1) / n, ax, ov)
        if backend == "ring":
            return mc.ring_reduce(x, ax, root)
        return mc.reduce(x, ax, root=root, n_chunks=factor)

    def gather(self, x: torch.Tensor, axis: AxisSpec,
               root: int = 0) -> torch.Tensor:
        ax = self.axis(axis)
        n = ax.size
        if n == 1:
            return x
        s = _nbytes(x)
        backend, factor, _, ov, _ = self._choice("gather", s, ax)
        self._rec("gather", s * (n - 1), ax, ov)
        if backend == "ring":
            return mc.ring_gather(x, ax, root)
        return mc.gather(x, ax, root=root, n_chunks=factor)

    def scatter(self, x: torch.Tensor, axis: AxisSpec,
                root: int = 0) -> torch.Tensor:
        ax = self.axis(axis)
        n = ax.size
        if n == 1:
            return x
        s = _nbytes(x)
        backend, factor, _, ov, _ = self._choice("scatter", s, ax)
        # root pushes every segment but its own: s*(n-1)/n wire bytes
        self._rec("scatter", s * (n - 1) / n, ax, ov)
        if backend == "ring":
            return mc.ring_scatter(x, ax, root)
        return mc.scatter(x, ax, root=root, n_chunks=factor)


# ------------------------------------------------------------------------ #
# autograd: each differentiated collective's backward is its transpose
# ------------------------------------------------------------------------ #

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, ax):
        ctx.comm, ctx.ax = comm, ax
        return comm._all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._all_reduce(g.contiguous(), ctx.ax), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, ax):
        ctx.comm, ctx.ax = comm, ax
        return comm._all_gather(x, ax)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._reduce_scatter(g.contiguous(), ctx.ax), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, ax):
        ctx.comm, ctx.ax = comm, ax
        return comm._reduce_scatter(x, ax)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._all_gather(g.contiguous(), ctx.ax), None, None
