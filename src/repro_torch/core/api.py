"""Communicator: the framework-facing API of the port's collectives.

Port of ``repro.core.api.Communicator`` for flat axes.  Every collective
of the training stack goes through it, so the backend is a launch flag:

* ``ring`` - the process group's built-in collectives (the baseline);
* ``cxl``  - the paper's schedules on the shared host pool
             (``core.mesh_collectives``, ``core.pool.SharedPool``), with
             the slicing factor and the faithful-vs-two-phase AllReduce
             both selectable.

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

Not ported yet: ``backend="auto"`` and plans (ROADMAP queue 1, item 5),
tuple (hierarchical) axes and ragged levels (items 5-6).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence, Union

import torch

from repro_torch.core import ledger
from repro_torch.core import mesh_collectives as mc

AxisSpec = Union[str, Sequence[str]]

BACKENDS = ("ring", "cxl")


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


@dataclasses.dataclass(frozen=True)
class Communicator:
    backend: str = "ring"
    slicing_factor: int = mc.DEFAULT_CHUNKS
    allreduce_mode: str = "two_phase"   # 'faithful' reproduces Sec. 5.2
    axes: Mapping[str, mc.AxisGroup] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        if self.backend == "auto":
            raise NotImplementedError(
                "backend='auto' (plans, the tuner) is not ported yet "
                "(ROADMAP queue 1, item 5)")
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
        faithful = self.allreduce_mode == "faithful" and self.backend == "cxl"
        ledger.record("all_reduce", s * (n - 1) if faithful
                  else 2 * s * (n - 1) / n)
        if self.backend == "ring":
            return mc.ring_all_reduce(x, ax)
        return mc.all_reduce(x, ax, mode=self.allreduce_mode,
                             n_chunks=self.slicing_factor)

    def _all_gather(self, x: torch.Tensor,
                    ax: mc.AxisGroup) -> torch.Tensor:
        n = ax.size
        ledger.record("all_gather", _nbytes(x) * (n - 1))
        if self.backend == "ring":
            return mc.ring_all_gather(x, ax)
        return mc.all_gather(x, ax, n_chunks=self.slicing_factor)

    def _reduce_scatter(self, x: torch.Tensor,
                        ax: mc.AxisGroup) -> torch.Tensor:
        n = ax.size
        ledger.record("reduce_scatter", _nbytes(x) * (n - 1) / n)
        if self.backend == "ring":
            return mc.ring_reduce_scatter(x, ax)
        return mc.reduce_scatter(x, ax, n_chunks=self.slicing_factor)

    # -- the other flat primitives -----------------------------------------

    def all_to_all(self, x: torch.Tensor, axis: AxisSpec) -> torch.Tensor:
        ax = self.axis(axis)
        n = ax.size
        ledger.record("all_to_all", _nbytes(x) * (n - 1) / n)
        if self.backend == "ring":
            return mc.ring_all_to_all(x, ax)
        return mc.all_to_all(x, ax, n_chunks=self.slicing_factor)

    def send(self, x: torch.Tensor, axis: AxisSpec, *,
             shift: int = 1) -> torch.Tensor:
        """Ring point-to-point handoff: every rank sends ``x`` to the
        rank ``shift`` ahead and returns the payload from the rank
        ``shift`` behind (cyclic); S wire bytes per rank."""
        ax = self.axis(axis)
        if ax.size == 1 or shift % ax.size == 0:
            return x
        ledger.record("p2p", float(_nbytes(x)))
        if self.backend == "ring":
            return mc.ring_p2p(x, ax, shift=shift)
        return mc.p2p_shift(x, ax, shift=shift,
                            n_chunks=self.slicing_factor)

    def broadcast(self, x: torch.Tensor, axis: AxisSpec,
                  root: int = 0) -> torch.Tensor:
        ax = self.axis(axis)
        if ax.size == 1:
            return x
        ledger.record("broadcast", float(_nbytes(x)))
        if self.backend == "ring":
            return mc.ring_broadcast(x, ax, root)
        return mc.broadcast(x, ax, root=root, n_chunks=self.slicing_factor)

    def reduce(self, x: torch.Tensor, axis: AxisSpec,
               root: int = 0) -> torch.Tensor:
        ax = self.axis(axis)
        n = ax.size
        if n == 1:
            return x
        ledger.record("reduce", 2 * _nbytes(x) * (n - 1) / n)
        if self.backend == "ring":
            return mc.ring_reduce(x, ax, root)
        return mc.reduce(x, ax, root=root, n_chunks=self.slicing_factor)

    def gather(self, x: torch.Tensor, axis: AxisSpec,
               root: int = 0) -> torch.Tensor:
        ax = self.axis(axis)
        n = ax.size
        if n == 1:
            return x
        ledger.record("gather", _nbytes(x) * (n - 1))
        if self.backend == "ring":
            return mc.ring_gather(x, ax, root)
        return mc.gather(x, ax, root=root, n_chunks=self.slicing_factor)

    def scatter(self, x: torch.Tensor, axis: AxisSpec,
                root: int = 0) -> torch.Tensor:
        ax = self.axis(axis)
        n = ax.size
        if n == 1:
            return x
        # root pushes every segment but its own: s*(n-1)/n wire bytes
        ledger.record("scatter", _nbytes(x) * (n - 1) / n)
        if self.backend == "ring":
            return mc.ring_scatter(x, ax, root)
        return mc.scatter(x, ax, root=root, n_chunks=self.slicing_factor)


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
