"""Parallel context: how a model invocation is sharded.

All model code takes a ``ParallelContext``.  Every collective goes
through its ``Communicator`` (``core.api``), so ``ring`` vs ``cxl`` is a
launch flag, never a model change.  With ``tp_axis=None`` or ``tp = 1``
the tensor-parallel collectives are the identity; otherwise they run
over ``tp_axis`` (Megatron-style: column-parallel weights need no
collective, row-parallel partial products are summed with
``tp_all_reduce``).  Their autograd backward is the transposed
collective (``core.api``), as under the reference's
``shard_map(check_vma=False)``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core.api import Communicator


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    tp_axis: Optional[str] = None                 # model/tensor parallel
    # data/FSDP axis: a name, or a tuple of names outer level first
    dp_axis: Optional[Union[str, tuple]] = None
    tp: int = 1                                   # static tp size
    comm: Communicator = dataclasses.field(default_factory=Communicator)

    @property
    def tp_active(self) -> bool:
        return self.tp_axis is not None and self.tp > 1

    def tp_all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        if not self.tp_active:
            return x
        return self.comm.all_reduce(x, self.tp_axis)

    def tp_all_gather(self, x: torch.Tensor) -> torch.Tensor:
        if not self.tp_active:
            return x
        return self.comm.all_gather(x, self.tp_axis)

    def tp_all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        if not self.tp_active:
            return x
        return self.comm.all_to_all(x, self.tp_axis)

    def tp_psum_max(self, x: torch.Tensor) -> torch.Tensor:
        """The reference's ``pmax`` over tp, used only by the
        sequence-sharded decode: the axis group's max exchange on the
        Communicator's backend (``Communicator.all_max``), booked in no
        ledger, as the reference's ``lax.pmax`` books nothing."""
        if not self.tp_active:
            return x
        return self.comm.all_max(x, self.tp_axis)

    def tp_max(self, x: torch.Tensor) -> torch.Tensor:
        """Cross-shard max that stays differentiable, as the reference's:
        an all-gather of ``x`` stacked on a new leading dim, then a local
        max.  Payloads are tiny (per-token scalars)."""
        if not self.tp_active:
            return x
        return self.comm.all_gather(x[None], self.tp_axis).amax(dim=0)

    def tp_index(self) -> int:
        if not self.tp_active:
            return 0
        return self.comm.axis_index(self.tp_axis)

    def dp_all_reduce_mean(self, x: torch.Tensor) -> torch.Tensor:
        if self.dp_axis is None:
            return x
        total = self.comm.all_reduce(x, self.dp_axis)
        return total / self.comm.axis_size(self.dp_axis)


UNSHARDED = ParallelContext()
