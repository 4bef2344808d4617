"""Parallel context: how a model invocation is sharded.

All model code takes a ``ParallelContext``.  Every collective goes
through its ``Communicator`` (``core.api``), so ``ring`` vs ``cxl`` is a
launch flag, never a model change.  The data-parallel (FSDP) operations
are ported; a context with ``tp > 1`` raises until tensor parallelism is
ported (ROADMAP queue 1, item 3), so the tensor-parallel collectives
below are the identity.
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

    def __post_init__(self):
        if self.tp != 1 or self.tp_axis is not None:
            raise NotImplementedError(
                "tensor parallelism (tp > 1) is not ported yet (ROADMAP "
                "queue 1, item 3)")

    def tp_all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def tp_psum_max(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def tp_index(self) -> int:
        return 0

    def dp_all_reduce_mean(self, x: torch.Tensor) -> torch.Tensor:
        if self.dp_axis is None:
            return x
        total = self.comm.all_reduce(x, self.dp_axis)
        return total / self.comm.axis_size(self.dp_axis)


UNSHARDED = ParallelContext()
