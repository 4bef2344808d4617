"""Parallel context: how a model invocation is sharded.

All model code takes a ``ParallelContext``.  The serving slice runs
unsharded (``UNSHARDED``, tp = 1), so every tensor-parallel collective
below is the identity.  A context with ``tp > 1`` raises until the
``Communicator`` is ported (ROADMAP queue 1, the collectives slice).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    tp_axis: Optional[str] = None                 # model/tensor parallel
    dp_axis: Optional[str] = None                 # data/FSDP axis
    tp: int = 1                                   # static tp size

    def __post_init__(self):
        if self.tp != 1 or self.tp_axis is not None \
                or self.dp_axis is not None:
            raise NotImplementedError(
                "sharded contexts need the Communicator, which is not "
                "ported yet (ROADMAP queue 1: collectives slice)")

    def tp_all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def tp_psum_max(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def tp_index(self) -> int:
        return 0


UNSHARDED = ParallelContext()
