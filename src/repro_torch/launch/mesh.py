"""The mesh of one rank: each named axis is an ``AxisGroup``.

Port of ``repro.launch.mesh`` for the one-host meshes the port runs:
``--mesh DPxTP`` with every rank a process of this host.  The ranks of a
one-card mesh share that card; the process group is ``gloo`` (NCCL
refuses two ranks on one card).  Tensor parallelism (TP > 1), the
production meshes and placements are not ported yet (ROADMAP queue 1,
items 3 and 6).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.mesh_collectives import AxisGroup
from repro_torch.core.pool import SharedPool


def parse_mesh(spec: str) -> tuple:
    """``"DPxTP"`` -> (dp, tp); TP > 1 raises."""
    try:
        dp, tp = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh wants DPxTP, e.g. 4x1, got {spec!r}"
                         ) from None
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh sizes must be >= 1, got {spec!r}")
    if tp > 1:
        raise NotImplementedError(
            f"--mesh {spec}: tensor parallelism (TP > 1) is not ported "
            f"yet (ROADMAP queue 1, item 3)")
    return dp, tp


def make_host_mesh(dp: int, rank: int,
                   pool: Optional[SharedPool] = None) -> dict:
    """This rank's mesh of ``dp`` data-parallel ranks (the default
    process group) and a size-1 model axis."""
    return {"data": AxisGroup("data", rank, dp, None, pool),
            "model": AxisGroup("model", 0, 1)}
