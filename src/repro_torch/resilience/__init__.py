"""Fault tolerance and elastic reconfiguration.

The recovery loop, end to end and operator-free:

* inject  — ``FaultPlan`` (seeded rank deaths / link degrades / pool
  errors) through the emulator degrade hooks and the ``core.pool``
  fault shim;
* detect  — ``FailureMonitor``: pool-side heartbeats + link-health
  EWMAs + pool-error streaks, promoted to confirmed ``Failure``s
  under explicit timeout/patience;
* re-plan — ``replan``/``survivor_topology``/``failover_topology``:
  ragged survivor shapes, cxl->ib level failover, placement re-ranked
  under measured link penalties, hot-swapped through the
  epoch-versioned registry;
* resume  — pool-resident checkpoints
  (``training.checkpoint.PoolCheckpointStore``) roll the survivors
  back warm; ``ResilienceController`` sequences all of it from inside
  a step loop.

See ``docs/RESILIENCE.md`` for the failure model and knobs.

Copy of ``repro.resilience`` for the port (``faults``, ``monitor``,
``replan``, ``controller``; what a run of rank processes adds is in
each module's notes), driven by ``launch.train --resilience /
--fault-plan / --pool-ckpt-interval``.
"""
from repro_torch.resilience.controller import ResilienceController
from repro_torch.resilience.faults import RANK_OPS, FaultEvent, FaultPlan
from repro_torch.resilience.monitor import Failure, FailureMonitor
from repro_torch.resilience.replan import (RecoveryPlan, failover_topology,
                                           health_penalties, mesh_plan,
                                           mesh_topology, replan,
                                           survivor_topology)

__all__ = [
    "FaultEvent",
    "FaultPlan",
    "RANK_OPS",
    "Failure",
    "FailureMonitor",
    "RecoveryPlan",
    "ResilienceController",
    "failover_topology",
    "health_penalties",
    "mesh_plan",
    "mesh_topology",
    "replan",
    "survivor_topology",
]
