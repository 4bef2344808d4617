"""Survivor re-planning: confirmed failures -> a hot-swappable plan.

Two topology surgeries, both pure functions of the current topology:

* ``survivor_topology`` removes confirmed-dead ranks from a level:
  the level's shape vector loses one slot per dead rank in the
  owning group (``(4, 4)`` minus rank 5 -> ``(4, 3)``), turning the
  level ragged - the grouped/ragged schedules execute such shapes
  natively, so the survivors keep the hierarchy instead of falling
  flat.
* ``failover_topology`` retires a dead CXL level onto its
  *alternative IB transport*: the level's fabric flips cxl -> ib
  carried by the very ``ib_cfg`` the tuner has been pricing cxl
  against all along (DFabric's hybrid-fabric move) - the pool is
  gone, the ranks are not.

``replan`` composes them from a failure list into a ``RecoveryPlan``:
survivor/failover topology + (optionally) a placement re-ranking under
the monitor's measured link penalties + a plan re-tuned for the new
topology, with ``apply()`` publishing through the epoch-versioned
registry - the same hot-swap path online re-tuning already uses, so
the next re-trace of the step picks everything up.  Rebuilding the
jax mesh itself stays with the launcher, which owns the devices.

Copy of ``repro.resilience.replan``, and two functions for a launcher
that keeps its ranks (``launch.train``), whose grouped levels have
process groups and pools built at spawn for the original shapes:
``mesh_topology`` is the recovery's topology at the shapes the running
mesh still has (a failover's fabric applies, a shrink does not), and
``mesh_plan`` serves the recovery plan's cells at that topology's
levels: each survivor level's cells keyed as the running level of the
same axis (a level key pins the shape, so the survivor level's own key
never matches a running level it shrank).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.topology import Level, Topology, set_active_topology
from repro_torch.tuner import runtime
from repro_torch.tuner.placement import (AxisTraffic, CollectiveMix,
                                         Placement, PlacementPlan,
                                         placed_topology, plan_placement)
from repro_torch.tuner.plan import Plan
from repro_torch.tuner.sweep import SMOKE_GRID, TuneGrid, generate_plan


def survivor_topology(topology: Topology, axis: str, dead_ranks,
                      *, size: Optional[int] = None) -> Topology:
    """Remove ``dead_ranks`` (flat indices on ``axis``) from the
    axis's level: the owning group of each dead rank shrinks by one in
    the shape vector; emptied groups drop out.  An undeclared-shape
    level needs ``size`` (the mesh axis degree) to seed the vector."""
    lv = topology.level_for(axis)
    if lv is None:
        raise KeyError(f"no level for axis {axis!r}")
    shape = lv.shape
    if shape is None:
        if size is None:
            raise ValueError(
                f"level {axis!r} declares no shape; pass size= (the "
                f"mesh axis degree) to derive the survivor vector")
        shape = (int(size),)
    total = sum(shape)
    dead = sorted(set(int(r) for r in dead_ranks))
    if any(r < 0 or r >= total for r in dead):
        raise ValueError(f"dead ranks {dead} out of range for level "
                         f"{axis!r} of {total} ranks")
    groups = list(shape)
    bounds = []
    acc = 0
    for g in groups:
        bounds.append((acc, acc + g))
        acc += g
    for r in dead:
        for gi, (lo, hi) in enumerate(bounds):
            if lo <= r < hi:
                groups[gi] -= 1
                break
    new_shape = tuple(g for g in groups if g > 0)
    if not new_shape:
        raise ValueError(f"no survivors on level {axis!r}")
    levels = tuple(dataclasses.replace(l, shape=new_shape)
                   if l.axis == lv.axis else l
                   for l in topology.levels)
    return Topology(levels=levels)


def failover_topology(topology: Topology, axis: str) -> Topology:
    """Retire ``axis``'s CXL level onto its alternative IB transport:
    same axis, same shape, fabric cxl -> ib carried by the level's own
    ``ib_cfg`` - the transport the tuner was already pricing the pool
    against."""
    lv = topology.level_for(axis)
    if lv is None:
        raise KeyError(f"no level for axis {axis!r}")
    if lv.fabric != "cxl":
        raise ValueError(
            f"level {axis!r} is {lv.fabric}; only a cxl level has an "
            f"IB alternative to fail over to")
    fo = Level(axis=lv.axis, fabric="ib", ib=lv.ib_cfg, shape=lv.shape)
    levels = tuple(fo if l.axis == lv.axis else l
                   for l in topology.levels)
    return Topology(levels=levels)


def health_penalties(link_health: Optional[dict] = None) -> dict:
    """Placement penalties from the runtime link-health registry (or
    an explicit registry copy): degraded links contribute their
    measured slowdown."""
    lh = (runtime.get_link_health() if link_health is None
          else link_health)
    return {k: max(1.0, float(v.get("slowdown", 1.0)))
            for k, v in lh.items() if v.get("degraded")}


@dataclasses.dataclass
class RecoveryPlan:
    """A re-plan ready to hot-swap: the post-failure topology, the
    re-tuned plan for it, and (when a collective mix was supplied) the
    placement re-ranking that chose it."""

    topology: Topology
    plan: Plan
    reason: str
    placement: Optional[PlacementPlan] = None
    chosen: Optional[Placement] = None
    failures: tuple = ()

    def apply(self) -> Plan:
        """Publish: activate the new topology and push the re-tuned
        plan through the epoch-versioned registry.  The caller
        re-traces its step (and rebuilds its mesh over the survivors)
        - identical mechanics to an online-retune hot-swap."""
        set_active_topology(self.topology)
        runtime.set_active_plan(self.plan)
        return self.plan

    def describe(self) -> str:
        lv = ", ".join(f"{l.axis}:{l.fabric}"
                       + (f":{'+'.join(map(str, l.shape))}"
                          if l.shape else "")
                       for l in self.topology.levels)
        return f"re-plan [{self.reason}] -> topology ({lv})"


def _axis_of_link(link: str, topology: Topology) -> Optional[str]:
    """Map a health-registry "axis/fabric" key back to its axis."""
    axis = link.split("/", 1)[0]
    return axis if topology.level_for(axis) is not None else None


def replan(failures, topology: Topology, *,
           mix: Optional[CollectiveMix] = None,
           grid: Optional[TuneGrid] = None,
           link_penalties: Optional[dict] = None,
           unsplit: tuple = (),
           axis_sizes: Optional[dict] = None) -> RecoveryPlan:
    """Derive the recovery from confirmed ``Failure``s.

    * every ``rank_death`` on a level shrinks that level's shape
      vector (``survivor_topology``; dead ranks are attributed to the
      innermost pool level unless the failure's detail names an axis);
    * every persistent ``link_degraded`` on a cxl level fails the
      level over to IB (``failover_topology``);
    * with a ``mix``, placement re-ranks axis->level over the new
      topology under the measured ``link_penalties``; the plan is then
      re-tuned (``generate_plan``) for the placed topology.

    Raises ``ValueError`` when the failures demand nothing (the caller
    gates on confirmed, actionable failures).
    """
    failures = tuple(failures)
    topo = topology
    reasons = []

    def _default_axis() -> Optional[str]:
        # dead ranks live on the innermost cxl (pool) level by
        # default: that is where heartbeat words live
        for lv in reversed(topo.levels):
            if lv.fabric == "cxl":
                return lv.axis
        return topo.levels[-1].axis if topo.levels else None

    dead_by_axis: dict = {}
    for f in failures:
        if f.kind == "rank_death":
            axis = f.detail.get("axis") or _default_axis()
            if axis is None:
                raise ValueError("rank death with no level to shrink")
            dead_by_axis.setdefault(axis, set()).add(f.rank)
        elif f.kind == "link_degraded":
            axis = _axis_of_link(f.link, topo)
            if axis is None:
                continue
            lv = topo.level_for(axis)
            if lv is not None and lv.fabric == "cxl":
                topo = failover_topology(topo, axis)
                reasons.append(f"failover {f.link} -> ib")
    shrunk: dict = {}                       # old size -> new size
    for axis, dead in sorted(dead_by_axis.items()):
        size = (axis_sizes or {}).get(axis)
        before = topo.level_for(axis).size or size
        topo = survivor_topology(topo, axis, dead, size=size)
        if before is not None:
            shrunk[int(before)] = topo.level_for(axis).size
        reasons.append(
            f"survivors on {axis}: -{sorted(dead)} -> "
            f"{'+'.join(map(str, topo.level_for(axis).shape))}")
    if not reasons:
        raise ValueError(
            "no actionable failure (rank_death or cxl link_degraded) "
            f"in {[f.kind for f in failures]}")

    placement = chosen = None
    if mix is not None:
        if shrunk:
            # the workload's logical axes shrink with their level: a
            # mix axis sized like a shrunk level carries the survivor
            # degree now (the launcher's mesh rebuild does the same)
            mix = CollectiveMix(axes=tuple(
                dataclasses.replace(a, size=shrunk[a.size])
                if a.size in shrunk else a for a in mix.axes))
        placement = plan_placement(mix, topo,
                                   link_penalties=link_penalties)
        chosen = (placement.best_with_unsplit(unsplit) if unsplit
                  else placement.best)
        topo = placed_topology(chosen, topo)
    plan = generate_plan(grid if grid is not None else SMOKE_GRID,
                         topology=topo)
    return RecoveryPlan(topology=topo, plan=plan,
                        reason="; ".join(reasons),
                        placement=placement, chosen=chosen,
                        failures=failures)


def mesh_topology(topology: Topology, running: Topology) -> Topology:
    """``topology`` (a recovery's) with every level that ``running``
    also has at ``running``'s shape: what the ranks' collectives still
    run over when the launcher keeps its mesh."""
    levels = []
    for lv in topology.levels:
        now = running.level_for(lv.axis)
        levels.append(lv if now is None
                      else dataclasses.replace(lv, shape=now.shape))
    return Topology(levels=tuple(levels))


def mesh_plan(plan: Plan, topology: Topology, running: Topology) -> Plan:
    """``plan`` (tuned for ``topology``) with each level's cells keyed
    as the level of the same axis in ``running``
    (``mesh_topology``'s), so lookups there resolve at the recovery
    plan's cells.  Its meta, the embedded topology included, is
    ``plan``'s."""
    keys = {topology.level_key(lv.axis): running.level_key(lv.axis)
            for lv in topology.levels
            if running.level_for(lv.axis) is not None}
    out = Plan(fingerprint=plan.fingerprint, meta=dict(plan.meta))
    for k, choice in plan.entries.items():
        if len(k) == 4:
            k = k[:3] + (keys.get(k[3], k[3]),)
        out.entries[k] = choice
    return out
