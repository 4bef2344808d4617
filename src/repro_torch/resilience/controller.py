"""The closed loop: detect -> re-plan -> resume, without an operator.

``ResilienceController`` owns one ``FailureMonitor`` and drives the
whole recovery path from inside a step loop:

1. each step the loop forwards its timing samples and pulses the
   heartbeats (``step``);
2. when the monitor confirms an *actionable* failure - a rank death,
   or a cxl link degraded past ``failover_patience`` - the controller
   calls ``resilience.replan`` over the active topology, applies the
   ``RecoveryPlan`` (epoch-versioned hot-swap + topology activation),
   and hands the plan back so the launcher can re-trace its step,
   rebuild its mesh over the survivors, and roll state back to the
   newest pool-resident snapshot;
3. a later ``link_recovered`` on a failed-over level triggers a
   re-plan *back* onto the original topology (the pool won its level
   back), closing the transient-degrade loop without a restart.

Steps-lost accounting: the controller stamps each recovery with the
confirmation step and the restored snapshot step; ``steps_lost`` for
a rank death is (confirm - snapshot) rollback plus the detection
latency the monitor's timeout/patience impose - the quantity
``benchmarks/resilience.py`` commits bounds on.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.topology import Topology, get_active_topology
from repro_torch.resilience.monitor import Failure, FailureMonitor
from repro_torch.resilience.replan import RecoveryPlan, replan
from repro_torch.tuner.placement import CollectiveMix
from repro_torch.tuner.sweep import TuneGrid


class ResilienceController:
    """Detect/re-plan/resume policy around a ``FailureMonitor``."""

    def __init__(self, monitor: FailureMonitor, *,
                 topology: Optional[Topology] = None,
                 mix: Optional[CollectiveMix] = None,
                 grid: Optional[TuneGrid] = None,
                 unsplit: tuple = (),
                 axis_sizes: Optional[dict] = None,
                 auto_apply: bool = True,
                 on_replan: Optional[Callable[[RecoveryPlan], None]]
                 = None,
                 log: Callable[[str], None] = print):
        self.monitor = monitor
        self._topology = topology
        self.original_topology = (topology if topology is not None
                                  else get_active_topology())
        self.mix = mix
        self.grid = grid
        self.unsplit = tuple(unsplit)
        self.axis_sizes = dict(axis_sizes or {})
        self.auto_apply = auto_apply
        self.on_replan = on_replan
        self.log = log
        self.recoveries: list = []          # applied RecoveryPlans
        self.failed_over: set = set()       # links currently on IB
        self.replans = 0

    @property
    def topology(self) -> Optional[Topology]:
        return (self._topology if self._topology is not None
                else get_active_topology())

    # -- the per-step hook ------------------------------------------------
    def step(self, step: int, timings: Optional[list] = None, *,
             pulse: bool = True) -> Optional[RecoveryPlan]:
        """Run one detection round; returns the applied
        ``RecoveryPlan`` when this step confirmed something
        actionable, else None."""
        if pulse:
            self.monitor.pulse_all(step)
        failures = self.monitor.end_step(step, timings=timings)
        if not failures:
            return None
        actionable = []
        recovered = []
        topo = self.topology
        for f in failures:
            if f.kind == "rank_death":
                actionable.append(f)
            elif f.kind == "link_degraded" and topo is not None:
                axis = f.link.split("/", 1)[0]
                lv = topo.level_for(axis)
                if lv is not None and lv.fabric == "cxl":
                    actionable.append(f)
            elif f.kind == "link_recovered":
                recovered.append(f)
        if recovered and not actionable:
            rp = self._replan_back(step, recovered)
            if rp is not None:
                return rp
        if not actionable:
            for f in failures:
                self.log(f"[resilience] {f.describe()} (no re-plan)")
            return None
        return self._replan(step, actionable)

    # -- re-planning ------------------------------------------------------
    def _replan(self, step: int,
                failures: list) -> Optional[RecoveryPlan]:
        topo = self.topology
        if topo is None:
            self.log("[resilience] confirmed failure but no active "
                     "topology to re-plan; resume-only recovery")
            return None
        rp = replan(failures, topo, mix=self.mix, grid=self.grid,
                    link_penalties=self.monitor.link_penalties(),
                    unsplit=self.unsplit, axis_sizes=self.axis_sizes)
        self._finish(step, rp, failures)
        for f in failures:
            if f.kind == "link_degraded":
                self.failed_over.add(f.link)
        return rp

    def _replan_back(self, step: int,
                     recovered: list) -> Optional[RecoveryPlan]:
        """A recovered link whose level we failed over: re-plan onto
        the original topology - the pool wins its level back."""
        hits = [f for f in recovered if f.link in self.failed_over]
        if not hits or self.original_topology is None:
            return None
        from repro_torch.tuner.sweep import SMOKE_GRID, generate_plan
        topo = self.original_topology
        plan = generate_plan(self.grid if self.grid is not None
                             else SMOKE_GRID, topology=topo)
        rp = RecoveryPlan(
            topology=topo, plan=plan,
            reason="recovered: " + ", ".join(f.link for f in hits),
            failures=tuple(hits))
        self._finish(step, rp, hits)
        for f in hits:
            self.failed_over.discard(f.link)
        return rp

    def _finish(self, step: int, rp: RecoveryPlan,
                failures: list) -> None:
        self.replans += 1
        if self.auto_apply:
            rp.apply()
            if self._topology is not None:
                self._topology = rp.topology
        self.recoveries.append({"step": int(step), "plan": rp,
                                "failures": [f.describe()
                                             for f in failures]})
        self.log(f"[resilience] step {step}: {rp.describe()}")
        if self.on_replan is not None:
            self.on_replan(rp)

    # -- accounting -------------------------------------------------------
    def steps_lost(self, fault_step: int, confirm_step: int,
                   snapshot_step: Optional[int]) -> int:
        """Steps of training lost to one failure: detection latency
        (fault -> confirmation, inclusive) plus the rollback from the
        confirmation point to the newest committed snapshot."""
        detect = max(0, int(confirm_step) - int(fault_step) + 1)
        rollback = (max(0, int(confirm_step) - int(snapshot_step))
                    if snapshot_step is not None else 0)
        return detect + rollback

    def report(self) -> dict:
        return {"replans": self.replans,
                "failed_over": sorted(self.failed_over),
                "recoveries": [{"step": r["step"],
                                "reason": r["plan"].reason,
                                "failures": r["failures"]}
                               for r in self.recoveries],
                "monitor": self.monitor.report()}
