"""Failure detection: heartbeats + link health -> confirmed failures.

``FailureMonitor`` composes three raw signals into *confirmed*
``Failure`` events with explicit timeout/patience semantics:

* **Rank liveness** from pool-side heartbeats
  (``core.doorbell.HeartbeatRegion``): each live rank writes its step
  into its liveness word once per step; a rank whose word falls more
  than ``heartbeat_timeout`` steps behind is *suspect*, and stays so
  for ``patience`` further steps before the monitor confirms it dead
  (a rank that resumes pulsing in that window is re-admitted with no
  event).  Confirmed verdicts publish to
  ``tuner.runtime.set_rank_liveness`` - the planner-facing registry.
* **Link degradation** from the ``obs.health.HealthMonitor`` EWMAs
  (which carry their own warmup/threshold/patience): its
  degraded/recovered transitions pass through as failures, and
  ``persistent_links`` tells the re-planner which degrades have
  outlived ``failover_patience`` and warrant failover rather than
  waiting.
* **Pool errors**: ``record_pool_error`` counts ``PoolAccessError``s
  that survived retry; ``pool_error_patience`` consecutive erroring
  steps confirm a pool fault (isolated transients never do - the
  retry layer already absorbed their cost).

Copy of ``repro.resilience.monitor``.  The reference is one process and
``pulse_all`` beats for every rank; a run of rank processes gives every
rank's monitor a ``HeartbeatRegion`` over memory all the ranks map
(its ``mem``): each rank beats its own word
(``pulse``) and every monitor reads all of them, so every rank reaches
the same verdicts once the ranks' pool-error counts are summed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import pool as pool_mod
from repro_torch.core.doorbell import HeartbeatRegion
from repro_torch.obs.health import HealthMonitor
from repro_torch.tuner import runtime


@dataclasses.dataclass(frozen=True)
class Failure:
    """One confirmed failure (or recovery) verdict."""

    kind: str          # "rank_death" | "link_degraded" |
    #                    "link_recovered" | "pool_errors"
    step: int          # the step the verdict was confirmed at
    rank: Optional[int] = None
    link: Optional[str] = None
    detail: dict = dataclasses.field(default_factory=dict)

    def describe(self) -> str:
        what = (f"rank {self.rank}" if self.rank is not None
                else f"link {self.link}" if self.link is not None
                else "pool")
        return f"{self.kind}({what}) confirmed at step {self.step}"


class FailureMonitor:
    """Timeout/patience promotion of raw health signals to verdicts.

    Timeline for a rank that stops pulsing after step ``s``: it reads
    as *suspect* once ``step - last_beat > heartbeat_timeout`` and is
    confirmed dead ``patience`` steps later, i.e. at
    ``s + heartbeat_timeout + patience`` - tight enough to bound steps
    lost, loose enough that one dropped pulse (a transient pool fault)
    never kills a live rank.
    """

    def __init__(self, nranks: int, *, heartbeat_timeout: int = 1,
                 patience: int = 2, pool_error_patience: int = 3,
                 failover_patience: int = 2,
                 health: Optional[HealthMonitor] = None,
                 publish: bool = True, heartbeats=None):
        self.nranks = int(nranks)
        self.heartbeat_timeout = max(1, int(heartbeat_timeout))
        self.patience = max(1, int(patience))
        self.pool_error_patience = max(1, int(pool_error_patience))
        self.failover_patience = max(1, int(failover_patience))
        self.health = health if health is not None else HealthMonitor(
            publish=publish)
        self.publish = publish
        self.heartbeats = (heartbeats if heartbeats is not None
                           else HeartbeatRegion(self.nranks))
        self.confirmed_dead: set = set()
        self.pool_errors_step = 0           # errors recorded this step
        self._pool_error_streak = 0
        self._pool_confirmed = False
        self._published: dict = {}          # rank -> last liveness
        self.failures: list = []            # every verdict, in order

    # -- per-step inputs --------------------------------------------------
    def pulse_all(self, step: int) -> int:
        """Pulse every not-confirmed-dead rank's heartbeat (what the
        emulated step loop does on the ranks' behalf).  A pulse the
        fault hook rejects is simply lost - exactly a dead or faulted
        rank's behavior; a rejected pulse by a live rank also counts a
        pool error.  Returns the number of pulses that landed."""
        return sum(self.pulse(r, step) for r in range(self.nranks))

    def pulse(self, rank: int, step: int) -> bool:
        """One rank's own beat, skipped once it is confirmed dead; a
        rejected beat counts a pool error.  Returns whether the beat
        landed."""
        if rank in self.confirmed_dead:
            return False
        try:
            self.heartbeats.pulse(rank, step)
            return True
        except pool_mod.PoolAccessError:
            self.record_pool_error(step)
            return False

    def record_pool_error(self, step: int) -> None:
        """Count one pool access that failed past its retry budget."""
        del step
        self.pool_errors_step += 1

    def observe_timings(self, timings: list) -> None:
        self.health.observe_timings(timings)

    # -- the verdict ------------------------------------------------------
    def end_step(self, step: int, timings: Optional[list] = None
                 ) -> list:
        """Close the step: fold link-health samples, poll heartbeats,
        settle pool-error streaks.  Returns the ``Failure`` verdicts
        confirmed at this step."""
        out: list = []
        if timings:
            self.health.observe_timings(timings)
        for ev in self.health.end_step(step):
            kind = ("link_degraded" if ev["event"] == "degraded"
                    else "link_recovered")
            out.append(Failure(kind=kind, step=int(step),
                               link=ev["link"], detail=dict(ev)))

        # heartbeat staleness -> suspect -> confirmed dead
        for r in range(self.nranks):
            if r in self.confirmed_dead:
                continue
            behind = step - self.heartbeats.read(r)
            suspect_for = behind - self.heartbeat_timeout
            if suspect_for >= self.patience:
                self.confirmed_dead.add(r)
                out.append(Failure(
                    kind="rank_death", step=int(step), rank=r,
                    detail={"last_beat": self.heartbeats.read(r),
                            "behind_steps": behind}))
            if self.publish:
                # event-driven: the registry holds state, so only a
                # *changed* verdict (alive/suspect transition) is
                # republished - the per-step monitor cost stays flat
                # when everything is healthy
                state = (r not in self.confirmed_dead,
                         suspect_for > 0)
                if self._published.get(r) != state:
                    self._published[r] = state
                    runtime.set_rank_liveness(r, {
                        "alive": state[0],
                        "last_beat_step": self.heartbeats.read(r),
                        "suspect": state[1], "step": int(step)})

        # pool-error streaks: only sustained windows confirm
        if self.pool_errors_step > 0:
            self._pool_error_streak += 1
            if (self._pool_error_streak >= self.pool_error_patience
                    and not self._pool_confirmed):
                self._pool_confirmed = True
                out.append(Failure(
                    kind="pool_errors", step=int(step),
                    detail={"streak": self._pool_error_streak,
                            "errors": self.pool_errors_step}))
        else:
            self._pool_error_streak = 0
            self._pool_confirmed = False
        self.pool_errors_step = 0

        self.failures.extend(out)
        return out

    # -- promotion queries ------------------------------------------------
    def dead_ranks(self) -> list:
        return sorted(self.confirmed_dead)

    def persistent_links(self, step: int) -> list:
        """Degraded links that have outlived ``failover_patience`` -
        the ones a re-planner should fail over rather than wait out."""
        return self.health.persistent_links(step, self.failover_patience)

    def link_penalties(self) -> dict:
        """Measured slowdown multipliers for currently degraded links,
        shaped for ``tuner.placement.plan_placement(link_penalties=)``."""
        return {k: max(1.0, st.slowdown())
                for k, st in self.health.links.items() if st.degraded}

    def report(self) -> dict:
        return {"dead_ranks": self.dead_ranks(),
                "degraded_links": self.health.degraded_links(),
                "heartbeat_timeout": self.heartbeat_timeout,
                "patience": self.patience,
                "failures": [f.describe() for f in self.failures]}
