"""Link-health monitoring: EWMA baselines + persistent-outlier flags.

``HealthMonitor`` watches the measured per-collective timing stream
(the same samples the online tuner consumes) and maintains, per
(level axis, fabric) link, two EWMAs of the link's *per-step busy
seconds* (sum of measured seconds x trip count):

* a **slow baseline** (``alpha_slow``) - what this link normally
  costs per step;
* a **fast tracker** (``alpha_fast``) - what it costs right now.

A step is an outlier for a link when ``fast > threshold x baseline``;
``patience`` *consecutive* outlier steps flag the link degraded (one
noisy step never trips it), and the baseline is frozen while outlying
so a real degradation cannot launder itself into the new normal.
Recovery is symmetric: ``patience`` consecutive in-band steps clear
the flag.  Busy seconds rather than a measured/oracle ratio keeps the
detector independent of the cost model (and usable on samples whose
knobs - hence oracle - are unknown); the *calibration* scales in
``tuner.online`` are the oracle-anchored complement.

Flags propagate three ways: gauges in the metrics registry
(``repro_link_health`` / ``repro_link_slowdown_ratio``), the plan
registry (``tuner.runtime.set_link_health``) for planners and dry-run
reports, and an ``on_degraded`` callback that ``ObsSession`` wires to
the flight recorder's anomaly trigger.

Framework-free copy of ``repro.obs.health``.

``calibration_drift`` is the retune-boundary companion: it reads the
per-(backend, level) aggregate calibration scales persisted in plan
meta and recommends a placement re-plan when a fabric's measured/oracle
ratio has drifted past a threshold - the plan is then optimal for
hardware that no longer exists.
"""
from __future__ import annotations

import dataclasses

from repro_torch.tuner import runtime


@dataclasses.dataclass
class LinkState:
    """Health-tracking state for one (level axis, fabric) link."""

    baseline: float = 0.0      # slow EWMA of per-step busy seconds
    fast: float = 0.0          # fast EWMA of per-step busy seconds
    steps: int = 0             # steps with traffic on this link
    streak: int = 0            # consecutive outlier steps
    ok_streak: int = 0         # consecutive in-band steps (recovery)
    degraded: bool = False
    since_step: "int | None" = None

    def slowdown(self) -> float:
        return self.fast / self.baseline if self.baseline > 0.0 else 1.0

    def degraded_for(self, step: int) -> int:
        """Steps this link has been flagged degraded as of ``step``
        (0 when healthy) - the persistence signal the resilience layer
        uses to tell a transient wobble from a dead fabric."""
        if not self.degraded or self.since_step is None:
            return 0
        return max(0, int(step) - int(self.since_step) + 1)

    def report(self) -> dict:
        return {"degraded": self.degraded,
                "slowdown": round(self.slowdown(), 4),
                "baseline_busy_s": self.baseline,
                "fast_busy_s": self.fast,
                "steps": self.steps, "streak": self.streak,
                "since_step": self.since_step}


class HealthMonitor:
    """Per-(level, fabric) degradation detector over timing samples."""

    def __init__(self, *, alpha_fast: float = 0.5,
                 alpha_slow: float = 0.05, threshold: float = 2.0,
                 patience: int = 3, warmup_steps: int = 3,
                 min_busy_s: float = 1e-9, registry=None,
                 on_degraded=None, on_recovered=None,
                 publish: bool = True):
        self.alpha_fast = float(alpha_fast)
        self.alpha_slow = float(alpha_slow)
        self.threshold = float(threshold)
        self.patience = max(1, int(patience))
        self.warmup_steps = max(1, int(warmup_steps))
        self.min_busy_s = float(min_busy_s)    # ignore ~idle links
        self.registry = registry
        self.on_degraded = on_degraded
        self.on_recovered = on_recovered
        self.publish = publish
        self.links: dict = {}                  # "axis/fabric" -> LinkState
        self._step_busy: dict = {}             # accumulates within a step

    @staticmethod
    def _key(sample: dict) -> str:
        return f"{sample.get('level') or '-'}/{sample.get('fabric') or '-'}"

    def observe_timings(self, timings: list) -> None:
        """Accumulate measured samples into the current step's per-link
        busy seconds.  Call any number of times per step, then
        ``end_step``."""
        for t in timings:
            busy = float(t["seconds"]) * max(1.0, float(t.get("calls",
                                                               1.0)))
            k = self._key(t)
            self._step_busy[k] = self._step_busy.get(k, 0.0) + busy

    def end_step(self, step: int) -> list:
        """Close the step: fold busy totals into the EWMAs, update
        streaks, fire transitions.  Returns the transition events
        (``{"event": "degraded"|"recovered", "link": ..., ...}``)."""
        events = []
        for k, busy in self._step_busy.items():
            if busy < self.min_busy_s:
                continue
            st = self.links.setdefault(k, LinkState())
            st.steps += 1
            if st.steps == 1:
                st.fast = st.baseline = busy
            else:
                st.fast += self.alpha_fast * (busy - st.fast)
            outlier = (st.steps > self.warmup_steps
                       and st.fast > self.threshold * st.baseline)
            if not outlier:
                # Baseline learns only from in-band steps: a persistent
                # slowdown must keep reading as one, not become normal.
                st.baseline += self.alpha_slow * (busy - st.baseline)
            if st.steps <= self.warmup_steps:
                continue
            if outlier:
                st.streak += 1
                st.ok_streak = 0
                if not st.degraded and st.streak >= self.patience:
                    st.degraded = True
                    st.since_step = int(step) - self.patience + 1
                    events.append({"event": "degraded", "link": k,
                                   "step": int(step), **st.report()})
            else:
                st.streak = 0
                st.ok_streak += 1
                if st.degraded and st.ok_streak >= self.patience:
                    st.degraded = False
                    st.since_step = None
                    events.append({"event": "recovered", "link": k,
                                   "step": int(step), **st.report()})
        self._step_busy.clear()
        self._export(int(step))
        for ev in events:
            cb = (self.on_degraded if ev["event"] == "degraded"
                  else self.on_recovered)
            if cb is not None:
                cb(ev)
        return events

    def observe_step(self, timings: list, step: int) -> list:
        self.observe_timings(timings)
        return self.end_step(step)

    def _export(self, step: int) -> None:
        if self.registry is not None:
            healthy = self.registry.gauge(
                "repro_link_health",
                "1 = link within baseline, 0 = flagged degraded")
            ratio = self.registry.gauge(
                "repro_link_slowdown_ratio",
                "fast-EWMA busy seconds over slow baseline")
            for k, st in self.links.items():
                level, _, fabric = k.partition("/")
                healthy.set(0.0 if st.degraded else 1.0,
                            level=level, fabric=fabric)
                ratio.set(st.slowdown(), level=level, fabric=fabric)
        if self.publish:
            for k, st in self.links.items():
                runtime.set_link_health(k, {**st.report(),
                                            "step": step})

    def report(self) -> dict:
        return {k: st.report() for k, st in sorted(self.links.items())}

    def degraded_links(self) -> list:
        return sorted(k for k, st in self.links.items() if st.degraded)

    def link(self, key: str) -> "LinkState | None":
        """The tracked state for one "axis/fabric" link, if any."""
        return self.links.get(key)

    def persistent_links(self, step: int, min_steps: int) -> list:
        """Links degraded for at least ``min_steps`` consecutive steps
        as of ``step`` - the promotion threshold at which the
        resilience layer stops waiting for recovery and fails over."""
        return sorted(k for k, st in self.links.items()
                      if st.degraded_for(step) >= max(1, int(min_steps)))


def calibration_drift(calibration: dict, *,
                      threshold: float = 1.5) -> list:
    """Scan a plan's persisted calibration aggregate
    (``plan.calibration()["levels"]``) for (backend, level) fabrics
    whose measured/oracle scale has drifted by more than ``threshold``
    in either direction.  Each hit is a recommendation to re-check
    placement: the plan (and any placement derived from the oracle) was
    optimized for a fabric that measures differently now."""
    if threshold <= 1.0:
        raise ValueError("threshold must be > 1")
    out = []
    for e in (calibration or {}).get("levels", []):
        scale = float(e.get("scale", 1.0))
        if scale > threshold or (scale > 0 and scale < 1.0 / threshold):
            out.append({"backend": e.get("backend"),
                        "level": e.get("level"),
                        "scale": round(scale, 4),
                        "samples": e.get("samples", 0.0),
                        "recommendation": "re-run placement/tune for "
                                          "this fabric"})
    return out
