"""One-stop observability wiring for the launchers.

``ObsSession`` bundles the three obs components behind the two CLI
flags every launcher exposes (``--metrics-out``, ``--trace-out``):

* a ``MetricsRegistry`` populated with run-time series (steps, step
  wall time, measured collective seconds, retune swaps, plan epoch,
  measured plan-cell regret) and, at ``finalize``, the trace-time
  ledger gauges;
* the flight-recorder tracer (enabled only when ``--trace-out`` is
  given - tracing off means zero hooks registered, zero overhead);
* a ``HealthMonitor`` whose degradation flags trigger an immediate
  flight-recorder dump, so the trace that led up to the anomaly is on
  disk even if the run dies next step.

Output layout: ``--metrics-out`` is a JSON-lines stream - one
``{"kind": "step"|"retune"|"health"|"metric"|"summary", ...}`` object
per line, written incrementally (step/retune/health events as they
happen, the full metric dump at finalize) - plus a Prometheus text
rendering of the final registry next to it (``<base>.prom``).
``--trace-out`` is a Chrome trace-event JSON openable in Perfetto.
``launch/report.py`` turns the JSON-lines file back into a human
step-time breakdown.

Framework-free copy of ``repro.obs.session``, with two arguments for
the training launcher, whose ranks are processes of their own and run a
session each: ``rank`` (only rank 0 writes the metrics stream, the
``.prom`` rendering and an anomaly's flight-recorder dump; every rank
keeps its registry and health monitor, fed the same samples) and
``gather`` (a callable that returns every rank's copy of its argument,
in rank order: at ``finalize`` the ranks' flight recorders are gathered
and rank 0 writes them as one trace, ``merge_traces``).  With the
defaults a session is the reference's.
"""
from __future__ import annotations

import contextlib
import json
import os

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.health import HealthMonitor


class ObsSession:
    """Launcher-facing facade over tracer + metrics + health monitor."""

    def __init__(self, *, metrics_out: "str | None" = None,
                 trace_out: "str | None" = None, trace_steps: int = 32,
                 health: bool = True, threshold: float = 2.0,
                 patience: int = 3, warmup_steps: int = 3,
                 log=print, rank: int = 0, gather=None):
        self.metrics_out = metrics_out
        self.trace_out = trace_out
        self.enabled = bool(metrics_out or trace_out)
        self.log = log or (lambda *_: None)
        self.rank = int(rank)
        self.gather = gather
        self.registry = obs_metrics.MetricsRegistry()
        if trace_out:
            self.tracer = obs_trace.enable_tracing(trace_steps)
        else:
            self.tracer = None
        self.monitor = HealthMonitor(
            registry=self.registry, threshold=threshold,
            patience=patience, warmup_steps=warmup_steps,
            on_degraded=self._on_health_event,
            on_recovered=self._on_health_event,
        ) if (self.enabled and health) else None
        self._jsonl = open(metrics_out, "w") \
            if metrics_out and self.rank == 0 else None
        self._finalized = False

    # -- tracing passthrough ---------------------------------------------

    def step_span(self, index: int):
        """Context manager bounding one step in the flight recorder."""
        if self.tracer is not None:
            return self.tracer.step(index)
        return contextlib.nullcontext()

    def span(self, name: str, **tags):
        if self.tracer is not None:
            return self.tracer.span(name, **tags)
        return contextlib.nullcontext()

    # -- event stream -----------------------------------------------------

    def _emit(self, obj: dict) -> None:
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(obj, sort_keys=True) + "\n")
            self._jsonl.flush()

    def on_step(self, index: int, wall_s: float,
                timings: "list | None" = None,
                extra: "dict | None" = None) -> list:
        """Book one finished step: counters/histograms, the health
        monitor's step boundary, and a JSON-lines event.  ``timings``
        is the step's measured per-collective samples (pass ``None``
        when the run has no run-time timing source).  Returns the
        health transition events fired by this step."""
        if not self.enabled:
            return []
        self.registry.counter("repro_steps_total",
                              "steps completed").inc()
        self.registry.histogram("repro_step_seconds",
                                "step wall time").observe(float(wall_s))
        self.registry.gauge("repro_last_step_seconds",
                            "most recent step wall time").set(
                                float(wall_s))
        events: list = []
        if timings:
            obs_metrics.observe_timings(self.registry, timings)
        if self.monitor is not None and timings is not None:
            events = self.monitor.observe_step(timings, index)
        self._emit({"kind": "step", "step": int(index),
                    "wall_s": float(wall_s),
                    "timing_samples": len(timings or ()),
                    **(extra or {})})
        return events

    def diag(self, source: str, msg: str) -> None:
        """Book a diagnostic line: counted in the registry, persisted
        as a ``kind: diag`` event (``launch/report.py`` surfaces them),
        and echoed through the session log - the structured replacement
        for a launcher's bare ``print``."""
        self.log(f"[{source}] {msg}")
        if not self.enabled:
            return
        self.registry.counter(
            "repro_diag_total",
            "diagnostic lines emitted").inc(source=source)
        self._emit({"kind": "diag", "source": source, "msg": msg})

    def on_retune(self, *, epoch: int, swapped: bool,
                  regret_s: "float | None" = None,
                  measured_cells: "int | None" = None) -> None:
        """Book a retune boundary (whether or not the plan swapped)."""
        if not self.enabled:
            return
        self.registry.gauge("repro_plan_epoch",
                            "active-plan registry epoch").set(int(epoch))
        if swapped:
            self.registry.counter("repro_retune_swaps_total",
                                  "hot plan swaps applied").inc()
        if regret_s is not None:
            self.registry.gauge(
                "repro_plan_cell_regret_seconds",
                "sum over measured cells of chosen-minus-best "
                "measured EWMA time").set(float(regret_s))
        ev = {"kind": "retune", "epoch": int(epoch),
              "swapped": bool(swapped)}
        if regret_s is not None:
            ev["regret_s"] = float(regret_s)
        if measured_cells is not None:
            ev["measured_cells"] = int(measured_cells)
        self._emit(ev)

    def _on_health_event(self, ev: dict) -> None:
        self._emit({"kind": "health", **ev})
        self.log(f"[obs] link {ev['link']} {ev['event']} at step "
                 f"{ev['step']} (slowdown {ev['slowdown']:.2f}x)")
        if ev["event"] == "degraded" and self.tracer is not None:
            # Snapshot the flight recorder NOW: the trace leading up to
            # the degradation must survive even if the run dies.
            self.tracer.trigger(f"link {ev['link']} degraded "
                                f"{ev['slowdown']:.2f}x",
                                self.trace_out if self.rank == 0 else None)

    # -- teardown ---------------------------------------------------------

    def finalize(self, snapshot: "dict | None" = None,
                 extra: "dict | None" = None) -> dict:
        """Flush everything: fold the ledger snapshot into the gauges,
        dump the metric samples (JSON-lines + ``.prom``) and the flight
        recorder, detach hooks.  Idempotent."""
        if self._finalized:
            return {}
        self._finalized = True
        if not self.enabled:
            return {}
        if snapshot is not None:
            obs_metrics.from_ledger(self.registry, snapshot)
        summary = {"kind": "summary",
                   "degraded_links": (self.monitor.degraded_links()
                                      if self.monitor else []),
                   **(extra or {})}
        self._emit(summary)
        for m in self.registry.metrics():
            for name, key, v in m.samples():
                self._emit({"kind": "metric", "name": name,
                            "type": m.kind, "labels": dict(key),
                            "value": v})
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
            prom = os.path.splitext(self.metrics_out)[0] + ".prom"
            with open(prom, "w") as f:
                f.write(self.registry.to_prometheus())
            self.log(f"[obs] metrics: {self.metrics_out} (+ {prom})")
        if self.tracer is not None:
            if self.gather is None:
                self.tracer.dump(self.trace_out)
            else:
                docs = self.gather(self.tracer.dump())
                if self.rank == 0:
                    with open(self.trace_out, "w") as f:
                        json.dump(merge_traces(docs), f)
            obs_trace.disable_tracing()
            self.log(f"[obs] flight recorder: {self.trace_out} "
                     f"(steps {self.tracer.steps_retained()!r}, "
                     f"open in Perfetto)")
        return summary


def merge_traces(docs: list) -> dict:
    """Every rank's flight-recorder document (``Tracer.dump``, in rank
    order) as one Chrome trace: rank r's events under ``pid`` r (its
    process named ``repro rank r``), the steps each rank retained
    (``steps_retained_by_rank``; ``steps_retained`` is rank 0's, what
    ``launch.report`` prints) and every rank's anomalies, each tagged
    with its rank."""
    events: list = []
    anomalies: list = []
    for r, doc in enumerate(docs):
        for ev in doc["traceEvents"]:
            ev = dict(ev, pid=r)
            if ev.get("ph") == "M" and ev["name"] == "process_name":
                ev["args"] = {"name": f"repro rank {r}"}
            events.append(ev)
        anomalies += [dict(a, rank=r)
                      for a in doc["metadata"]["anomalies"]]
    meta = docs[0]["metadata"]
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "metadata": {
                "capacity_steps": meta["capacity_steps"],
                "ranks": len(docs),
                "steps_retained": meta["steps_retained"],
                "steps_retained_by_rank": [d["metadata"]["steps_retained"]
                                           for d in docs],
                "anomalies": anomalies}}
