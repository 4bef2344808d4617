"""Run-time observability of the port: tracing, per-collective timing,
metrics and link health.

Framework-free copy of ``repro.obs``.  The ledger (``core.ledger``)
answers "what *should* this step cost"; this package watches what it
*does* cost and closes the loop:

* ``obs.trace``   - span tracer + flight recorder (Chrome trace JSON);
* ``obs.profile`` - parsers of a Chrome trace's collective events and
  the device-free ``StepEmulator``, keyed to plan cells (the port's live
  per-call samples come from ``core.api.TimedCommunicator``);
* ``obs.metrics`` - counters/gauges/histograms exported as JSON-lines
  and Prometheus text;
* ``obs.health``  - per-(level, fabric) EWMA baselines flagging
  persistently slow links into metrics + the plan registry;
* ``obs.session`` - ``ObsSession``, the launcher facade behind
  ``--metrics-out`` / ``--trace-out`` (one a rank in the training
  launcher: rank 0 writes the files, the trace holds every rank).

The metrics JSON-lines schema and the trace format are the reference's,
so ``launch.report`` of either package reads either's files.
"""
from repro_torch.obs.health import HealthMonitor, calibration_drift
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                               MetricsRegistry, from_ledger)
from repro_torch.obs.profile import StepEmulator, profiled_timings, trace_timings
from repro_torch.obs.session import ObsSession
from repro_torch.obs.trace import (Tracer, disable_tracing, enable_tracing,
                             get_tracer)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "from_ledger",
    "Tracer", "enable_tracing", "disable_tracing", "get_tracer",
    "StepEmulator", "profiled_timings", "trace_timings",
    "HealthMonitor", "calibration_drift",
    "ObsSession",
]
