"""Metrics registry + export (counters / gauges / histograms).

A tiny dependency-free registry in the Prometheus data model: every
metric is a named family of labeled series, and the whole registry
exports as

* **JSON-lines** (``to_jsonl``): one sample per line,
  ``{"name", "type", "labels", "value"}`` (histograms expand into
  ``_bucket``/``_sum``/``_count`` samples, like the text format), the
  machine-readable artifact CI uploads; and
* **Prometheus text exposition format** (``to_prometheus``): what a
  node exporter / pushgateway sidecar would scrape.

``from_ledger`` populates the standard gauge set from a ledger
snapshot (wire bytes, exposed-vs-hidden split, per-(level, fabric)
attribution, launch counts) so every exported value reconciles with
``ledger.snapshot()`` by construction.  Framework-free copy of
``repro.obs.metrics``: the JSON-lines and Prometheus renderings are the
reference's, byte for byte.  Run-time series (step
wall times, measured collective seconds, retune swaps, plan-cell
regret, link health) are maintained by ``obs.ObsSession`` /
``obs.health.HealthMonitor``.

Metric names follow Prometheus conventions (``repro_`` prefix, unit
suffix).
"""
from __future__ import annotations

import json
import math

# Log-spaced wall-time buckets (seconds): collectives span ~1us..10s.
TIME_BUCKETS = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    parts = []
    for k, v in key:
        v = v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class Metric:
    """One metric family: a name plus labeled series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.series: dict = {}      # labels key -> value (or hist state)

    def value(self, **labels) -> float:
        return self.series.get(_labels_key(labels), 0.0)

    def samples(self) -> list:
        return [(self.name, key, v) for key, v in self.series.items()]


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0.0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = _labels_key(labels)
        self.series[key] = self.series.get(key, 0.0) + float(value)


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self.series[_labels_key(labels)] = float(value)

    def add(self, value: float, **labels) -> None:
        key = _labels_key(labels)
        self.series[key] = self.series.get(key, 0.0) + float(value)


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: tuple = TIME_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def observe(self, value: float, **labels) -> None:
        key = _labels_key(labels)
        st = self.series.get(key)
        if st is None:
            st = {"counts": [0] * (len(self.buckets) + 1),
                  "sum": 0.0, "count": 0}
            self.series[key] = st
        i = 0
        while i < len(self.buckets) and value > self.buckets[i]:
            i += 1
        st["counts"][i] += 1
        st["sum"] += float(value)
        st["count"] += 1

    def samples(self) -> list:
        out = []
        for key, st in self.series.items():
            cum = 0
            for le, n in zip(self.buckets + (math.inf,), st["counts"]):
                cum += n
                out.append((f"{self.name}_bucket",
                            key + (("le", _fmt_value(le)),), cum))
            out.append((f"{self.name}_sum", key, st["sum"]))
            out.append((f"{self.name}_count", key, st["count"]))
        return out


class MetricsRegistry:
    """Ordered collection of metric families; the export surface."""

    def __init__(self):
        self._metrics: dict = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name} already registered as "
                            f"{m.kind}, not {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = TIME_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def metrics(self) -> list:
        return list(self._metrics.values())

    def value(self, name: str, **labels) -> float:
        m = self._metrics.get(name)
        return 0.0 if m is None else m.value(**labels)

    # -- export -----------------------------------------------------------

    def to_jsonl(self) -> str:
        """One JSON object per line per sample (stable order): the
        CI-artifact form of the registry."""
        lines = []
        for m in self._metrics.values():
            for name, key, v in m.samples():
                lines.append(json.dumps(
                    {"name": name, "type": m.kind,
                     "labels": dict(key), "value": v},
                    sort_keys=True))
        return "\n".join(lines) + ("\n" if lines else "")

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        out = []
        for m in self._metrics.values():
            if m.help:
                out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            for name, key, v in m.samples():
                out.append(f"{name}{_fmt_labels(key)} {_fmt_value(v)}")
        return "\n".join(out) + ("\n" if out else "")


def from_ledger(registry: MetricsRegistry, snapshot: dict) -> None:
    """Populate the standard trace-time gauge set from a
    ``ledger.snapshot()``.  Gauges (not counters) because a snapshot is
    already a total: re-exporting after a re-trace must overwrite, not
    double-count.  Every value reconciles with the snapshot exactly."""
    wire = registry.gauge("repro_wire_bytes",
                          "per-step collective wire bytes per chip")
    for kind, b in snapshot.get("wire_bytes", {}).items():
        wire.set(b, kind=kind)
    exp = registry.gauge("repro_exposed_bytes",
                         "wire bytes not hidden behind compute")
    for kind, b in snapshot.get("exposed_bytes", {}).items():
        exp.set(b, kind=kind)
    hid = registry.gauge("repro_hidden_bytes",
                         "wire bytes overlap-hidden behind compute")
    for kind, b in snapshot.get("hidden_bytes", {}).items():
        hid.set(b, kind=kind)
    calls = registry.gauge("repro_collective_launches",
                           "collective launches per step (trip-count "
                           "scaled)")
    for kind, c in snapshot.get("collective_calls", {}).items():
        calls.set(c, kind=kind)
    lvl = registry.gauge("repro_level_wire_bytes",
                         "wire bytes attributed to the topology level "
                         "(fabric) that carries them")
    for lk, kinds in snapshot.get("level_wire_bytes", {}).items():
        level, _, fabric = lk.partition("/")
        for kind, b in kinds.items():
            lvl.set(b, level=level, fabric=fabric, kind=kind)


def observe_timings(registry: MetricsRegistry, timings: list) -> int:
    """Fold measured per-collective samples into the run-time series:
    the ``repro_collective_seconds`` histogram plus per-(level, fabric)
    busy-time counters.  Returns the number of samples folded."""
    hist = registry.histogram("repro_collective_seconds",
                              "measured per-collective wall time")
    busy = registry.counter("repro_level_busy_seconds_total",
                            "cumulative measured collective seconds "
                            "per (level, fabric)")
    n = 0
    for t in timings:
        hist.observe(t["seconds"], primitive=t["primitive"],
                     backend=t["backend"],
                     level=t.get("level") or "-")
        busy.inc(t["seconds"] * max(1.0, t.get("calls", 1.0)),
                 level=t.get("level") or "-",
                 fabric=t.get("fabric") or "-")
        n += 1
    return n
