"""Span-based structured tracing + flight recorder.

``Tracer`` records a hierarchy of spans - step > phase > collective -
each tagged with the plan-cell identity of the work it covers (via the
``ledger.add_timing_hook`` bridge, every measured collective sample
lands in the trace with its primitive / backend / knobs / level /
fabric / plan-epoch args).  The hot path is deliberately cheap: an
event is a tuple appended to a Python list (no dict building, no
string formatting, no clock math beyond one ``perf_counter`` read per
span edge); all formatting is deferred to ``dump()``.  Framework-free
copy of ``repro.obs.trace``; the training launcher gathers every rank's
dump into one document at the end of a run (``obs.session.
merge_traces``, one Chrome ``pid`` a rank).

The **flight recorder** keeps only the last ``capacity_steps`` steps in
a ring buffer (``collections.deque(maxlen=...)``), so tracing can stay
on for a whole run at O(capacity) memory.  ``trigger(reason)`` marks an
anomaly (the health monitor calls it when a link degrades) and - when a
dump path is configured - snapshots the ring to disk immediately, so
the trace that *led up to* the anomaly survives even if the run dies.

``dump()`` writes the standard Chrome trace-event JSON (``ph: "X"``
complete events), loadable in Perfetto / ``chrome://tracing``: steps
and phases nest on one track by timestamp containment, measured
collectives render on a second track.
"""
from __future__ import annotations

import collections
import contextlib
import json
import time

from repro_torch.core import ledger

# Event tuples (hot path; formatted only at dump time):
#   ("X", kind, name, t0, dur, tags)   span (step/phase/...)
#   ("i", kind, name, ts, tags)        instant marker
#   ("T", sample_dict, ts_end, step)   measured collective (ledger hook)
DEFAULT_CAPACITY = 32


class Tracer:
    """Structured tracer with a bounded step ring buffer."""

    def __init__(self, capacity_steps: int = DEFAULT_CAPACITY):
        self.capacity = max(1, int(capacity_steps))
        # Ring of (step_index, events): the flight recorder.
        self._steps = collections.deque(maxlen=self.capacity)
        self._events: list = []        # current step (or pre-step preamble)
        self._step_index = None
        self._t0 = time.perf_counter()
        self.enabled = False
        self.anomalies: list = []      # (ts, reason)
        self.dumps = 0

    # -- recording --------------------------------------------------------

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    @contextlib.contextmanager
    def step(self, index: int):
        """One training/serving step: the ring-buffer unit."""
        if not self.enabled:
            yield
            return
        prev_events, prev_index = self._events, self._step_index
        self._events, self._step_index = [], int(index)
        t0 = self._now()
        try:
            yield
        finally:
            dur = self._now() - t0
            events = self._events
            events.insert(0, ("X", "step", f"step {index}", t0, dur,
                              (("step", int(index)),)))
            self._steps.append((int(index), events))
            self._events, self._step_index = prev_events, prev_index

    @contextlib.contextmanager
    def span(self, name: str, kind: str = "phase", **tags):
        """A named sub-region of the current step (phase, retune, ...)."""
        if not self.enabled:
            yield
            return
        t0 = self._now()
        try:
            yield
        finally:
            self._events.append(("X", kind, name, t0, self._now() - t0,
                                 tuple(tags.items())))

    def instant(self, name: str, kind: str = "mark", **tags) -> None:
        if self.enabled:
            self._events.append(("i", kind, name, self._now(),
                                 tuple(tags.items())))

    def record_collective(self, sample: dict) -> None:
        """Ledger timing hook: one measured collective sample.  The dict
        is stored by reference; formatting waits for ``dump()``."""
        if self.enabled:
            self._events.append(("T", sample, self._now(),
                                 self._step_index))

    # -- anomaly / dump ---------------------------------------------------

    def trigger(self, reason: str, path: "str | None" = None) -> None:
        """Mark an anomaly; dump the flight recorder now if ``path``."""
        self.anomalies.append((self._now(), str(reason)))
        self.instant(f"anomaly: {reason}", kind="anomaly")
        if path:
            self.dump(path)

    def _format(self, events, out: list) -> None:
        for ev in events:
            if ev[0] == "X":
                _, kind, name, t0, dur, tags = ev
                out.append({"name": name, "cat": kind, "ph": "X",
                            "ts": t0 * 1e6, "dur": dur * 1e6,
                            "pid": 0, "tid": 0, "args": dict(tags)})
            elif ev[0] == "i":
                _, kind, name, ts, tags = ev
                out.append({"name": name, "cat": kind, "ph": "i",
                            "ts": ts * 1e6, "s": "p",
                            "pid": 0, "tid": 0, "args": dict(tags)})
            else:                       # ("T", sample, ts_end, step)
                _, t, ts_end, step = ev
                dur = float(t["seconds"])
                args = {k: v for k, v in t.items() if v is not None}
                if step is not None:
                    args.setdefault("step", step)
                lvl = t.get("level")
                name = f"{t['primitive']}@{t['backend']}" + (
                    f" [{lvl}]" if lvl else "")
                # Measured duration, anchored so the slice *ends* at the
                # moment the sample was booked.  Emulated times may
                # exceed real wall gaps; the collectives track is a
                # per-sample timeline, not a wall-clock gantt.
                out.append({"name": name, "cat": "collective", "ph": "X",
                            "ts": max(0.0, ts_end - dur) * 1e6,
                            "dur": dur * 1e6,
                            "pid": 0, "tid": 1, "args": args})

    def dump(self, path: "str | None" = None) -> dict:
        """Render the flight recorder (ring + in-flight step) as a
        Chrome trace-event document; write JSON to ``path`` if given."""
        events: list = [
            {"name": "process_name", "ph": "M", "pid": 0,
             "args": {"name": "repro"}},
            {"name": "thread_name", "ph": "M", "pid": 0, "tid": 0,
             "args": {"name": "steps/phases"}},
            {"name": "thread_name", "ph": "M", "pid": 0, "tid": 1,
             "args": {"name": "collectives (measured)"}},
        ]
        for _idx, evs in self._steps:
            self._format(evs, events)
        if self._events:
            self._format(self._events, events)
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "metadata": {
                   "capacity_steps": self.capacity,
                   "steps_retained": [i for i, _ in self._steps],
                   "anomalies": [{"ts": ts, "reason": r}
                                 for ts, r in self.anomalies]}}
        if path:
            with open(path, "w") as f:
                json.dump(doc, f)
            self.dumps += 1
        return doc

    def steps_retained(self) -> list:
        return [i for i, _ in self._steps]


# -- module-level singleton (what launchers and the ledger hook use) -------

_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def enable_tracing(capacity_steps: int = DEFAULT_CAPACITY) -> Tracer:
    """Turn on the global tracer (fresh ring buffer) and bridge the
    ledger's timing stream into it."""
    global _TRACER
    ledger.remove_timing_hook(_TRACER.record_collective)
    _TRACER = Tracer(capacity_steps)
    _TRACER.enabled = True
    ledger.add_timing_hook(_TRACER.record_collective)
    return _TRACER


def disable_tracing() -> None:
    _TRACER.enabled = False
    ledger.remove_timing_hook(_TRACER.record_collective)
