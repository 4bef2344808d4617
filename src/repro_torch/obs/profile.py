"""Per-collective timing: Chrome-trace parsing + emulator.

Framework-free copy of ``repro.obs.profile``.  The online tuner wants
*per-collective* measured times keyed to plan cells.  The port's
collectives are eager calls, so its live source times each call on the
host clock (``core.api.TimedCommunicator``, ``--timing-source
profiler``); this module keeps the reference's two other sources, each
turning its input into ledger timing samples carrying full plan-cell
identity:

* **Trace path** (``trace_timings`` / ``profiled_timings``): parse a
  Chrome trace-event JSON (plain or gzipped), keep the collective ops,
  and match them to the ``auto_choices`` audit by primitive in recorded
  order - choice k's ``calls`` launches are expected before choice
  k+1's, so events map onto the expanded schedule cyclically.
  ``collective-permute`` ops are surfaced but not matched: a pool
  schedule lowers one logical collective into a *chain* of permutes, so
  a 1:1 event->cell mapping does not exist for them.

* **Emulator path** (``StepEmulator``): a device-free stand-in that
  prices each audited choice with the cost oracle for its own topology
  level, applies configurable per-level degrade factors (a 4x-slow CXL
  link, a flaky IB stage) plus seeded multiplicative noise, and books
  the result through ``ledger.record_timing``.  This exercises the
  whole feedback loop - flight recorder, health monitor, calibration,
  retune - deterministically on machines with no accelerator.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import re

import numpy as np

from repro_torch.core import ledger
from repro_torch.tuner import costmodel

# XLA/HLO op-name fragments -> ledger primitive.  ``collective-permute``
# maps to None: recognized as collective time, but one logical cxl
# collective is a chain of permutes, so per-cell matching is undefined.
PRIM_PATTERNS = (
    (re.compile(r"all[-_]?reduce", re.I), "all_reduce"),
    (re.compile(r"reduce[-_]?scatter", re.I), "reduce_scatter"),
    (re.compile(r"all[-_]?gather", re.I), "all_gather"),
    (re.compile(r"all[-_]?to[-_]?all", re.I), "all_to_all"),
    (re.compile(r"collective[-_]?permute|ppermute", re.I), None),
)


def classify(name: str) -> "tuple[bool, str | None]":
    """``(is_collective, primitive-or-None)`` for one trace-event name."""
    for pat, prim in PRIM_PATTERNS:
        if pat.search(name):
            return True, prim
    return False, None


def load_trace(path: str) -> dict:
    """Load a Chrome trace-event document (``.json`` or ``.json.gz``)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    return doc if isinstance(doc, dict) else {"traceEvents": doc}


def collective_events(doc: dict) -> list:
    """Complete (``ph: X``) collective events, sorted by timestamp:
    ``{"name", "primitive", "ts_us", "dur_us"}``."""
    out = []
    for ev in doc.get("traceEvents", []):
        if not isinstance(ev, dict) or ev.get("ph") != "X":
            continue
        name = ev.get("name", "")
        is_coll, prim = classify(name)
        if not is_coll or float(ev.get("dur", 0.0)) <= 0.0:
            continue
        out.append({"name": name, "primitive": prim,
                    "ts_us": float(ev.get("ts", 0.0)),
                    "dur_us": float(ev.get("dur", 0.0))})
    out.sort(key=lambda e: e["ts_us"])
    return out


def _sample_from_choice(choice: dict, seconds: float,
                        calls: float = 1.0) -> dict:
    return {"primitive": choice["primitive"],
            "msg_bytes": int(choice["msg_bytes"]),
            "nranks": int(choice["nranks"]),
            "backend": choice["backend"],
            "slicing_factor": int(choice["slicing_factor"]),
            "allreduce_mode": choice["allreduce_mode"],
            "level": choice.get("level"),
            "fabric": choice.get("fabric"),
            "seconds": float(seconds), "calls": float(calls)}


def match_events(events: list, choices: list) -> list:
    """Assign profiler collective events to audited ``auto_choices`` and
    return ledger-shaped timing samples (one per matched event,
    ``calls=1.0`` since each event is one launch).

    Per primitive, the audit's call sites in recorded order - each
    expanded by its trip count - form the expected launch schedule; the
    primitive's events, in time order, walk that schedule cyclically
    (a profile may cover several steps).  Events whose primitive has no
    audited site (or is unmatchable, e.g. ``collective-permute``) are
    skipped.
    """
    sched: dict = {}
    for c in choices:
        sched.setdefault(c["primitive"], []).extend(
            [c] * max(1, int(round(c.get("calls", 1.0)))))
    cursor: dict = {p: 0 for p in sched}
    out = []
    for ev in events:
        prim = ev["primitive"]
        slots = sched.get(prim)
        if not slots:
            continue
        c = slots[cursor[prim] % len(slots)]
        cursor[prim] += 1
        out.append(_sample_from_choice(c, ev["dur_us"] * 1e-6))
    return out


def trace_timings(path: str, choices: list) -> list:
    """Parse one profiler trace file into matched timing samples."""
    return match_events(collective_events(load_trace(path)), choices)


def profiled_timings(logdir: str, choices: list, *,
                     book: bool = False) -> list:
    """Find the newest ``*.trace.json[.gz]`` under a
    ``jax.profiler.trace`` logdir and match it against the audit.
    Returns ``[]`` when no parseable trace exists (some jax builds only
    emit ``xplane.pb``) - the caller should fall back to step timing.
    When ``book`` is set, samples are also recorded into the ledger
    (feeding the flight recorder via the timing hook)."""
    paths = sorted(
        glob.glob(os.path.join(logdir, "**", "*.trace.json"),
                  recursive=True)
        + glob.glob(os.path.join(logdir, "**", "*.trace.json.gz"),
                    recursive=True),
        key=os.path.getmtime)
    if not paths:
        return []
    try:
        samples = trace_timings(paths[-1], choices)
    except (OSError, ValueError, KeyError):
        return []
    if book:
        for t in samples:
            ledger.record_timing(**t)
    return samples


class StepEmulator:
    """Device-free per-collective timing source.

    Prices every audited plan choice with the cost oracle for its own
    topology level, times a configurable per-level slowdown, times
    seeded multiplicative noise - i.e. "what a profiler would have
    measured on hardware that matches the oracle, except where we say
    it doesn't".  ``degrade`` keys are level axis names (``"node"``),
    fabric kinds (``"cxl"``), or ``"*"``; factors multiply.  A
    backend-qualified key (``"node@cxl"``, ``"cxl@cxl"``) hits only
    choices *executing* that backend on the level/fabric - the shape
    of a pool-side fault, which slows the pool transport but not the
    ring alternative riding the level's IB config.
    """

    def __init__(self, *, topology=None, noise_std: float = 0.0,
                 seed: int = 0, degrade: "dict | None" = None):
        self.topology = topology
        self.noise_std = float(noise_std)
        self._rng = np.random.default_rng(seed)
        self.degrade = dict(degrade or {})

    def set_degrade(self, key: str, factor: float) -> None:
        """Inject (or clear, with factor 1.0) a slowdown mid-run."""
        if factor == 1.0:
            self.degrade.pop(key, None)
        else:
            self.degrade[key] = float(factor)

    def _factor(self, level: "str | None", fabric: "str | None",
                backend: "str | None" = None) -> float:
        f = self.degrade.get("*", 1.0)
        if level is not None:
            f *= self.degrade.get(level, 1.0)
        if fabric is not None:
            f *= self.degrade.get(fabric, 1.0)
        if backend is not None:
            for base in (level, fabric):
                if base is not None:
                    f *= self.degrade.get(f"{base}@{backend}", 1.0)
        return f

    def time_choice(self, choice: dict) -> float:
        """Oracle time for one audited choice on its own level's fabric,
        degraded + noised."""
        axis = choice.get("level")
        lv = self.topology.level_for(axis) if (
            self.topology is not None and axis is not None) else None
        if choice["primitive"] == "p2p":
            # stage-handoff cells price through the dedicated p2p
            # oracles (the collective models don't know the primitive)
            if lv is not None:
                t = costmodel.predict_level_p2p_time(
                    lv, int(choice["msg_bytes"]),
                    backend=choice["backend"],
                    slicing_factor=int(choice["slicing_factor"]))
            else:
                t = costmodel.predict_p2p_time(
                    choice["backend"], int(choice["msg_bytes"]),
                    slicing_factor=int(choice["slicing_factor"]))
        elif lv is not None:
            t = costmodel.predict_level_time(
                lv, choice["primitive"], int(choice["nranks"]),
                int(choice["msg_bytes"]), backend=choice["backend"],
                slicing_factor=int(choice["slicing_factor"]),
                allreduce_mode=choice["allreduce_mode"])
        else:
            t = costmodel.predict_time(
                choice["backend"], choice["primitive"],
                int(choice["nranks"]), int(choice["msg_bytes"]),
                slicing_factor=int(choice["slicing_factor"]),
                allreduce_mode=choice["allreduce_mode"])
        t *= self._factor(axis, choice.get("fabric"),
                          choice.get("backend"))
        if self.noise_std > 0.0:
            t *= float(np.clip(self._rng.normal(1.0, self.noise_std),
                               0.5, 2.0))
        return t

    def step_timings(self, choices: list, *, book: bool = True) -> list:
        """One emulated step: a timing sample per audited choice,
        weighted by its trip count.  ``book`` records each sample into
        the ledger (default - that is what drives the flight recorder
        and any registered timing hooks)."""
        samples = [_sample_from_choice(c, self.time_choice(c),
                                       calls=c.get("calls", 1.0))
                   for c in choices]
        if book:
            for t in samples:
                ledger.record_timing(**t)
        return samples
