"""Trace-time collective-bytes ledger.

Framework-free copy of ``repro.core.ledger``.  PyTorch runs eagerly, so
in this package every ``record*`` call books at call time; the serving
slice uses ``record_choice`` / ``snapshot`` for its ``kv_block`` and
``kv_prefix`` placement audit.  The text below is the reference's.

XLA's ``cost_analysis``/HLO text count a ``lax.scan`` body ONCE, so any
per-layer or per-microbatch collective is undercounted by its trip count
in the compiled artifact.  The Communicator therefore records the wire
bytes of every collective *at trace time* (shapes are static), and the
model/trainer wrap scanned regions in ``ledger.scale(trip_count)`` so the
ledger accumulates the true per-step totals.  The dry-run snapshots the
ledger after ``.lower()`` (tracing is enough - nothing must execute).

Wire-byte convention (per chip, ring algorithms over an axis of size n,
local payload s bytes):
    all_gather      s * (n-1)
    reduce_scatter  s * (n-1) / n
    all_reduce      2 * s * (n-1) / n   (faithful mode: s * (n-1))
    all_to_all      s * (n-1) / n
    broadcast       s                    (pipelined forward)
    scatter         s * (n-1) / n        (root's outgoing segments)
    p2p             s                    (one full-payload ring hop:
                                          the pipeline stage handoff)

Overlap accounting: collectives issued inside a ``ledger.hidden()``
region (the double-buffered FSDP prefetch, or an ``auto`` plan cell
tuned as overlapped) book their bytes as *hidden* - expected to be
scheduled behind compute - while everything else books as *exposed*.
Orthogonally, a ``ledger.fused()`` region marks collectives whose
epilogue/prologue compute runs inside a fused kernel
(``kernels.fused_collectives``); those bytes additionally book into a
*fused* split so the hidden-vs-exposed totals can be decomposed by
fusion coverage.  Primitives that degrade to a hierarchy-blind flat
schedule on a ragged axis book an explicit ``record_fallback`` event -
degradations are audited, never silent.
``counts`` is the number of distinct collective call *sites*;
``collective_calls`` additionally multiplies by the ambient scale, i.e.
the true number of collectives launched per step.

Timing capture (online re-tuning): unlike everything above, wall times
are a *run-time* signal.  ``record_timing`` (or the ``timed`` context
manager around an eagerly dispatched collective) books one measured
sample tagged with the full plan-cell identity - primitive, message
size, nranks, the (backend, slicing_factor, allreduce_mode) actually
taken, and the topology level/fabric - and ``timing_cells`` aggregates
the samples per cell key so ``tuner.online`` can fold them back into
the plan as a measured cost.  Samples are stamped with the ambient
``scale()`` multiplier (``calls``, like ``record_choice``) so a timing
captured inside a scanned region is weighted by its true trip count
when folded into EWMAs; knobs the caller does not know stay ``None``
and aggregate under an explicit ``?`` key instead of polluting a real
candidate's mean.  ``add_timing_hook`` registers an observer (the
``repro.obs`` flight recorder) called once per sample.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

_BYTES: dict = defaultdict(float)
_EXPOSED: dict = defaultdict(float)
_HIDDEN: dict = defaultdict(float)
_FUSED: dict = defaultdict(float)   # bytes whose epilogue/prologue fused
_COUNTS: dict = defaultdict(int)
_CALLS: dict = defaultdict(float)   # trip-count-scaled launch count
# Per-(level axis, fabric) wire bytes: "<axis>/<fabric>" -> kind -> bytes,
# and the calls that booked them.  Populated when the Communicator
# decomposes against a Topology, so a dry-run can attribute traffic to
# the fabric that actually carries it.
_LEVEL_BYTES: dict = defaultdict(lambda: defaultdict(float))
_LEVEL_CALLS: dict = defaultdict(lambda: defaultdict(int))
_MULT: list = [1.0]
_HIDDEN_CTX: list = [False]
_FUSED_CTX: list = [False]
_CHOICES: list = []   # autotuner decisions, for benchmark audit
_FALLBACKS: list = []  # explicit flat-on-ragged degradation events
_TIMINGS: list = []   # measured wall-time samples (online re-tuning)
# Observers called once per timing sample (repro.obs flight recorder).
# Deliberately NOT cleared by reset(): hooks are a process-lifetime
# registration, while reset() runs at every re-trace boundary.
_TIMING_HOOKS: list = []


def reset() -> None:
    _BYTES.clear()
    _EXPOSED.clear()
    _HIDDEN.clear()
    _FUSED.clear()
    _COUNTS.clear()
    _CALLS.clear()
    _LEVEL_BYTES.clear()
    _LEVEL_CALLS.clear()
    _MULT[:] = [1.0]
    _HIDDEN_CTX[:] = [False]
    _FUSED_CTX[:] = [False]
    _CHOICES.clear()
    _FALLBACKS.clear()
    _TIMINGS.clear()


@contextlib.contextmanager
def scale(mult: float):
    """Everything recorded inside runs ``mult`` times at run time."""
    _MULT.append(_MULT[-1] * mult)
    try:
        yield
    finally:
        _MULT.pop()


@contextlib.contextmanager
def hidden(flag: bool = True):
    """Collectives recorded inside are overlap-hidden behind compute."""
    _HIDDEN_CTX.append(flag)
    try:
        yield
    finally:
        _HIDDEN_CTX.pop()


def in_hidden_region() -> bool:
    return _HIDDEN_CTX[-1]


@contextlib.contextmanager
def fused(flag: bool = True):
    """Collectives recorded inside feed a fused collective+compute
    kernel (``kernels.fused_collectives``): their epilogue/prologue
    compute rides the transfer instead of a separate HBM round-trip.
    The bytes additionally book into the fused split (orthogonal to
    hidden/exposed) so dry-runs can report how much of the wire
    traffic fusion covered."""
    _FUSED_CTX.append(flag)
    try:
        yield
    finally:
        _FUSED_CTX.pop()


def in_fused_region() -> bool:
    return _FUSED_CTX[-1]


def record(kind: str, wire_bytes: float, *,
           hidden: "bool | None" = None, fused: "bool | None" = None,
           level: "str | None" = None,
           fabric: "str | None" = None) -> None:
    """``hidden=None`` defers to the ambient ``ledger.hidden()`` region;
    ``fused=None`` likewise defers to ``ledger.fused()``.
    ``level``/``fabric`` attribute the bytes to a topology level (the
    mesh axis name and the fabric kind that carries the traffic)."""
    h = _HIDDEN_CTX[-1] if hidden is None else hidden
    fz = _FUSED_CTX[-1] if fused is None else fused
    m = _MULT[-1]
    _BYTES[kind] += wire_bytes * m
    (_HIDDEN if h else _EXPOSED)[kind] += wire_bytes * m
    if fz:
        _FUSED[kind] += wire_bytes * m
    _COUNTS[kind] += 1
    _CALLS[kind] += m
    if level is not None:
        _LEVEL_BYTES[f"{level}/{fabric or '?'}"][kind] += wire_bytes * m
        _LEVEL_CALLS[f"{level}/{fabric or '?'}"][kind] += 1


def record_fallback(primitive: str, *, level: "str | None" = None,
                    fabric: "str | None" = None,
                    reason: str = "flat_on_ragged") -> None:
    """Audit one explicit degradation event: a primitive that ran a
    hierarchy-blind (flat single-axis) schedule on an axis that
    declares ragged groups.  ReduceScatter/AllReduce/AllGather/Gather
    have grouped schedules and never book one of these; the remaining
    primitives do, so a dry-run (or test) can assert exactly which
    calls degraded instead of discovering it from byte totals."""
    _FALLBACKS.append({"primitive": primitive, "level": level,
                       "fabric": fabric, "reason": reason,
                       "calls": float(_MULT[-1])})


def record_choice(primitive: str, msg_bytes: int, nranks: int,
                  backend: str, slicing_factor: int, mode: str,
                  overlap: bool = False, fused: bool = False,
                  level: "str | None" = None,
                  fabric: "str | None" = None,
                  predicted_time: float = 0.0,
                  baseline_time: float = 0.0,
                  plan_epoch: "int | None" = None) -> None:
    """Audit trail of ``backend='auto'`` decisions (trace time, like
    ``record``): which concrete (backend, knobs) each collective got,
    which topology level it ran at, and the cost model's predicted /
    best-fixed-knob times for the cell (what the plan-aware dry-run
    turns into per-level step-time deltas).  ``plan_epoch`` is the
    version of the active-plan registry the decision was resolved
    against (None for an explicitly attached plan), so hot-swap runs
    can tell which plan generation drove each call."""
    _CHOICES.append({"primitive": primitive, "msg_bytes": int(msg_bytes),
                     "nranks": int(nranks), "backend": backend,
                     "slicing_factor": int(slicing_factor),
                     "allreduce_mode": mode, "overlap": bool(overlap),
                     "fused": bool(fused),
                     "level": level, "fabric": fabric,
                     "predicted_time": float(predicted_time),
                     "baseline_time": float(baseline_time),
                     "plan_epoch": plan_epoch,
                     "calls": float(_MULT[-1])})


# -- measured wall-time capture (online re-tuning) -------------------------

def add_timing_hook(hook) -> None:
    """Register ``hook(sample_dict)`` to observe every timing sample as
    it is recorded (the ``repro.obs`` flight recorder attaches here).
    Hooks survive ``reset()``; detach with ``remove_timing_hook``."""
    if hook not in _TIMING_HOOKS:
        _TIMING_HOOKS.append(hook)


def remove_timing_hook(hook) -> None:
    if hook in _TIMING_HOOKS:
        _TIMING_HOOKS.remove(hook)


def record_timing(primitive: str, msg_bytes: int, nranks: int,
                  backend: str, seconds: float, *,
                  slicing_factor: "int | None" = None,
                  allreduce_mode: "str | None" = None,
                  level: "str | None" = None,
                  fabric: "str | None" = None,
                  calls: "float | None" = None) -> None:
    """Book one measured wall-time sample for a dispatched collective,
    tagged with everything ``tuner.online`` needs to aggregate it into
    a plan cell: the cell identity (primitive, size, nranks, level) and
    the candidate actually executed (backend + knobs).  Knobs the
    caller does not know stay ``None`` (aggregated under an explicit
    ``?`` key, never pooled into a real candidate's mean).  ``calls``
    defaults to the ambient ``scale()`` multiplier, so a sample from a
    scanned region carries its true per-step trip count."""
    t = {"primitive": primitive, "msg_bytes": int(msg_bytes),
         "nranks": int(nranks), "backend": backend,
         "slicing_factor": (None if slicing_factor is None
                            else int(slicing_factor)),
         "allreduce_mode": allreduce_mode,
         "level": level, "fabric": fabric,
         "seconds": float(seconds),
         "calls": float(_MULT[-1] if calls is None else calls)}
    _TIMINGS.append(t)
    for hook in _TIMING_HOOKS:
        hook(t)


@contextlib.contextmanager
def timed(primitive: str, msg_bytes: int, nranks: int, backend: str, *,
          slicing_factor: "int | None" = None,
          allreduce_mode: "str | None" = None,
          level: "str | None" = None, fabric: "str | None" = None):
    """Time an eagerly executed region and book it as one sample.  The
    caller is responsible for making the region synchronous (e.g.
    ``torch.cuda.synchronize()`` after the collective) - the ledger
    only measures wall time between entry and exit."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record_timing(primitive, msg_bytes, nranks, backend,
                      time.perf_counter() - t0,
                      slicing_factor=slicing_factor,
                      allreduce_mode=allreduce_mode,
                      level=level, fabric=fabric)


def clear_timings() -> None:
    """Drop the measured timing samples only (trace-time state stays).
    Long-running loops call this after folding a step's samples into
    the tuner/metrics so the sample list stays O(one step)."""
    _TIMINGS.clear()


def timing_cells() -> dict:
    """Diagnostic aggregation of the timing samples, keyed per
    (plan cell, executed candidate): ``"<primitive>/b<log2 bucket>/
    n<nranks>[/<level>]@<backend>:<factor>:<allreduce mode>"``
    -> sample count + total/mean seconds.  The candidate key carries
    the full knob tuple so two modes of the same backend never pool
    into one mean; knobs the sample does not carry key as a literal
    ``?`` (an unknown-knob sample must never contaminate a tuned
    candidate's mean).  This is a snapshot *readout* (dry-runs,
    debugging); ``tuner.online`` consumes the raw
    ``snapshot()["timings"]`` list, which keeps per-sample order for
    the EWMA."""
    cells: dict = {}
    for t in _TIMINGS:
        bucket = max(1, int(t["msg_bytes"])).bit_length() - 1
        key = f"{t['primitive']}/b{bucket}/n{t['nranks']}"
        if t.get("level") is not None:
            key += f"/{t['level']}"
        sf = t.get("slicing_factor")
        mode = t.get("allreduce_mode")
        key += f"@{t['backend']}:{'?' if sf is None else sf}" \
               f":{'?' if mode is None else mode}"
        c = cells.setdefault(key, {"samples": 0, "seconds_total": 0.0,
                                   "backend": t["backend"]})
        c["samples"] += 1
        c["seconds_total"] += t["seconds"]
        c["mean_seconds"] = c["seconds_total"] / c["samples"]
    return cells


def snapshot() -> dict:
    return {"wire_bytes": dict(_BYTES), "counts": dict(_COUNTS),
            "total_wire_bytes": float(sum(_BYTES.values())),
            "exposed_bytes": dict(_EXPOSED),
            "hidden_bytes": dict(_HIDDEN),
            "fused_bytes": dict(_FUSED),
            "total_exposed_bytes": float(sum(_EXPOSED.values())),
            "total_hidden_bytes": float(sum(_HIDDEN.values())),
            "total_fused_bytes": float(sum(_FUSED.values())),
            "collective_calls": dict(_CALLS),
            "total_collective_calls": float(sum(_CALLS.values())),
            "level_wire_bytes": {k: dict(v)
                                 for k, v in _LEVEL_BYTES.items()},
            "level_counts": {k: dict(v) for k, v in _LEVEL_CALLS.items()},
            "auto_choices": list(_CHOICES),
            "fallbacks": list(_FALLBACKS),
            "timings": list(_TIMINGS),
            "timing_cells": timing_cells()}


def nbytes(x) -> int:
    size = 1
    for d in x.shape:
        size *= int(d)
    return size * x.dtype.itemsize
